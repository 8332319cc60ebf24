"""The detection codes, ``vote_tree`` and ``filter_tree`` against the JAX
package, on the CPU (modelled on ``tests/test_detection_codes.py``).

Seeded numpy inputs go through ``repro.core`` and ``repro_torch.core``:
the codes' checks and the vote's control quantities (faulty mask,
majority flag) exact, the vote's values bitwise (a vote picks a
replica), the codes' estimates and the filters within 1e-5 relative
(another summation order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import codes as jcodes
from repro.core import draco as jdraco
from repro.core import filters as jfilters
from repro.core import identification as jident
from repro_torch import core as tcore
from repro_torch.core import codes, draco, filters, identification
from repro_torch.core import tree
from torch_threads import one_thread  # noqa: F401 (one thread)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_exported_where_the_reference_exports_them():
    assert tcore.codes is codes and tcore.filters is filters
    assert draco.vote_tree is identification.vote_tree
    assert jdraco.vote_tree is jident.vote_tree


@pytest.mark.parametrize("delta", [0.0, 1e-7, 1e-2])
def test_replication_code_matches_reference(delta):
    rng = np.random.default_rng(0)
    sym = np.repeat(rng.standard_normal((1, 50)).astype(np.float32), 3, 0)
    sym[1, 3] += delta
    jc, tc = jcodes.ReplicationCode(f=2), codes.ReplicationCode(f=2)
    assert tc.replication == jc.replication == 3
    assert bool(tc.check(_t(sym))) == bool(jc.check(jnp.asarray(sym)))
    assert bool(tc.check(_t(sym))) == (delta < 1e-5)
    shards = rng.standard_normal((4, 50)).astype(np.float32)
    np.testing.assert_allclose(tc.encode(_t(shards)).numpy(),
                               np.asarray(jc.encode(jnp.asarray(shards))),
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(tc.decode(_t(sym)), _t(sym[0]))


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("tamper", [False, True])
def test_fig2_code_detects_any_single_fault(which, tamper):
    rng = np.random.default_rng(3 + which)
    g = rng.standard_normal((3, 40)).astype(np.float32)
    jc = [jcodes.Fig2Code.encode(w, jnp.asarray(g[a]), jnp.asarray(g[b]))
          for w, (a, b) in enumerate(jcodes.Fig2Code.shards)]
    tc = [codes.Fig2Code.encode(w, _t(g[a]), _t(g[b]))
          for w, (a, b) in enumerate(codes.Fig2Code.shards)]
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    if tamper:
        jc[which] = jc[which] + 0.1
        tc[which] = tc[which] + 0.1
    ok = bool(codes.Fig2Code.check(*tc))
    assert ok == bool(jcodes.Fig2Code.check(*jc)) == (not tamper)
    if not tamper:
        np.testing.assert_allclose(codes.Fig2Code.decode(*tc).numpy(),
                                   g.sum(0), rtol=1e-5, atol=1e-5)
        for e in codes.Fig2Code.estimates(*tc):
            np.testing.assert_allclose(e.numpy(), g.sum(0), rtol=1e-5,
                                       atol=1e-5)
    fw = codes.Fig2Code.reactive_symbols(tc)
    assert [[id(x) for x in u] for u in fw] == [
        [id(tc[1]), id(tc[2])], [id(tc[2]), id(tc[0])],
        [id(tc[0]), id(tc[1])]]
    with pytest.raises(ValueError):
        codes.Fig2Code.encode(3, _t(g[0]), _t(g[1]))


def _replica_tree(seed, r, bad, same_leaf=False):
    """A two-leaf gradient tree stacked over r replicas (leading dim).
    The replicas in ``bad`` are tampered in alternate leaves, or all in
    leaf "w", each by another factor, with ``same_leaf``."""
    rng = np.random.default_rng(seed)
    t = {"b": np.repeat(rng.standard_normal((1, 7)).astype(np.float32), r,
                        0),
         "w": {"k": np.repeat(rng.standard_normal((1, 3, 5)).astype(
             np.float32), r, 0)}}
    for i, w in enumerate(bad):
        if i % 2 and not same_leaf:
            t["b"][w, rng.integers(7)] += 1.0
        else:
            t["w"]["k"][w] *= -1.0 - i
    return t


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("r,bad,same_leaf", [
    (3, (), False), (3, (1,), False), (5, (0, 3), False),
    (5, (2, 4), True), (3, (0, 1), False), (3, (0, 2), True)])
def test_vote_tree_matches_reference(seed, r, bad, same_leaf):
    """Each leaf voted alone, the faulty mask their union: two replicas
    of three tampered in different leaves are both found; in the same
    leaf, that leaf has no majority."""
    t = _replica_tree(seed, r, bad, same_leaf)
    jv, jf, jok = jident.vote_tree(jax.tree.map(jnp.asarray, t))
    tv, tf, tok = draco.vote_tree(jax.tree.map(_t, t))
    assert tf.tolist() == np.asarray(jf).tolist()
    majority = not (same_leaf and 2 * len(bad) >= r)
    assert bool(tok) == bool(jok) == majority
    for a, b in zip(tree.leaves(tv), jax.tree.leaves(jv)):
        assert a.shape == b.shape and np.array_equal(a.numpy(),
                                                     np.asarray(b))
    if majority:
        assert np.flatnonzero(tf.numpy()).tolist() == sorted(bad)


@pytest.mark.parametrize("name", sorted(jfilters.FILTERS))
def test_filter_tree_matches_reference(name):
    assert set(filters.FILTERS) == set(jfilters.FILTERS)
    rng = np.random.default_rng(11)
    n, f = 7, 2
    t = {"a": rng.standard_normal((n, 4, 6)).astype(np.float32),
         "z": rng.standard_normal((n, 9)).astype(np.float32)}
    t["a"][[1, 4]] *= -10.0
    j = jfilters.filter_tree(jax.tree.map(jnp.asarray, t), name, f)
    g = filters.filter_tree(jax.tree.map(_t, t), name, f)
    for a, b in zip(tree.leaves(g), jax.tree.leaves(j)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * (1 + np.abs(b).max()))


def test_filter_tree_keeps_each_leafs_dtype():
    rng = np.random.default_rng(12)
    t = {"h": torch.from_numpy(rng.standard_normal((5, 8)).astype(
        np.float32)).to(torch.bfloat16)}
    out = filters.filter_tree(t, "median", 1)
    assert out["h"].dtype == torch.bfloat16 and out["h"].shape == (8,)
    want = jfilters.filter_tree(
        {"h": jnp.asarray(t["h"].float().numpy(), jnp.bfloat16)}, "median", 1)
    np.testing.assert_array_equal(out["h"].float().numpy(),
                                  np.asarray(want["h"], np.float32))
