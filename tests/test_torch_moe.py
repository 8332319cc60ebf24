"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on the CPU.

One MoE layer of phi3.5-moe (top-2) and of llama4-maverick (top-1 with
a shared expert) at ``reduced()`` size (d_model 64, 4 experts, d_ff 64)
in f32, the reference's parameters (``materialize`` of
``abstract_moe``) carried over, inputs from a numpy seed.  Each runs at
the config's capacity factor and at 0.5, where choices are dropped.
Held:

  * routing exactly: the expert indices, the slots and ``keep`` equal
    the reference's routing lines (``repro/models/moe.py:108-122``,
    evaluated in jnp), the smallest margin between the k-th and
    (k+1)-th router probability printed and asserted above 1e-4, so
    that f32 rounding cannot flip a choice;
  * y within 1e-5 (1 + max|y|) and aux within 1e-5 relative;
  * the gradients of sum(y^2) + aux for x and every leaf (``shared``
    included) within 1e-4 (1 + max|g|);
  * decode: the step's B tokens as one group (N = B), as the model's
    ``decode_step`` routes them;
  * one bf16 layer within 1e-2 (1 + max|y|);
  * ``capacity`` exactly over a grid of token counts and configs;
  * the gathers' backward bitwise equal to advanced indexing's, and
    the init's shapes, dtypes and distribution.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.layers import materialize
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.convert import to_tensor
from torch_threads import one_thread  # noqa: F401 (one thread)

ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"]
# (capacity factor, label): the config's own, and one that drops
CAPS = [(None, "cap_default"), (0.5, "cap_drops")]
D = 64


def _with_cap(cfg, cf, dtype):
    cfg = dataclasses.replace(cfg.reduced(), dtype=dtype)
    if cf is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _cfgs(name, cf=None, dtype="float32"):
    return (_with_cap(jget_config(name), cf, dtype),
            _with_cap(get_config(name), cf, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _tol(x, rel) -> float:
    return rel * (1.0 + float(np.abs(_np(x)).max()))


def _close(got, want, rel):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_tol(want, rel))


@functools.lru_cache(maxsize=None)
def _params(name, dtype="float32"):
    """One MoE layer's parameters: (JAX tree, port tree)."""
    jc, _ = _cfgs(name, dtype=dtype)
    jp = materialize(jmoe.abstract_moe(jc), jax.random.PRNGKey(1))
    return jp, jax.tree.map(lambda a: to_tensor(np.asarray(a)), jp)


def _inputs(B, S, seed=0):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


def _jax_routing(jp, xt, jc):
    """The reference's routing (``repro/models/moe.py:108-122``):
    (probs, expert_idx, slot, keep)."""
    m = jc.moe
    N, E, K = xt.shape[0], m.num_experts, m.top_k
    logits = jnp.einsum("nd,de->ne", xt.astype(jnp.float32),
                        jp["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(expert_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(N * K, E)
    slot = jnp.cumsum(flat, axis=0) - flat
    slot = (slot * flat).sum(axis=-1).reshape(N, K)
    return probs, expert_idx, slot, slot < jmoe.capacity(jc, N)


@pytest.mark.parametrize("cf,label", CAPS, ids=[c[1] for c in CAPS])
@pytest.mark.parametrize("name", ARCHS)
def test_routing_is_exact(name, cf, label):
    jc, tc = _cfgs(name, cf)
    jp, tp = _params(name)
    xt = _inputs(3, 32).reshape(-1, D)
    probs, idx, slot, keep = _jax_routing(jp, jnp.asarray(xt), jc)
    t_probs, t_idx, t_gates, t_slot, t_keep, C, _ = moe.routing(
        tp, torch.from_numpy(xt), tc)
    K = tc.moe.top_k
    srt = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    margin = float((srt[:, K - 1] - srt[:, K]).min())
    print(f"{name} {label}: smallest top-{K} router margin {margin:.3e}; "
          f"C = {C}, dropped {int((~t_keep).sum())} of {t_keep.numel()}")
    assert margin > 1e-4
    assert C == jmoe.capacity(jc, xt.shape[0])
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(t_keep.numpy(), np.asarray(keep))
    assert bool((~t_keep).any()) == (cf is not None)
    assert bool((t_gates[~t_keep] == 0).all())
    _close(t_probs, probs, 1e-5)


@pytest.mark.parametrize("cf,label", CAPS, ids=[c[1] for c in CAPS])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_and_gradients_match_reference(name, cf, label):
    jc, tc = _cfgs(name, cf)
    jp, tp = _params(name)
    x = _inputs(3, 32, seed=1)

    def jloss(p, x):
        y, aux = jmoe.moe(p, x, jc)
        return (y ** 2).sum() + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tleaves = [t.clone().requires_grad_() for t in jax.tree.leaves(tp)]
    tpr = jax.tree.unflatten(jax.tree.structure(jp), tleaves)
    xt = torch.from_numpy(x).requires_grad_()
    ty, taux = moe.moe(tpr, xt, tc)
    _close(ty, jy, 1e-5)
    assert abs(float(taux.detach()) - float(jaux)) <= 1e-5 * abs(float(jaux))
    grads = torch.autograd.grad((ty ** 2).sum() + taux, [xt] + tleaves)
    _close(grads[0], jgx, 1e-4)
    assert len(grads) - 1 == len(jax.tree.leaves(jgp)) == \
        (7 if tc.moe.shared_expert else 4)
    for got, want in zip(grads[1:], jax.tree.leaves(jgp)):
        _close(got, want, 1e-4)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_routes_the_step_as_one_group(name):
    """(B, 1, D) at the decode step: N = B tokens, C = 8."""
    jc, tc = _cfgs(name)
    jp, tp = _params(name)
    x = _inputs(5, 1, seed=2)
    jy, jaux = jmoe.moe(jp, jnp.asarray(x), jc)
    ty, taux = moe.moe(tp, torch.from_numpy(x), tc)
    assert moe.capacity(tc, 5) == 8
    _close(ty, jy, 1e-5)
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_layer_matches_reference(name):
    """One bf16 MoE layer within 1e-2 (1 + max|y|): the expert products
    round to bf16 in both, in other orders."""
    jc, tc = _cfgs(name, dtype="bfloat16")
    jp, tp = _params(name, "bfloat16")
    x = _inputs(2, 24, seed=3)
    jy, jaux = jmoe.moe(jp, jnp.asarray(x, jnp.bfloat16), jc)
    ty, taux = moe.moe(tp, torch.from_numpy(x).to(torch.bfloat16), tc)
    assert ty.dtype == torch.bfloat16 and taux.dtype == torch.float32
    _close(ty, jy, 1e-2)
    assert abs(float(taux) - float(jaux)) <= 1e-2 * abs(float(jaux))


def test_capacity_matches_reference_over_a_grid():
    names = ARCHS + ["jamba-v0.1-52b"]
    for name in names:
        for full in (True, False):
            jc, tc = jget_config(name), get_config(name)
            if not full:
                jc, tc = jc.reduced(), tc.reduced()
            for cf in (None, 0.5, 1.0, 2.0, 0.01):
                if cf is not None:
                    jc = dataclasses.replace(jc, moe=dataclasses.replace(
                        jc.moe, capacity_factor=cf))
                    tc = dataclasses.replace(tc, moe=dataclasses.replace(
                        tc.moe, capacity_factor=cf))
                for n in (1, 4, 7, 64, 100, 255, 4096, 16384, 65536):
                    assert moe.capacity(tc, n) == jmoe.capacity(jc, n), \
                        (name, full, cf, n)
    # the serving cell's prefill: B = 4 x 4096 tokens of phi3.5-moe
    assert moe.capacity(get_config(ARCHS[0]), 4 * 4096) == 2560


def test_gather_backward_equals_advanced_indexing():
    """The dispatch's and the combine's gradients through ``_Gather``
    equal those through plain advanced indexing (whose backward
    accumulates with index_put), bitwise, top-2 with drops."""
    _, tc = _cfgs(ARCHS[0], 0.5)
    _, tp = _params(ARCHS[0])
    x = torch.from_numpy(_inputs(3, 32, seed=4)).reshape(-1, D)
    _, idx, _, slot, keep, C, _ = moe.routing(tp, x, tc)
    N, K, E = x.shape[0], tc.moe.top_k, tc.moe.num_experts
    dest = torch.where(keep, idx * C + slot, E * C).reshape(-1)
    src = torch.full((E * C + 1,), N * K).scatter_(
        0, dest, torch.arange(N * K))[:E * C]
    rows = torch.where(src < N * K, src // K, N)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(E * C, D)).astype(np.float32))
    a = x.clone().requires_grad_()
    (moe._Gather.apply(a, rows, dest.reshape(N, K)) * g).sum().backward()
    b = x.clone().requires_grad_()
    pad = torch.cat([b, b.new_zeros(1, D)])
    (pad[rows] * g).sum().backward()
    assert bool((~keep).any()) and torch.equal(a.grad, b.grad)
    ye = torch.from_numpy(_inputs(1, E * C, seed=6)[0]).requires_grad_()
    h = torch.from_numpy(np.random.default_rng(7).normal(
        size=(N * K, D)).astype(np.float32))
    (moe._Gather.apply(ye, dest, src[:, None]) * h).sum().backward()
    ye2 = ye.detach().clone().requires_grad_()
    (torch.cat([ye2, ye2.new_zeros(1, D)])[dest] * h).sum().backward()
    assert torch.equal(ye.grad, ye2.grad)


def test_init_moe_leaves_and_distribution():
    cfg = dataclasses.replace(get_config(ARCHS[1]).reduced(), dtype="float32",
                              moe=dataclasses.replace(
                                  get_config(ARCHS[1]).reduced().moe,
                                  num_experts=8, d_ff=256))
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jmoe.abstract_moe(dataclasses.replace(
        jget_config(ARCHS[1]).reduced(), dtype="float32",
        moe=dataclasses.replace(jget_config(ARCHS[1]).reduced().moe,
                                num_experts=8, d_ff=256)))
    jl = jax.tree_util.tree_flatten_with_path(
        jp, is_leaf=lambda a: hasattr(a, "logical"))[0]
    from repro_torch.core import tree
    tl = tree.leaves_with_paths(p)
    assert [path for path, _ in tl] == [
        "/".join(k.key for k in path) for path, _ in jl]
    for (_, t), (_, a) in zip(tl, jl):
        assert tuple(t.shape) == tuple(a.shape) and t.dtype == torch.float32
        # truncated normal on [-2, 2] (std 0.880) times 1/sqrt(shape[-2])
        sigma = 1.0 / np.sqrt(a.shape[-2])
        assert float(t.abs().max()) <= 2 * sigma * (1 + 1e-6)
        assert abs(float(t.std()) / (0.880 * sigma) - 1.0) < 0.05
