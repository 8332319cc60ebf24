"""The pieces of ``long_500k``'s decode on a rank of a (``pod``,)
``data``, ``model`` mesh, on the CPU: a batch that the batch axes do not
divide (``train.ranks.StepMesh.for_batch``, the reference's ``spec_for``
divisibility fallback), the cache write of a rank's block of positions
(``attention.update_cache``'s ``first``), and the decode attention
combined over ``data`` (``attention.decode_attention``'s ``seq``) as
gloo ranks, against the one-process decode attention, with
``chip_smoke.left_out_block``'s planted combine.  The whole decode
against the JAX package's is in ``tests/test_torch_fsdp.py``
(``test_long_decode_matches_reference``).
"""
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from test_torch_trainer import rank_server  # noqa: F401 (its teardown)
from torch_threads import one_thread  # noqa: F401 (one thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def fake_mesh():
    """Rank 0 of a (pod 2, data 2, model 2) step mesh under torch's
    ``fake`` process group (the dry-run's)."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun as D
    from repro_torch.sharding import MeshShape

    mesh = D._fake_step_mesh(MeshShape(("pod", "data", "model"), (2, 2, 2)))
    yield mesh
    dist.destroy_process_group()


def test_for_batch_follows_the_references_spec_for(fake_mesh):
    """A batch the batch axes divide splits over both (``pod`` then
    ``data``); one only ``pod`` divides splits over ``pod``; a batch of 1
    is replicated, its view's ``local_rows`` giving every row,
    ``batch_rows`` the global batch, ``batch_mesh`` none; the mesh itself
    splits over both and refuses the rows of a batch that splits
    otherwise, and a train step refuses a view that does not split over
    both."""
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.optim import OptConfig
    from repro_torch.train import pjit_step

    m = fake_mesh
    assert m.batch_axes == ("pod", "data") and m.batch_parts == 4
    assert m.batch_split(8) == ("pod", "data")
    assert m.batch_split(2) == ("pod",) and m.batch_split(1) == ()
    one = m.for_batch(1)
    assert (one.batch_axes, one.batch_parts, one.batch_index) == ((), 1, 0)
    x = torch.arange(6).reshape(6, 1)
    assert torch.equal(one.local_rows(x[:1]), x[:1])
    assert torch.equal(m.for_batch(2).local_rows(x[:2]), x[:1])  # pod 0's
    assert torch.equal(m.local_rows(torch.arange(8)), torch.arange(2))
    with pytest.raises(ValueError, match="for_batch"):
        m.local_rows(x[:1])
    with sharding.set_mesh(one):
        assert sharding.batch_rows(1) == 1
        assert sharding.batch_mesh() is None
    with sharding.set_mesh(m):
        assert sharding.batch_rows(2) == 8
        assert sharding.batch_mesh() is m
    assert m.batch_whole and not one.batch_whole
    with pytest.raises(ValueError, match="every batch axis"):
        pjit_step.make_train_step(get_config("llama3.2-1b").reduced(),
                                  OptConfig(), mesh=one)


@pytest.mark.parametrize("first", [0, 16, 32])
@pytest.mark.parametrize("pos", [14, 15, 16, 31, 32])
def test_update_cache_writes_only_its_block(pos, first):
    """A block of 16 positions from ``first``: two new rows at ``pos``
    land where the whole cache would hold them, and nowhere else;
    ``first=None`` is the whole cache's write."""
    from repro_torch.models.attention import update_cache

    whole_k, whole_v = torch.zeros(1, 48, 4), torch.zeros(1, 48, 4)
    k_new, v_new = torch.randn(1, 2, 4), torch.randn(1, 2, 4)
    update_cache(whole_k, whole_v, k_new, v_new, pos)
    bk, bv = torch.zeros(1, 16, 4), torch.zeros(1, 16, 4)
    update_cache(bk, bv, k_new, v_new, pos, first)
    assert torch.equal(bk, whole_k[:, first:first + 16])
    assert torch.equal(bv, whole_v[:, first:first + 16])


# (valid_len, window): the new token on a block's first and last row,
# windows that straddle blocks, and ones that leave whole ranks out
ATTN_CASES = [(33, None), (32, None), (50, 8), (50, 20), (64, 40),
              (17, 16), (1, None)]
S, DATA = 64, 4


def _attn_inputs():
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 1, 4, 8, generator=g)
    k = torch.randn(2, S, 2, 8, generator=g).to(torch.bfloat16)
    v = torch.randn(2, S, 2, 8, generator=g).to(torch.bfloat16)
    return q, k, v


def _attn_rank(rank, world, port, out, plant):
    """One gloo rank on ``data``: its block of the cache, every case's
    ``decode_attention`` combined over the axis (under ``plant``, with
    ``chip_smoke.left_out_block``)."""
    import contextlib

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_step_mesh
    from repro_torch.models import attention as A
    from repro_torch.train import ranks as R

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    torch.set_num_threads(1)
    R.init("gloo", rank, world, init_method=f"tcp://localhost:{port}",
           timeout_s=60)
    mesh = R.StepMesh(make_step_mesh(world, device_type="cpu"), "cpu")
    ax = mesh.axes["data"]
    q, k, v = _attn_inputs()
    n = S // world
    first = mesh.coords["data"] * n
    outs = []
    with chip_smoke.left_out_block(True) if plant else \
            contextlib.nullcontext():
        for valid_len, window in ATTN_CASES:
            outs.append(A.decode_attention(
                q, k[:, first:first + n], v[:, first:first + n],
                valid_len=valid_len, window=window, seq=(ax, first)))
    torch.save(outs, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _attn_ranks(tmp_path, plant):
    from repro_torch.launch.train import free_port, start_ranks

    start_ranks(_attn_rank, (DATA, free_port(), str(tmp_path), plant), DATA)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(DATA)]


def test_split_decode_attention_is_the_whole_caches(tmp_path):
    """Four data ranks of 16 positions each: every case's output bitwise
    alike on every rank, finite (a rank that holds no visible key adds
    zero weight), within 1e-6 of the one-process ``decode_attention`` on
    the whole cache; the planted combine that leaves out the first
    rank's P.V partial in a global layer (no window) moves every such
    case, whose visible keys always include that block's, and no
    windowed one."""
    from repro_torch.models.attention import decode_attention

    q, k, v = _attn_inputs()
    whole = [decode_attention(q, k, v, valid_len=n, window=w)
             for n, w in ATTN_CASES]
    results = _attn_ranks(tmp_path, False)
    for r in results:
        assert all(torch.equal(a, b) for a, b in zip(r, results[0]))
    for got, want in zip(results[0], whole):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                   rtol=0)
    planted = _attn_ranks(tmp_path, True)[0]
    for (n, w), got, want in zip(ATTN_CASES, planted, whole):
        assert torch.isfinite(got).all()
        assert (w is None) != bool(torch.allclose(got, want, atol=1e-6,
                                                  rtol=0)), (n, w)
