"""The port's hand-written CUDA kernels and its engine on the card.

These tests need an NVIDIA GPU and skip without one (marker ``cuda``).
On a machine with a card, from the root of the checkout:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports nothing of JAX, so it runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.kernels import (coded_encode, flash_attention, fused_step,
                                  gram, majority_vote, ops, sketch)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    # hand the caching allocator's free blocks back to the card, so that
    # a later test's ranks sharing the card find its memory free
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _keys(T):
    return np.uint32(0x9E3779B9) * (np.arange(T, dtype=np.uint32) + 1)


@pytest.mark.parametrize("Ie,d,T,B", [(10, 70001, 5, 3), (3, 255, 2, 1),
                                      (66, 4096, 40, 2)])
def test_gram_kernel_matches_plain(cuda, Ie, d, T, B):
    rng = np.random.default_rng(Ie + d)
    rows = torch.from_numpy(rng.normal(size=(Ie, d)).astype(np.float32)).to(cuda)
    W0 = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(cuda)
    keys = _keys(T)
    before = ops.launch_counts()["gram_factors"]
    got = gram.gram_factors_cuda(rows, W0, keys)
    want = gram.gram_factors_plain(rows, W0, keys)
    assert ops.launch_counts()["gram_factors"] == before + 1
    for g, w in zip(got[:2], want[:2]):       # G, S0: f32 spans, f64 sum
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    torch.testing.assert_close(got[2], want[2], rtol=2e-5, atol=1e-3)


# (Ie, d, T, k): other k, one key, one row, d < k, a ragged edge in
# every dimension, more keys (128) and rows (72) than one block takes
GRAM_SK_SHAPES = [(5, 70001, 3, 96), (7, 30001, 130, 512), (66, 5000, 1, 256),
                  (1, 9000, 4, 256), (4, 100, 3, 256), (80, 3001, 2, 256),
                  (3, 1000, 2, 7), (2, 500, 3, 1)]


@pytest.mark.parametrize("Ie,d,T,k", GRAM_SK_SHAPES)
def test_gram_sketch_tables_ragged(cuda, Ie, d, T, k):
    """The tensor-core sketch tables against the plain einsum: bf16 signs
    times three exact bf16 pieces of R, so f32 tolerances hold."""
    rng = np.random.default_rng(Ie * d + k)
    rows = torch.from_numpy(rng.normal(size=(Ie, d)).astype(np.float32)
                            ).to(cuda)
    got = gram.gram_factors_cuda(rows, None, _keys(T), k, with_gram=False)[2]
    want = gram.gram_factors_plain(rows, None, _keys(T), k, with_gram=False)[2]
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-3)


def test_gram_sketch_tables_rerun_bitwise(cuda):
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(rng.normal(size=(66, 65536)).astype(np.float32)
                            ).to(cuda)
    runs = [gram.gram_factors_cuda(rows, None, _keys(120),
                                   with_gram=False)[2] for _ in range(2)]
    assert torch.equal(*runs)
    want = gram.gram_factors_plain(rows, None, _keys(120), with_gram=False)[2]
    torch.testing.assert_close(runs[0], want, rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("d", [1, 255, 257, 70001, 513024])
def test_sketch_single_matches_plain_and_reruns(cuda, d):
    g = _randn(cuda, d, seed=d)
    got = sketch.sketch_cuda(g, 0x9E3779B9)
    torch.testing.assert_close(got, sketch.sketch_plain(g, 0x9E3779B9),
                               rtol=2e-5, atol=1e-3)
    assert torch.equal(got, sketch.sketch_cuda(g, 0x9E3779B9))
    odd = _randn(cuda, d + 1, seed=d)[1:]          # not 16-byte aligned
    torch.testing.assert_close(sketch.sketch_cuda(odd, 5),
                               sketch.sketch_plain(odd, 5),
                               rtol=2e-5, atol=1e-3)


# (rows, cols, row width, column offset).  Rows whose 16-byte vectors
# line up with the buckets: a column shard at an offset, rows of one,
# two and four slabs of 256, a dim-0 shard of 2^28 elements (a split
# embedding's, one long row).  Misaligned starts: odd widths and
# offsets, a dim-0 shard at an odd offset, a block narrower than k, rows
# of 2-4 slabs from an odd column.
SHARD_BLOCKS = [(64, 4096, 8192, 4096), (4096, 256, 512, 256),
                (2048, 512, 1024, 512), (2048, 1024, 2048, 1024),
                (1, 1 << 28, 1 << 29, 1 << 28), (3, 1001, 4097, 3095),
                (1, 70001, 200000, 129999), (5, 100, 300, 7),
                (1500, 600, 1800, 1197)]


@pytest.mark.parametrize("rows,cols,cfull,c0", SHARD_BLOCKS)
@pytest.mark.parametrize("k", [256, 7, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sketch_shard_form_matches_plain_and_reruns(cuda, rows, cols, cfull,
                                                    c0, k, dtype):
    """K4s's shard form (a block of a leaf's (rows, cfull) view from
    column c0, hashed by the whole leaf's flat index), f32 and bf16 read
    in their own dtype, against its plain version on the block's f32
    cast (and, at 2^28 elements, whose f32 sums of a million terms a
    bucket stray by about 1e-5, against the same sums in f64) within
    1e-5 of max(1, max|plain|), one launch a call counted under its
    dtype, reruns bitwise."""
    from repro_torch.kernels import ref

    g = _randn(cuda, rows, cols, seed=cols).to(dtype)
    name = "sketch_shard" if dtype == torch.bfloat16 else "sketch_shard_f32"
    before = ops.launch_counts()
    got = sketch.sketch_block_cuda(g, 0x9E3779B9, k, cfull, c0)
    after = ops.launch_counts()
    assert after[name] == before[name] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    if rows * cols < 1 << 24:
        want = sketch.sketch_block_plain(g, 0x9E3779B9, k, cfull, c0)
    else:
        want = torch.zeros(k, dtype=torch.float64, device=cuda)
        for r in range(rows):
            p = r * cfull + c0 + torch.arange(cols, device=cuda)
            want.index_add_(0, p % k, g[r].double() * ref.hash_signs_ref(
                p, 0x9E3779B9).double())
            del p
    assert float((got.double() - want.double()).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))
    assert torch.equal(got, sketch.sketch_block_cuda(g, 0x9E3779B9, k,
                                                     cfull, c0))


def test_sketch_shard_bf16_is_its_f32_cast(cuda):
    """A bf16 block and its f32 cast sketch bitwise alike: the kernel
    widens each value exactly and adds in the same order."""
    for rows, cols, cfull, c0 in SHARD_BLOCKS[:4] + SHARD_BLOCKS[5:]:
        g = _randn(cuda, rows, cols, seed=rows).to(torch.bfloat16)
        assert torch.equal(sketch.sketch_block_cuda(g, 3, 256, cfull, c0),
                           sketch.sketch_block_cuda(g.float(), 3, 256, cfull,
                                                    c0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [0, 1])
def test_sketch_shards_sum_to_the_single_form(cuda, dtype, dim):
    """Two shards of a (7, 3000) leaf, split on either dim: their shard
    form sketches add up to the single form's sketch of the whole flat
    leaf (of its f32 cast)."""
    full = _randn(cuda, 7, 3000, seed=3).to(dtype)
    whole = sketch.sketch_cuda(full.float().reshape(-1), 21)
    if dim == 1:                     # (7, 1500) blocks of (7, 3000)
        shards = [(full[:, m * 1500:(m + 1) * 1500], 3000, m * 1500)
                  for m in range(2)]
    else:                            # rows 0-3 and 4-6: one row each
        shards = [(full[:4].reshape(1, -1), 21000, 0),
                  (full[4:].reshape(1, -1), 21000, 12000)]
    parts = sum(sketch.sketch_block_cuda(b.contiguous(), 21, 256, cfull, c0)
                for b, cfull, c0 in shards)
    torch.testing.assert_close(parts, whole, rtol=1e-5, atol=1e-4)


def test_sketch_single_on_two_streams(cuda):
    """Calls alternating between two streams, each stream's calls queued
    back to back: each stream has its own ticket and partials."""
    xs = [_randn(cuda, 513024, seed=s) for s in range(6)]
    want = [sketch.sketch_plain(x, 11) for x in xs]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    got = []
    for i, x in enumerate(xs):
        with torch.cuda.stream(streams[i % 2]):
            got.append(sketch.sketch_cuda(x, 11))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("shape", [(32, 8, 256), (32, 5, 65536), (7, 3, 70001)])
def test_relmax_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    x[:, 1] = x[:, 0]
    got = majority_vote.pairwise_relmax_batched_cuda(x)
    want = majority_vote.pairwise_relmax_batched_plain(x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert bool((got[:, 0, 1] == 0).all())


def _randn(dev, *shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _tile_rel_err(got, want, rows=64):
    """The largest ||got - want|| / ||want|| over blocks of ``rows``
    query rows of (B, S, H, hd) outputs: a limit scaled to the data."""
    d, w = got.float() - want.float(), want.float()
    worst = 0.0
    for r0 in range(0, got.shape[1], rows):
        den = float(w[:, r0:r0 + rows].norm())
        num = float(d[:, r0:r0 + rows].norm())
        worst = max(worst, num / den if den > 0 else num)
    return worst


# (B, Ie, d): ragged d (not a multiple of k or of the 64-column tile),
# Ie not a multiple of 8 or of the 72-row block, B = 1, B past one
# 64-trial block, the fused_sweep chunk width, the default problem's
# Ie = 258 (four row blocks), two row blocks with B past one block, and
# many spans of many tiles each (more tiles than the ring has stages)
FUSED_SHAPES = [(1, 3, 300), (3, 10, 70001), (70, 13, 1000),
                (64, 66, 4096), (5, 258, 2000), (66, 73, 9001),
                (64, 66, 270000), (2, 145, 5000)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,Ie,d", FUSED_SHAPES)
def test_fused_step_kernel_matches_plain(cuda, dtype, B, Ie, d):
    rows = _randn(cuda, Ie, d, seed=B + Ie + d)
    if dtype == "bf16":
        rows = rows.to(torch.bfloat16)
    W = _randn(cuda, B, d, seed=1)
    cw = _randn(cuda, B, Ie, seed=2) * 0.1
    cw[0] = 0.0                               # a dead trial's zero row
    W_in = W.clone()
    want = fused_step.fused_step_plain(rows, W_in, cw, 1234)
    before = ops.launch_counts()["fused_step"]
    got = fused_step.fused_step_cuda(rows, W, cw, 1234)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_step"] == before + 1
    assert got[0].data_ptr() == W.data_ptr()  # W' is written over W
    assert torch.equal(got[0][0], W_in[0])   # zero row: W bitwise kept
    assert _rel_err(got[0], want[0]) <= 1e-5
    assert _rel_err(got[1], want[1]) <= 1e-5
    torch.testing.assert_close(got[2], want[2], rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("k", [32, 96])
def test_fused_step_kernel_takes_k_multiple_of_32(cuda, k):
    """Sketch widths that are not a multiple of the 64-column tile."""
    rows = _randn(cuda, 11, 3001, seed=k)
    W = _randn(cuda, 3, 3001, seed=1)
    cw = _randn(cuda, 3, 11, seed=2) * 0.1
    want = fused_step.fused_step_plain(rows, W.clone(), cw, 99, k)
    got = fused_step.fused_step_cuda(rows, W, cw, 99, k)
    assert _rel_err(got[0], want[0]) <= 1e-5
    assert _rel_err(got[1], want[1]) <= 1e-5
    torch.testing.assert_close(got[2], want[2], rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,Ie,d", [(64, 66, 65536), (5, 258, 2000)])
def test_fused_step_kernel_reruns_bitwise(cuda, dtype, B, Ie, d):
    rows = _randn(cuda, Ie, d, seed=4)
    if dtype == "bf16":
        rows = rows.to(torch.bfloat16)
    W = _randn(cuda, B, d, seed=5)
    cw = _randn(cuda, B, Ie, seed=6) * 0.1
    outs = [fused_step.fused_step_cuda(rows, W.clone(), cw, 77)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,d", [(66, 70001), (1, 255), (9, 4096),
                                 (258, 3000)])
def test_sketch_kernel_matches_plain(cuda, B, d):
    g = _randn(cuda, B, d, seed=B + d)
    got = sketch.sketch_batched_cuda(g, 0x9E3779B9)
    want = sketch.sketch_batched_plain(g, 0x9E3779B9)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-3)
    one = sketch.sketch_cuda(g[-1], 77)
    torch.testing.assert_close(one, sketch.sketch_plain(g[-1], 77),
                               rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("B,n_sym,m,d", [(8, 1, 64, 70001), (1, 3, 5, 255),
                                         (2, 9, 7, 1000)])
def test_encode_kernel_matches_plain(cuda, B, n_sym, m, d):
    c = _randn(cuda, B, n_sym, m, seed=m)
    g = _randn(cuda, B, m, d, seed=d)
    got = coded_encode.coded_encode_batched_cuda(c, g)
    want = coded_encode.coded_encode_batched_plain(c, g)
    assert _rel_err(got, want) <= 1e-5
    one = coded_encode.coded_encode_cuda(c[0], g[0])
    assert _rel_err(one, coded_encode.coded_encode_plain(c[0], g[0])) <= 1e-5


# (form, call on an empty input): each returns without launching its
# kernel, so its launch count must not move
EMPTY_CALLS = {
    "sketch_batched": lambda z: sketch.sketch_batched_cuda(z(0, 300), 5),
    "coded_encode_batched/B": lambda z: coded_encode.coded_encode_batched_cuda(
        z(0, 1, 4), z(0, 4, 300)),
    "coded_encode_batched/d": lambda z: coded_encode.coded_encode_batched_cuda(
        z(2, 1, 4), z(2, 4, 0)),
    "coded_encode/n_sym": lambda z: coded_encode.coded_encode_cuda(
        z(0, 4), z(4, 300)),
    "pairwise_relmax_batched/B": lambda z:
        majority_vote.pairwise_relmax_batched_cuda(z(0, 3, 300)),
    "pairwise_relmax_batched/d": lambda z:
        majority_vote.pairwise_relmax_batched_cuda(z(2, 3, 0)),
    "pairwise_relmax/R": lambda z: majority_vote.pairwise_relmax_cuda(z(0, 300)),
    "fused_step/Ie": lambda z: fused_step.fused_step_cuda(
        z(0, 300), z(2, 300), z(2, 0), 5),
    "flash_attention/B": lambda z: flash_attention.flash_attention_cuda(
        z(0, 5, 4, 16), z(0, 5, 2, 16), z(0, 5, 2, 16)),
    "flash_attention/Sq": lambda z: flash_attention.flash_attention_cuda(
        z(2, 0, 4, 16), z(2, 5, 2, 16), z(2, 5, 2, 16)),
    "flash_attention/Sk": lambda z: flash_attention.flash_attention_cuda(
        z(2, 5, 4, 16), z(2, 0, 2, 16), z(2, 0, 2, 16)),
}


@pytest.mark.parametrize("case", list(EMPTY_CALLS))
def test_empty_input_launches_nothing(cuda, case):
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=cuda)

    before = ops.launch_counts()
    out = EMPTY_CALLS[case](z)
    torch.cuda.synchronize()
    assert ops.launch_counts() == before
    for t in (out if isinstance(out, tuple) else (out,)):
        assert not bool(t.any())


def test_relmax_single_and_vote_match_plain(cuda):
    x = _randn(cuda, 5, 70001, seed=3)
    x[1] = x[0]
    x[3] = x[0]
    got = majority_vote.pairwise_relmax_cuda(x)
    torch.testing.assert_close(got, majority_vote.pairwise_relmax_plain(x),
                               rtol=1e-6, atol=0)
    v_k = ops.vote(x, tau=1e-9)
    v_p = ops.vote(x, tau=1e-9, impl="torch")
    for a, b in zip(v_k, v_p):
        assert torch.equal(a, b)


def _planted(dev, B, R, d, seed):
    x = _randn(dev, B, R, d, seed=seed)
    x[:, 1] = x[:, 0]                         # an agreeing pair
    return x


@pytest.mark.parametrize("shape", [(2, 9, 3000), (1, 7, 100000),
                                   (32, 8, 256)])
def test_relmax_kernel_propagates_nan_and_inf(cuda, shape):
    B, R, d = shape
    x = _planted(cuda, B, R, d, seed=d)
    x[0, 0, 3] = float("nan")
    x[0, 2, d // 2] = float("inf")
    x[B - 1, R - 1, d - 1] = -float("inf")
    x[B - 1, R - 2, d - 1] = -float("inf")    # -inf against -inf: NaN
    before = ops.launch_counts()["pairwise_relmax_batched"]
    got = majority_vote.pairwise_relmax_batched_cuda(x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pairwise_relmax_batched"] == before + 1
    want = majority_vote.pairwise_relmax_batched_plain(x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0, equal_nan=True)
    assert bool(got[0, 0].isnan().all()) and bool(got[0, :, 0].isnan().all())
    assert bool(got[B - 1, R - 1, R - 2].isnan())


# (B, R, d): the engine's vote (one block a trial), the single form's
# many chunks a trial, R = relmax_max_replicas() in one and many chunks,
# R past one 8-row tile with a ragged last tile
RELMAX_SHAPES = [(32, 8, 256), (1, 7, 100000), (2, 96, 300), (1, 96, 40000),
                 (3, 13, 5000), (4, 17, 511)]


@pytest.mark.parametrize("shape", RELMAX_SHAPES)
def test_relmax_kernel_symmetric_and_exact(cuda, shape):
    B, R, d = shape
    assert R <= majority_vote._lib().max_r
    x = _planted(cuda, B, R, d, seed=R + d)
    got = majority_vote.pairwise_relmax_batched_cuda(x)
    want = majority_vote.pairwise_relmax_batched_plain(x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert torch.equal(got, got.transpose(1, 2))          # bitwise
    assert bool((torch.diagonal(got, dim1=1, dim2=2) == 0).all())
    assert bool((got[:, 0, 1] == 0).all())
    again = majority_vote.pairwise_relmax_batched_cuda(x)
    assert torch.equal(got, again)


def test_relmax_kernel_max_replicas(cuda):
    assert majority_vote._lib().max_r == 96
    with pytest.raises(ValueError):
        majority_vote.pairwise_relmax_batched_cuda(
            torch.zeros((1, 97, 10), device=cuda))


@pytest.mark.parametrize("R,d", [(7, 100000), (3, 255)])
def test_relmax_single_form(cuda, R, d):
    x = _randn(cuda, R, d, seed=R)
    x[1] = x[0]
    before = ops.launch_counts()["pairwise_relmax"]
    got = majority_vote.pairwise_relmax_cuda(x)
    assert ops.launch_counts()["pairwise_relmax"] == before + 1
    torch.testing.assert_close(got, majority_vote.pairwise_relmax_plain(x),
                               rtol=1e-6, atol=0)
    assert torch.equal(got, got.T) and float(got[0, 1]) == 0.0


def test_run_batch_on_card_matches_cpu(cuda):
    """The gram plane on the card against the CPU."""
    specs = [repro_torch.TrialSpec(byz=(2, 5), attack="drift", q=0.3,
                                   steps=40, seed=s, n_data=64, d=4096,
                                   lr=16.0 / 4096) for s in range(4)]
    ops.reset_launch_counts()
    card = repro_torch.run_batch(specs)
    counts = ops.launch_counts()
    assert counts["gram_factors"] > 0 and \
        counts["pairwise_relmax_batched"] > 0, counts
    cpu = repro_torch.run_batch(specs, device="cpu")
    np.testing.assert_array_equal(card.detect_flags, cpu.detect_flags)
    for a, b in zip(card, cpu):
        assert a.identify_step == b.identify_step
        assert a.q_trace == b.q_trace
        np.testing.assert_allclose(a.w, b.w, rtol=1e-4, atol=1e-4)


# name: (run_batch knobs, problems over the trials, kernels the run must
# launch)
STREAM_RUNS = {
    "fused": (dict(fused=True), 1, ("fused_step",)),
    "unfused": (dict(fused=False), 1, ("sketch_batched",)),
    "per_problem": (dict(fused=False), 2,
                    ("sketch_batched", "coded_encode_batched")),
    "bf16": (dict(fused=True, stream_dtype="bf16"), 1, ("fused_step",)),
}


@pytest.mark.parametrize("name", list(STREAM_RUNS))
def test_stream_planes_on_card_match_cpu(cuda, name):
    kw, problems, kernels = STREAM_RUNS[name]
    specs = [repro_torch.TrialSpec(
        byz=(2, 5), attack="drift", q=0.3, steps=12, seed=s, n_data=64,
        d=4096, lr=16.0 / 4096, problem_seed=s % problems)
        for s in range(4)]
    ops.reset_launch_counts()
    card = repro_torch.run_batch(specs, **kw)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in kernels), counts
    cpu = repro_torch.run_batch(specs, device="cpu", **kw)
    np.testing.assert_array_equal(card.detect_flags, cpu.detect_flags)
    for a, b in zip(card, cpu):
        assert a.identify_step == b.identify_step
        assert a.q_trace == b.q_trace
        np.testing.assert_allclose(a.w, b.w, rtol=1e-4, atol=1e-4)


def test_threefry_on_card_equals_the_numpy_block(cuda):
    """The counter RNG's torch block on CUDA int64 tensors: bitwise the
    numpy uint32 block, and the chunk's coins and keys each trial's."""
    from repro_torch.core import rngstream

    rng = np.random.default_rng(5)
    words = [rng.integers(0, 1 << 32, size=(64, 33), dtype=np.uint64
                          ).astype(np.uint32) for _ in range(4)]
    want = rngstream.threefry2x32(*words)
    got = rngstream.threefry2x32_torch(
        *[torch.from_numpy(w.astype(np.int64)).to(cuda) for w in words])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.cpu().numpy().astype(np.uint32), w)
    seeds = [0, 3, (1 << 40) + 1]
    for tag in (rngstream.DECIDE, rngstream.TAMPER, rngstream.PERM):
        ks = [rngstream.key_for(s, tag) for s in seeds]
        k0 = torch.tensor([int(a) for a, _ in ks], device=cuda)
        k1 = torch.tensor([int(b) for _, b in ks], device=cuda)
        if tag == rngstream.DECIDE:
            got = rngstream.decide_uniforms_torch(k0, k1, 17).cpu().numpy()
            for b, s in enumerate(seeds):
                np.testing.assert_array_equal(
                    got[:, b], rngstream.decide_uniforms(s, 17))
            continue
        got = rngstream.phase_worker_torch(k0, k1, 17, 9).cpu().numpy()
        for b, s in enumerate(seeds):
            np.testing.assert_array_equal(
                got[:, :, b].astype(np.uint32),
                rngstream._phase_worker_block(s, 17, 9, tag))


def test_regroup_on_card_equals_cpu(cuda):
    """The masked regroup's int64 sort on the card: the CPU's layout, key
    ties and inactive workers included."""
    rng = np.random.default_rng(9)
    B, n = 256, 9
    keys = rng.integers(0, 4, (B, n)).astype(np.int64)
    keys[::2] = rng.integers(0, 1 << 32, (B // 2, n), dtype=np.uint64)
    active = torch.from_numpy(rng.random((B, n)) < 0.75)
    repl = torch.from_numpy(rng.integers(0, 8, B).astype(np.int32))
    keys = torch.from_numpy(keys)
    want = ops.batched_regroup(keys, active, repl)
    got = ops.batched_regroup(keys.to(cuda), active.to(cuda), repl.to(cuda))
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


# name: (run_batch knobs, problems over the trials, kernels the path must
# launch)
DEVICE_PLANES = {
    "stream": (dict(), 1, ("sketch_batched", "pairwise_relmax_batched")),
    "per_problem": (dict(), 2, ("sketch_batched", "coded_encode_batched",
                                "pairwise_relmax_batched")),
    "gram": (dict(data_plane="gram"), 1,
             ("gram_factors", "pairwise_relmax_batched")),
}


@pytest.mark.parametrize("name", list(DEVICE_PLANES))
def test_device_control_kernels_match_plain_and_cpu(cuda, name):
    """schedule="device" on the card: the kernels against the plain
    versions on the card and against the CPU run: the trace, identify
    steps and counters exact, W within 1e-4; telemetry output-neutral."""
    from repro_torch.obs.telemetry import TEL_KEYS

    kw, problems, kernels = DEVICE_PLANES[name]
    specs = [repro_torch.TrialSpec(
        byz=(2, 5), attack=("sign_flip", "scale", "drift")[s % 3],
        q=(None, 0.4)[s % 2], steps=16, seed=s, n_data=64, d=4096,
        lr=16.0 / 4096, problem_seed=s % problems) for s in range(6)]
    ops.reset_launch_counts()
    card = repro_torch.run_batch(specs, schedule="device", telemetry=True,
                                 **kw)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in kernels), counts
    off = repro_torch.run_batch(specs, schedule="device", **kw)
    for k in card.device_trace:
        np.testing.assert_array_equal(card.device_trace[k],
                                      off.device_trace[k], err_msg=k)
    for a, b in zip(card, off):
        np.testing.assert_array_equal(a.w, b.w)
    for other in (
            repro_torch.run_batch(specs, schedule="device", telemetry=True,
                                  kernel_impl="torch", **kw),
            repro_torch.run_batch(specs, schedule="device", telemetry=True,
                                  device="cpu", **kw)):
        for k in ("check", "detect", "faulty2"):
            np.testing.assert_array_equal(card.device_trace[k],
                                          other.device_trace[k], err_msg=k)
        for k in TEL_KEYS:
            np.testing.assert_array_equal(card.telemetry.counters[k],
                                          other.telemetry.counters[k],
                                          err_msg=k)
        for a, b in zip(card, other):
            assert a.identify_step == b.identify_step
            np.testing.assert_allclose(a.q_trace, b.q_trace, rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(a.w, b.w, rtol=1e-4, atol=1e-4)
    assert card.telemetry.totals()["eliminations"] > 0


# name: (run_batch knobs, the plan's data plane, kernels the path must
# launch) for the "oracle" schedule
ORACLE_PLANES = {
    "gram": (dict(), "gram", ("gram_factors", "pairwise_relmax_batched")),
    "fused": (dict(fused=True), "stream",
              ("fused_step", "pairwise_relmax_batched")),
    "stream": (dict(fused=False), "stream",
               ("sketch_batched", "pairwise_relmax_batched")),
}


def _same_oracle_control(a, b):
    np.testing.assert_array_equal(a.detect_flags, b.detect_flags)
    for k, v in a.schedule.arrays.items():
        np.testing.assert_array_equal(v, b.schedule.arrays[k], err_msg=k)
    for ra, rb in zip(a, b):
        assert (ra.identify_step, ra.q_trace, ra.efficiency) == (
            rb.identify_step, rb.q_trace, rb.efficiency)


@pytest.mark.parametrize("name", list(ORACLE_PLANES))
def test_oracle_kernels_match_plain_and_cpu(cuda, name):
    """schedule="oracle" (the numpy engine's host replay) on the card:
    the adaptive_sweep shape (sign_flip, adaptive q*) at d = 4096 through
    the kernels, against the plain versions on the card and the CPU run:
    control and detect flags exact, W within 1e-4."""
    kw, plane, kernels = ORACLE_PLANES[name]
    specs = [repro_torch.TrialSpec(
        byz=(2, 5), attack="sign_flip", q=None, steps=24, seed=s, n_data=64,
        d=4096, lr=16.0 / 4096) for s in range(8)]
    ops.reset_launch_counts()
    card = repro_torch.run_batch(specs, schedule="oracle", **kw)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in kernels), counts
    assert card.plan.data_plane == plane and card.plan.kernel_impl == "cuda"
    assert card.schedule.arrays["identify"].any()
    for other in (repro_torch.run_batch(specs, schedule="oracle",
                                        kernel_impl="torch", **kw),
                  repro_torch.run_batch(specs, schedule="oracle",
                                        device="cpu", **kw)):
        _same_oracle_control(card, other)
        for a, b in zip(card, other):
            np.testing.assert_allclose(a.w, b.w, rtol=1e-4, atol=1e-4)


def test_scenario_family_on_card_matches_cpu(cuda):
    """A named scenario with no schedule argument ("auto" -> "oracle"):
    draco votes on sign-flipped replicas, the filter baselines, adaptive
    q*; the card against the CPU."""
    m = repro_torch.SCENARIOS["paper_core"]
    card = m.run(backend="torch")
    cpu = m.run(backend="torch", device="cpu")
    assert card.plan.schedule_mode == "oracle"
    assert card.plan.kernel_impl == "cuda"
    _same_oracle_control(card, cpu)
    # the "none" trials diverge under sign_flip: W is held relative to
    # its own size, 1e-4 * (1 + max|W|)
    for s, a, b in zip(card.specs, card, cpu):
        err = float(np.abs(a.w - b.w).max())
        assert err <= 1e-4 * (1 + float(np.abs(b.w).max())), s.label


# name: (run_batch knobs, problems over the trials, filter baselines)
TEL_PLANES = {
    "gram": (dict(), 1, False),
    "fused": (dict(fused=True), 1, False),
    "unfused": (dict(fused=False), 1, False),
    "bf16": (dict(fused=True, stream_dtype="bf16"), 1, False),
    "per_problem": (dict(), 2, False),
    "filter": (dict(), 1, True),
}


def _tel_specs(name, B=6):
    """Drift / noise, draco and deterministic trials (identify rounds with
    eliminations), at a contractive lr."""
    _, problems, filt = TEL_PLANES[name]
    modes = [("randomized", 0.3), ("draco", None), ("deterministic", None),
             ("randomized", 0.5)]
    if filt:
        modes[2] = ("filter:median", 0.3)
    return [repro_torch.TrialSpec(
        byz=(2, 5), attack=("drift", "noise")[s % 2], q=modes[s % 4][1],
        mode=modes[s % 4][0], steps=12, seed=s, n_data=64, d=4096,
        lr=16.0 / 4096, problem_seed=s % problems) for s in range(B)]


@pytest.mark.parametrize("name", list(TEL_PLANES))
def test_telemetry_on_card_is_output_neutral_and_matches_cpu(cuda, name):
    """telemetry=True on the card: W, losses and detect flags bitwise those
    of the run without; the counters those of the CPU run."""
    from repro_torch.obs.telemetry import TEL_KEYS

    kw = TEL_PLANES[name][0]
    specs = _tel_specs(name)
    on = repro_torch.run_batch(specs, telemetry=True, **kw)
    off = repro_torch.run_batch(specs, **kw)
    assert on.plan.kernel_impl == "cuda" and off.telemetry is None
    np.testing.assert_array_equal(on.detect_flags, off.detect_flags)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.w, b.w)
        assert a.losses == b.losses
    cpu = repro_torch.run_batch(specs, device="cpu", telemetry=True, **kw)
    for k in TEL_KEYS:
        np.testing.assert_array_equal(on.telemetry.counters[k],
                                      cpu.telemetry.counters[k], err_msg=k)
    assert on.telemetry.totals()["eliminations"] > 0


@pytest.mark.parametrize("name", ["gram", "fused", "unfused", "per_problem"])
def test_chunked_pipeline_on_card(cuda, name):
    """7 trials in chunks of 3 (the last one padded) against one chunk on
    the card: counters and detect flags equal, W and losses within the
    reference's chunking tolerance (rtol 1e-5, atol 1e-6)."""
    from repro_torch.obs.telemetry import TEL_KEYS

    kw = TEL_PLANES[name][0]
    specs = _tel_specs(name, B=7)
    one = repro_torch.run_batch(specs, telemetry=True, **kw)
    three = repro_torch.run_batch(specs, telemetry=True, chunk_trials=3,
                                  **kw)
    assert one.plan.chunk_trials >= 7 and three.plan.chunk_trials == 3
    np.testing.assert_array_equal(three.detect_flags, one.detect_flags)
    for k in TEL_KEYS:
        np.testing.assert_array_equal(three.telemetry.counters[k],
                                      one.telemetry.counters[k], err_msg=k)
    for a, b in zip(three, one):
        np.testing.assert_allclose(a.w, b.w, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a.losses, b.losses, rtol=1e-5, atol=1e-6)


# (B, Sq, Sk, H, K, hd, causal, window): ragged lengths, hd 16-256, GQA
# and MQA, windows, queries past the keys (Sk <= 1024, where the plain
# version averages every value for a row with no visible key, as K6
# does), several 1024-key blocks of the plain version
FLASH_SHAPES = [
    (1, 1, 1, 1, 1, 16, True, None),
    (2, 100, 100, 4, 2, 16, True, None),
    (1, 64, 192, 6, 6, 32, True, None),
    (2, 130, 130, 4, 1, 64, True, 48),
    (1, 97, 97, 8, 4, 64, False, None),
    (1, 100, 60, 4, 2, 32, True, None),
    (1, 100, 60, 4, 2, 32, True, 8),
    (1, 257, 300, 4, 1, 128, True, 100),
    (1, 200, 200, 4, 1, 256, True, 64),
    (1, 200, 200, 4, 1, 256, False, None),
    (2, 1100, 1100, 2, 1, 64, True, None),
    (1, 33, 1500, 4, 2, 64, True, None),
    # the Hopper bf16 body (hd 64, 128, 256): more key tiles than ring
    # stages with Sq not a multiple of the 128-query tile; GQA with a
    # window edge inside a tile; B * H of 1 to 4 (the balancing path);
    # non-causal with Sq != Sk
    (1, 1000, 1000, 4, 2, 64, True, None),
    (1, 300, 700, 2, 1, 256, True, None),
    (2, 333, 333, 8, 2, 128, True, 100),
    (1, 400, 400, 4, 2, 256, True, 150),
    (1, 1500, 1500, 1, 1, 64, True, None),
    (1, 2048, 2048, 2, 1, 256, True, None),
    (2, 200, 520, 4, 4, 64, False, None),
    # the context path: whisper's encoder (non-causal, 1500 = 11 * 128 +
    # 92 keys) and cross-attention (one query tile, B * H = 12), the
    # vision cross-attention (GQA 8:1 at hd 128, 1601 = 12 * 128 + 65)
    (1, 1500, 1500, 6, 6, 64, False, None),
    (2, 128, 1500, 6, 6, 64, False, None),
    (1, 257, 1601, 16, 2, 128, False, None),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_kernel_matches_plain(cuda, dtype, shape):
    """K6 against its plain version: f32 within 2e-5, bf16 within 2e-2
    (P is rounded to bf16 for P.V), both abs + rel; and every block of 64
    query rows within 1e-5 (f32) or 1e-2 (bf16) relative to its norm,
    which the elementwise bound alone does not hold where the outputs
    are small (late causal rows)."""
    B, Sq, Sk, H, K, hd, causal, window = shape
    dt, tol, tile_tol = ((torch.float32, 2e-5, 1e-5) if dtype == "f32"
                         else (torch.bfloat16, 2e-2, 1e-2))
    q = _randn(cuda, B, Sq, H, hd, seed=Sq).to(dt)
    k = _randn(cuda, B, Sk, K, hd, seed=Sk + 1).to(dt)
    v = _randn(cuda, B, Sk, K, hd, seed=Sk + 2).to(dt)
    before = ops.launch_counts()["flash_attention"]
    got = flash_attention.flash_attention_cuda(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = flash_attention.flash_attention_plain(q, k, v, causal, window)
    assert got.dtype == dt and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _tile_rel_err(got, want) <= tile_tol


def test_flash_kernel_reads_strided_views(cuda):
    """q, k, v as views into fused projections (head and sequence strides
    of a wider row) give what contiguous copies give, bitwise."""
    qkv = _randn(cuda, 2, 77, 8, 64, seed=5).to(torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = flash_attention.flash_attention_cuda(q, k, v, True, None)
    want = flash_attention.flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), True, None)
    assert torch.equal(got, want)


def test_flash_kernel_reruns_bitwise_at_gemma3_global(cuda):
    """Two launches at the gemma3-1b global layer's shape (1, 4096, 4,
    1, 256), bf16 causal: bitwise equal (no float atomics)."""
    q = _randn(cuda, 1, 4096, 4, 256, seed=11).to(torch.bfloat16)
    k = _randn(cuda, 1, 4096, 1, 256, seed=12).to(torch.bfloat16)
    v = _randn(cuda, 1, 4096, 1, 256, seed=13).to(torch.bfloat16)
    a = flash_attention.flash_attention_cuda(q, k, v, True, None)
    b = flash_attention.flash_attention_cuda(q, k, v, True, None)
    assert torch.equal(a, b)


def test_encode_single_ragged_d(cuda):
    """K5s at (4, 4) @ (4, 200001): d not a multiple of 4, so rows after
    the first do not start on a 16-byte boundary and the whole launch
    takes the scalar (one column a thread) body."""
    c = _randn(cuda, 4, 4, seed=21)
    g = _randn(cuda, 4, 200001, seed=22)
    got = coded_encode.coded_encode_cuda(c, g)
    assert got.shape == (4, 200001)
    assert _rel_err(got, coded_encode.coded_encode_plain(c, g)) <= 1e-5


def _small(name, dtype="float32"):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name).reduced(), dtype=dtype)


def test_prefill_is_bitwise_reproducible(cuda):
    """The same bf16 prefill twice: logits and cache bitwise equal (the
    audit replays steps and compares)."""
    from repro_torch.models import model as M

    cfg = _small("gemma3-1b", "bfloat16")
    params = M.init(cfg, 0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 300)))
    a_logits, a_cache = M.prefill(params, {"tokens": tokens}, cfg, 310)
    b_logits, b_cache = M.prefill(params, {"tokens": tokens}, cfg, 310)
    assert torch.equal(a_logits, b_logits)
    assert all(torch.equal(a_cache[n], b_cache[n]) for n in ("k", "v"))


@pytest.mark.parametrize("name", ["llama3.2-1b", "gemma3-1b", "qwen3-4b"])
def test_serving_on_card_matches_cpu(cuda, name):
    """Reduced configs in f32: ServeEngine on the card against the CPU;
    K6 in every prefill layer; logits within 1e-4 (1 + max|.|), tokens
    under the margin rule, the same audits."""
    from repro_torch.models import model as M
    from repro_torch.serving import ServeEngine, token_agreement

    cfg = _small(name)
    params = M.init(cfg, 0, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               size=(2, 40))
    cpu = ServeEngine(cfg, params, q_audit=0.5, seed=0, device="cpu",
                      record_logits=True)
    want = cpu.generate(prompt, 8)
    card = ServeEngine(cfg, params, q_audit=0.5, seed=0, record_logits=True)
    ops.reset_launch_counts()
    got = card.generate(prompt, 8).cpu()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == cfg.num_layers
    assert counts["sketch"] == 2 * card.audits
    assert (card.audits, card.audit_failures) == (cpu.audits, 0)
    tol = 1e-4 * (1 + float(torch.stack(cpu.logits).abs().max()))
    compared, agreed = token_agreement(cpu.logits, want, got, tol)
    assert compared > 0 and agreed == compared
    torch.testing.assert_close(card.logits[0].cpu(), cpu.logits[0], rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# the trainer on the card
# ---------------------------------------------------------------------------

def _trainer(cfg, device, params, mode="randomized", seed=17, impl=None):
    from repro_torch.core.randomized import BFTConfig
    from repro_torch.optim import OptConfig
    from repro_torch.train import (AttackConfig, StepConfig, Trainer,
                                   TrainerConfig)

    mask = np.zeros(8, bool)
    mask[[2, 5]] = True
    return Trainer(cfg, OptConfig(kind="momentum", peak_lr=0.05,
                                  warmup_steps=2, total_steps=40),
                   BFTConfig(n=8, f=2, mode=mode, q=0.5, p_assumed=0.6,
                             seed=seed),
                   TrainerConfig(seq_len=16, global_batch=16, log_every=0),
                   attack=AttackConfig("sign_flip", 0.6, 5.0),
                   sc=StepConfig(), true_byzantine=mask, device=device,
                   params=params, impl=impl)


def test_trainer_on_card_matches_cpu(cuda):
    """Reduced llama3.2-1b in f32, randomized q = 0.5 under sign_flip on
    [2, 5], five steps: the control exact, losses within 1e-4 relative,
    parameters within 1e-4 (1 + max|p|); K6 in every forward, K4s on
    every check member's leaves, K3 on every identify leaf."""
    from repro_torch.core import tree
    from repro_torch.models import model as M

    cfg = _small("llama3.2-1b")
    init = M.init_train(cfg, 0, device="cpu")
    cpu = _trainer(cfg, "cpu", M.map_params(torch.clone, init))
    cpu.run(5)
    card = _trainer(cfg, None, M.map_params(lambda t: t.to(cuda), init))
    ops.reset_launch_counts()
    card.run(5)
    counts = ops.launch_counts()
    assert [r.get("identified") for r in card.history] == \
        [r.get("identified") for r in cpu.history]
    for g, w in zip(card.history, cpu.history):
        assert {k: v for k, v in g.items() if k != "loss"} == \
            {k: v for k, v in w.items() if k != "loss"}
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"])
    for a, b in zip(tree.leaves(card.params), tree.leaves(cpu.params)):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-4 * (1 + float(b.abs().max()))
    n_leaves = len(tree.leaves(init))
    # under cfg.remat each layer's forward runs again in its backward
    assert counts["flash_attention"] == (2 if cfg.remat else 1) * \
        cfg.num_layers * card.state.meter.computed
    assert counts["pairwise_relmax_batched"] == \
        n_leaves * card.state.meter.identify_iterations
    assert counts["sketch"] > 0 and counts["sketch"] % n_leaves == 0


def test_honest_replicas_are_bitwise_equal_on_card(cuda):
    """Two workers on the same rows (bf16, reduced llama3.2-1b): equal
    gradients and sketches bit for bit, the premise of the check; the
    embedding's backward (an accumulating index_put) included."""
    from repro_torch.core import detection, tree
    from repro_torch.models import model as M
    from repro_torch.train import steps

    cfg = _small("llama3.2-1b", "bfloat16")
    params = M.init_train(cfg, 0)
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).to(cuda)
    lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).to(cuda)
    att = steps.AttackConfig("none")
    grads = [steps.per_worker_grad(params, tok, lab, False, (0, w), cfg,
                                   att)[1] for w in range(2)]
    for a, b in zip(tree.leaves(grads[0]), tree.leaves(grads[1])):
        assert torch.equal(a, b)
    s = [detection.sketch_tree(g, 12345) for g in grads]
    assert torch.equal(s[0], s[1])


def test_attention_gradient_on_card(cuda):
    """K6 with a gradient: the forward is the kernel's (one launch), the
    gradient the plain version's, on the card."""
    from repro_torch.kernels import ref

    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)
               .requires_grad_() for s in ((2, 256, 32, 64), (2, 256, 8, 64),
                                           (2, 256, 8, 64)))
    go = torch.randn(2, 256, 32, 64, generator=g, device=cuda).to(
        torch.bfloat16)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), go)
    assert ops.launch_counts()["flash_attention"] == 1
    assert torch.equal(out, flash_attention.flash_attention_cuda(
        q.detach(), k.detach(), v.detach()))
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v), (q, k, v),
                               go)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("G,r,d", [(1, 5, 1_000_003), (2, 3, 4097)])
def test_identify_vote_on_card_matches_plain(cuda, G, r, d):
    """``steps.vote_leaf`` with K3 against the plain version on the card:
    the same winners, faulty flags and voted values."""
    from repro_torch.train import steps

    g = torch.Generator(device=cuda).manual_seed(G * r)
    reps = torch.randn(G, 1, d, generator=g, device=cuda).repeat(1, r, 1)
    reps[0, 1] *= -10.0
    if r > 3:
        reps[0, 3, 17] += 1e-2
    got_v, got_f = steps.vote_leaf(reps, 1e-5)
    want_v, want_f = steps.vote_leaf(reps, 1e-5, impl="torch")
    assert torch.equal(got_f, want_f) and torch.equal(got_v, want_v)
    assert got_f[0].tolist() == [False, True, False] + \
        ([True, False] if r > 3 else [])


# ---------------------------------------------------------------------------
# mamba2-780m on the card
# ---------------------------------------------------------------------------

def test_mamba_serving_on_card_matches_cpu(cuda):
    """Reduced mamba2-780m in f32: ServeEngine on the card against the
    CPU (the chunked prefill, the prompt replay, audited decode); logits
    within 1e-4 (1 + max|.|), tokens under the margin rule, the same
    audits; no K6 (attention-free), K4s twice an audit; a decode step
    replayed on one cache bitwise, its input cache unchanged."""
    from repro_torch.models import model as M
    from repro_torch.serving import ServeEngine, token_agreement

    cfg = _small("mamba2-780m")
    params = M.init(cfg, 0, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               size=(2, 32))
    cpu = ServeEngine(cfg, params, q_audit=0.5, seed=0, device="cpu",
                      record_logits=True)
    want = cpu.generate(prompt, 8)
    card = ServeEngine(cfg, params, q_audit=0.5, seed=0, record_logits=True)
    ops.reset_launch_counts()
    got = card.generate(prompt, 8).cpu()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 0
    assert counts["sketch"] == 2 * card.audits > 0
    assert (card.audits, card.audit_failures) == (cpu.audits, 0)
    tol = 1e-4 * (1 + float(torch.stack(cpu.logits).abs().max()))
    compared, agreed = token_agreement(cpu.logits, want, got, tol)
    assert compared > 0 and agreed == compared
    torch.testing.assert_close(card.logits[0].cpu(), cpu.logits[0], rtol=0,
                               atol=tol)
    _, cache = M.prefill(card.params, {"tokens": prompt}, cfg, 40)
    for t in range(32):
        _, cache = M.decode_step(card.params, prompt[:, t], t, cache, cfg)
    before = {n: x.clone() for n, x in cache["mamba"].items()}
    a, ca = M.decode_step(card.params, got[:, 0], 32, cache, cfg)
    b, cb = M.decode_step(card.params, got[:, 0], 32, cache, cfg)
    assert torch.equal(a, b)
    for n in before:
        assert torch.equal(cache["mamba"][n], before[n])
        assert torch.equal(ca["mamba"][n], cb["mamba"][n])


def test_mamba_trainer_on_card_matches_cpu(cuda):
    """Reduced mamba2-780m in f32, randomized q = 0.5 under sign_flip on
    [2, 5], five steps: the control exact, losses within 1e-4 relative,
    parameters within 1e-4 (1 + max|p|); K4s on every check member's 16
    leaves, K3 on every identify leaf, no K6."""
    from repro_torch.core import tree
    from repro_torch.models import model as M

    cfg = _small("mamba2-780m")
    init = M.init_train(cfg, 0, device="cpu")
    assert len(tree.leaves(init)) == 16
    cpu = _trainer(cfg, "cpu", M.map_params(torch.clone, init))
    cpu.run(5)
    card = _trainer(cfg, None, M.map_params(lambda t: t.to(cuda), init))
    ops.reset_launch_counts()
    card.run(5)
    counts = ops.launch_counts()
    for g, w in zip(card.history, cpu.history):
        assert {k: v for k, v in g.items() if k != "loss"} == \
            {k: v for k, v in w.items() if k != "loss"}
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"])
    for a, b in zip(tree.leaves(card.params), tree.leaves(cpu.params)):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-4 * (1 + float(b.abs().max()))
    assert counts["flash_attention"] == 0
    assert counts["pairwise_relmax_batched"] == \
        16 * card.state.meter.identify_iterations
    assert counts["sketch"] > 0 and counts["sketch"] % 16 == 0


def test_mamba_honest_replicas_are_bitwise_equal_on_card(cuda):
    """Two workers on the same rows (bf16, reduced mamba2-780m, two SSD
    chunks): equal gradients and sketches bit for bit."""
    from repro_torch.core import detection, tree
    from repro_torch.models import model as M
    from repro_torch.train import steps

    cfg = _small("mamba2-780m", "bfloat16")
    params = M.init_train(cfg, 0)
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))).to(cuda)
    lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))).to(cuda)
    att = steps.AttackConfig("none")
    grads = [steps.per_worker_grad(params, tok, lab, False, (0, w), cfg,
                                   att)[1] for w in range(2)]
    for a, b in zip(tree.leaves(grads[0]), tree.leaves(grads[1])):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    s = [detection.sketch_tree(g, 12345) for g in grads]
    assert torch.equal(s[0], s[1])


# ---------------------------------------------------------------------------
# phi3.5-moe and jamba on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"])
def test_moe_serving_on_card_matches_cpu(cuda, name):
    """Reduced phi3.5-moe (prefill k/v, no replay) and jamba (the prompt
    replayed to fill its mamba cache) in f32: ServeEngine on the card
    against the CPU; logits within 1e-4 (1 + max|.|), tokens under the
    margin rule, the same audits; K6 once per attention layer, K4s twice
    an audit."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import attn_layer_indices
    from repro_torch.serving import ServeEngine, token_agreement

    cfg = _small(name)
    params = M.init(cfg, 0, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               size=(2, 32))
    cpu = ServeEngine(cfg, params, q_audit=0.5, seed=0, device="cpu",
                      record_logits=True)
    want = cpu.generate(prompt, 8)
    card = ServeEngine(cfg, params, q_audit=0.5, seed=0, record_logits=True)
    ops.reset_launch_counts()
    got = card.generate(prompt, 8).cpu()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == len(attn_layer_indices(cfg))
    assert counts["sketch"] == 2 * card.audits > 0
    assert (card.audits, card.audit_failures) == (cpu.audits, 0)
    tol = 1e-4 * (1 + float(torch.stack(cpu.logits).abs().max()))
    compared, agreed = token_agreement(cpu.logits, want, got, tol)
    assert compared > 0 and agreed == compared
    torch.testing.assert_close(card.logits[0].cpu(), cpu.logits[0], rtol=0,
                               atol=tol)


@pytest.mark.parametrize("name", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_ctx_serving_on_card_matches_cpu(cuda, name):
    """Reduced whisper-tiny (its encoder) and llama-3.2-vision-90b (its
    cross-attention layers, gates at 0.5) in f32 with a context:
    ServeEngine on the card against the CPU; logits within 1e-4 (1 +
    max|.|), tokens under the margin rule, the same audits; K6 in every
    attention of the prefill (encoder, decoder self- and
    cross-attention), K4s twice an audit; the prefill's logits on the
    card against the CPU's, and moved by a second context."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import (attn_layer_indices,
                                                num_cross)
    from repro_torch.serving import ServeEngine, token_agreement

    cfg = _small(name)
    params = M.init(cfg, 0, device="cpu")
    for p in params["layers"]:
        if "gate_attn" in p["mixer"]:
            p["mixer"]["gate_attn"].fill_(0.5)
    T = cfg.num_encoder_positions if cfg.is_encoder_decoder \
        else cfg.num_vision_tokens
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 24))
    ctx, ctx2 = (rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
                 for _ in range(2))
    cpu = ServeEngine(cfg, params, q_audit=0.5, seed=0, device="cpu",
                      record_logits=True)
    want = cpu.generate(prompt, 8, ctx=ctx)
    card = ServeEngine(cfg, params, q_audit=0.5, seed=0, record_logits=True)
    ops.reset_launch_counts()
    got = card.generate(prompt, 8, ctx=ctx).cpu()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == cfg.encoder_layers + len(
        attn_layer_indices(cfg)) + num_cross(cfg)
    assert counts["sketch"] == 2 * card.audits > 0
    assert (card.audits, card.audit_failures) == (cpu.audits, 0)
    tol = 1e-4 * (1 + float(torch.stack(cpu.logits).abs().max()))
    compared, agreed = token_agreement(cpu.logits, want, got, tol)
    assert compared > 0 and agreed == compared
    torch.testing.assert_close(card.logits[0].cpu(), cpu.logits[0], rtol=0,
                               atol=tol)
    pre = {}
    for d, p in (("cpu", params), ("cuda", card.params)):
        for i, c in enumerate((ctx, ctx2)):
            pre[d, i], _ = M.prefill(p, {"tokens": prompt, "ctx": c}, cfg)
    for i in range(2):
        torch.testing.assert_close(pre["cuda", i].cpu(), pre["cpu", i],
                                   rtol=0, atol=tol)
    assert float((pre["cpu", 0] - pre["cpu", 1]).abs().max()) > 100 * tol


def test_moe_honest_replicas_are_bitwise_equal_on_card(cuda, monkeypatch):
    """Two workers on the same rows (bf16, reduced phi3.5-moe at a
    capacity factor that drops choices): equal gradients on every leaf,
    the router and experts included, and equal sketches, bit for bit:
    the dispatch's and combine's backward add no floats atomically."""
    import dataclasses

    from repro_torch.core import detection, tree
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.train import steps

    cfg = _small("phi3.5-moe-42b-a6.6b", "bfloat16")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    params = M.init_train(cfg, 0)
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).to(cuda)
    lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).to(cuda)
    dropped, routing = [], moe.routing

    def recorded(*a):
        out = routing(*a)
        dropped.append(int((~out[4]).sum()))
        return out

    monkeypatch.setattr(moe, "routing", recorded)
    att = steps.AttackConfig("none")
    grads = [steps.per_worker_grad(params, tok, lab, False, (0, w), cfg,
                                   att)[1] for w in range(2)]
    # under cfg.remat each layer routes again in its backward
    assert len(dropped) == 2 * cfg.num_layers * (2 if cfg.remat else 1)
    assert min(dropped) > 0
    for a, b in zip(tree.leaves(grads[0]), tree.leaves(grads[1])):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    s = [detection.sketch_tree(g, 12345) for g in grads]
    assert torch.equal(s[0], s[1])


def test_dryrun_matches_train_step_on_card(cuda):
    """The meta dry-run of a two-layer llama3.2-1b train step at full
    width (K6's shape-only form) against the same step on the card
    under the same counter (K6 itself): FLOPs, bytes and arguments
    exact, K6's launches the counter's calls, the measured peak within
    10% of the prediction."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import memprobe
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, init_opt_state

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2)
    B, S = 2, 128
    opt = OptConfig()
    pred = D.lower_compile(cfg, ShapeConfig("t", S, B, "train"), opt)
    params = M.init_train(cfg, 0, cuda)
    state = init_opt_state(opt, params)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {n: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                              device=cuda, dtype=torch.int32)
             for n in ("tokens", "labels")}
    step = D.step_for(cfg, "train", opt)
    step(params, state, batch, 0)               # libraries' workspaces
    ops.reset_launch_counts()
    (_, got), mem = memprobe.measure_peak(
        lambda *a: D.count_step(step, a, "cuda"), (params, state, batch, 0),
        cuda)
    for key in ("flops", "flops_by_dtype", "bytes", "arg_bytes",
                "out_bytes", "kernels"):
        assert got[key] == pred[key], key
    assert ops.launch_counts()["flash_attention"] == \
        pred["kernels"]["flash_attention"]["calls"] == \
        (2 if cfg.remat else 1) * cfg.num_layers
    assert abs(mem["peak_bytes"] / pred["peak_bytes"] - 1) <= 0.10


def test_moe_layer_makes_no_host_sync_on_card(cuda):
    """The MoE layer's forward and backward on the card never wait on
    the host (its expert counts are a scatter-add, not ``bincount``),
    and its aux is bitwise the ``bincount`` formula's."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = moe.init_moe(cfg, gen, cuda)
    for p in params.values():
        p.requires_grad_(True)
    x = torch.randn((2, 48, cfg.d_model), generator=gen, device=cuda).to(
        torch.bfloat16).requires_grad_(True)
    moe.moe(params, x, cfg)                      # warm: lazy inits
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe(params, x, cfg)
        (y.float().sum() + aux).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    probs, idx, *_ = moe.routing(params, x.detach().reshape(-1, cfg.d_model),
                                 cfg)
    E, NK = cfg.moe.num_experts, idx.numel()
    frac = torch.bincount(idx.reshape(-1), minlength=E).to(torch.float32) / NK
    assert torch.equal(aux, E * torch.sum(frac * probs.mean(dim=0)))


def _ranks_job(tmp_path, **kw):
    """llama3.2-1b at full width, 2 layers, 8 workers (sign_flip on 2
    and 5), deterministic mode, 3 steps, as a ``launch.train.Job``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.randomized import BFTConfig
    from repro_torch.launch.train import Job
    from repro_torch.optim import OptConfig
    from repro_torch.train import AttackConfig, StepConfig, TrainerConfig

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2)
    return Job(cfg, OptConfig(kind="adamw", peak_lr=1e-4, warmup_steps=1,
                              total_steps=100),
               BFTConfig(n=8, f=2, mode="deterministic", seed=0),
               TrainerConfig(seq_len=64, global_batch=16, log_every=0),
               AttackConfig("sign_flip", 1.0, 10.0), StepConfig(),
               np.isin(np.arange(8), [2, 5]), actions=(("run", 3),),
               device="cuda", out=str(tmp_path), **kw)


def _one_process(job):
    from repro_torch.train import Trainer

    t = Trainer(job.cfg, job.opt, job.bft, job.tc, attack=job.attack,
                sc=job.sc, true_byzantine=job.true_byzantine)
    t.run(job.actions[0][1])
    return t


def test_one_nccl_rank_is_bitwise_the_one_process_trainer(cuda, tmp_path):
    import dataclasses

    from repro_torch.core import tree
    from repro_torch.launch import train as launch

    job = _ranks_job(tmp_path, backend="nccl")
    one = _one_process(job)
    res, tr = launch.rank_main(0, 1, dataclasses.replace(
        job, init_method=f"tcp://localhost:{launch.free_port()}"))
    assert res["main"]["history"] == one.history
    assert res["agree"] and res["counts"]["all_gather"] > 0
    for a, b in zip(tree.leaves(tr.params) + tree.leaves(tr.opt_state),
                    tree.leaves(one.params) + tree.leaves(one.opt_state)):
        assert torch.equal(a, b)


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two ranks on one card under gloo (operands staged through host
    memory): the one-process run's decisions, every rank bitwise rank
    0's."""
    from repro_torch.launch import train as launch

    job = _ranks_job(tmp_path, backend="gloo")
    one = _one_process(job)
    results = launch.spawn(job, 2)

    def ctl(h):
        return [{k: v for k, v in r.items() if k != "loss"} for r in h]

    for r in results:
        assert ctl(r["main"]["history"]) == ctl(one.history)
        assert r["agree"] and r["staged"] and r["counts"]["staged_bytes"] > 0


def test_model_axis_gloo_step_reruns_bitwise(cuda, tmp_path):
    """Two gloo ranks sharing the card as one worker's model axis (model
    = 2, W = 1): the same run twice gives the same bits (per-step
    checksums of every rank's shards) and the one-process run's
    decisions."""
    import dataclasses

    from repro_torch.launch import train as launch

    job = dataclasses.replace(_ranks_job(tmp_path, backend="gloo"), model=2)
    one = _one_process(job)
    runs = [launch.spawn(job, 2) for _ in range(2)]

    def ctl(h):
        return [{k: v for k, v in r.items() if k != "loss"} for r in h]

    for a, b in zip(*runs):
        assert ctl(a["main"]["history"]) == ctl(one.history)
        assert a["main"] == b["main"] and a["model"] == 2
        assert all(torch.equal(x, y) for x, y in zip(a["checksums"],
                                                     b["checksums"]))
        assert a["model_counts"]["all_reduce"] > 0 and a["staged"]


# ---------------------------------------------------------------------------
# the trials split and launches on a card that is not current
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(fused=False),
                                dict(data_plane="gram"),
                                dict(schedule="device", telemetry=True)],
                         ids=["fused", "unfused", "gram", "device"])
def test_split_over_the_card_twice_is_bitwise_one_device(cuda, kw):
    """A mesh that lists the card twice (every card in turn with more):
    each shard's pass holds as many trials as the one-device run's, so
    control, W, losses and counters are the same bits."""
    from repro_torch.sharding import TrialsMesh

    n = torch.cuda.device_count()
    specs = [repro_torch.TrialSpec(byz=(2, 5), attack="drift",
                                   q=None if kw.get("schedule") else 0.3,
                                   steps=20, seed=s, n_data=64, d=4096)
             for s in range(16)]
    one = repro_torch.run_batch(specs, mesh=None, chunk_trials=4, **kw)
    mesh = TrialsMesh(tuple(f"cuda:{i % n}" for i in range(max(2, n))))
    split = repro_torch.run_batch(specs, mesh=mesh,
                                  chunk_trials=4 * max(2, n), **kw)
    assert split.plan.n_devices == max(2, n)
    for a, b in zip(one.results, split.results):
        assert np.array_equal(a.w, b.w) and a.losses == b.losses
        assert (a.identify_step, a.q_trace, a.efficiency) == \
            (b.identify_step, b.q_trace, b.efficiency)
    assert np.array_equal(one.detect_flags, split.detect_flags)
    if kw.get("telemetry"):
        for k, v in one.telemetry.counters.items():
            assert np.array_equal(v, split.telemetry.counters[k])


def test_auto_mesh_uses_every_card(cuda):
    from repro_torch.sharding import trials_mesh

    spec = repro_torch.TrialSpec(byz=(2,), attack="drift", steps=5, q=0.5,
                                 d=64, n_data=64)
    res = repro_torch.run_batch([spec] * 4)
    n = torch.cuda.device_count()
    assert res.plan.n_devices == (n if n > 1 else 1)
    assert (trials_mesh() is None) == (n == 1)


def _other_card_cases(dev):
    gen = torch.Generator(device=dev).manual_seed(3)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    keys = _keys(4)
    x = r(5, 6, 3001)
    x[:, 1] = x[:, 0]
    qkv = (r(2, 200, 4, 64).bfloat16(), r(2, 200, 2, 64).bfloat16(),
           r(2, 200, 2, 64).bfloat16())
    return {
        "gram_factors": (lambda impl, R, W: ops.gram_factors(
            R, W, keys, impl=impl), (r(10, 9001), r(3, 9001))),
        "fused_step": (lambda impl, R, W, cw: ops.fused_step(
            R, W.clone(), cw, 5, impl=impl),
            (r(10, 9001), r(3, 9001), r(3, 10))),
        "pairwise_relmax_batched": (lambda impl, a: ops.
                                    batched_pairwise_relmax(a, impl=impl),
                                    (x,)),
        "sketch_batched": (lambda impl, a: ops.batched_sketch(
            a, 9, impl=impl), (r(10, 9001),)),
        "sketch": (lambda impl, a: ops.sketch(a, 9, impl=impl),
                   (r(70001),)),
        "coded_encode_batched": (lambda impl, c, g: ops.batched_coded_encode(
            c, g, impl=impl), (r(3, 2, 6), r(3, 6, 3001))),
        "flash_attention": (lambda impl, q, k, v: ops.flash_attention(
            q, k, v, impl=impl), qkv),
    }


@pytest.mark.parametrize("name", ["gram_factors", "fused_step",
                                  "pairwise_relmax_batched",
                                  "sketch_batched", "sketch",
                                  "coded_encode_batched", "flash_attention"])
def test_kernel_on_a_card_that_is_not_current(cuda, name):
    """The kernel on cuda:1 while cuda:0 is current: its outputs on
    cuda:1, bitwise the kernel on cuda:0's copy of the inputs, close to
    the plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    call, args = _other_card_cases(dev)[name]

    def outs(x):
        return [t for t in (x if isinstance(x, tuple) else (x,))
                if t is not None]

    with torch.cuda.device(0):
        got = outs(call("cuda", *args))
        torch.cuda.synchronize(dev)
        want = outs(call("torch", *args))
        on0 = outs(call("cuda", *(a.to("cuda:0") for a in args)))
    for a, b, c in zip(got, want, on0):
        assert a.device == dev
        assert torch.equal(a.cpu(), c.cpu())
        tol = 2e-2 if a.dtype == torch.bfloat16 else 1e-3
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


def _fsdp_rank(rank, world, port, out):
    """One of two gloo ranks sharing the card as a data axis of 2: a
    leaf's shard gathered (``parallel.fsdp_gather``) and its gradient
    reduce-scattered, twice; an ordered all-reduce."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_step_mesh
    from repro_torch.models import parallel
    from repro_torch.sharding import set_mesh
    from repro_torch.train import ranks as R

    dev = R.rank_device("gloo", "cuda", rank)
    R.init("gloo", rank, world, init_method=f"tcp://localhost:{port}",
           device=dev, timeout_s=120)
    mesh = R.StepMesh(make_step_mesh(world, 1, device_type="cuda"), dev)
    g = torch.Generator(device=dev).manual_seed(rank)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        runs = []
        for _ in range(2):
            shard = torch.randn(96, 1000, generator=torch.Generator(
                device=dev).manual_seed(10 + rank), device=dev).to(dtype)
            grad = torch.randn(96, 2000, generator=torch.Generator(
                device=dev).manual_seed(20 + rank), device=dev).to(dtype)
            leaf = shard.requires_grad_()
            with set_mesh(mesh):
                full = parallel.fsdp_gather(leaf, 1)
            full.backward(grad)
            runs.append((full.detach().cpu(), leaf.grad.cpu()))
        res[str(dtype)] = runs
    t = torch.randn(12345, generator=g, device=dev)
    res["ordered"] = mesh.axes["data"].all_reduce_ordered(t).cpu()
    res["staged"] = mesh.axes["data"].staged
    res["counts"] = mesh.counts()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_fsdp_gather_and_reduce_scatter_on_one_card(cuda, tmp_path):
    """Two gloo ranks sharing the card (operands staged through host
    memory) on a data axis of 2: ``fsdp_gather``'s forward is both
    shards side by side along the leaf's d_model dim, its backward each
    rank's slice of the two gradients summed in f32 (rank 0's first)
    and cast to the leaf's dtype, bitwise on a rerun, in f32 and bf16;
    ``all_reduce_ordered`` gives both ranks the same bits, the f32 sum
    in rank order."""
    from repro_torch.launch.train import free_port, start_ranks

    start_ranks(_fsdp_rank, (2, free_port(), str(tmp_path)), 2)
    r = [torch.load(tmp_path / f"rank{i}.pt") for i in range(2)]

    def draw(seed, cols, dtype):
        return torch.randn(96, cols, generator=torch.Generator(
            device=cuda).manual_seed(seed), device=cuda).to(dtype).cpu()

    for dtype in (torch.float32, torch.bfloat16):
        shards = [draw(10 + i, 1000, dtype) for i in range(2)]
        grads = [draw(20 + i, 2000, dtype) for i in range(2)]
        whole = torch.cat(shards, 1)
        summed = (grads[0].float() + grads[1].float()).to(dtype)
        for i in range(2):
            (f0, g0), (f1, g1) = r[i][str(dtype)]
            assert torch.equal(f0, whole) and torch.equal(f1, whole)
            assert torch.equal(g0, g1)
            assert torch.equal(g0, summed[:, i * 1000:(i + 1) * 1000])
    assert torch.equal(r[0]["ordered"], r[1]["ordered"])
    ts = [torch.randn(12345, generator=torch.Generator(
        device=cuda).manual_seed(i), device=cuda).cpu() for i in range(2)]
    assert torch.equal(r[0]["ordered"], ts[0] + ts[1])
    assert all(x["staged"] and x["counts"]["data"]["all_to_all"] > 0 and
               x["counts"]["data"]["staged_bytes"] > 0 for x in r)
