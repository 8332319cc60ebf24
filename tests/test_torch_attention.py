"""The port's attention against the JAX package, on the CPU.

K6's plain version (``ref.flash_attention_ref``, reached through
``ops.flash_attention`` on CPU tensors), the naive ``mha_ref`` and
``decode_attention`` go through the port and the reference on the same
seeded numpy inputs.  The reference runs its Pallas kernel in interpret
mode, its ``mha_ref`` oracle and the blockwise attention its prefill
lowers.  Tolerances are the reference's (tests/test_kernels.py,
tests/test_kernel_parity.py): 2e-5 in f32, 2e-2 in bf16.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from torch_threads import one_thread  # noqa: F401 (one thread)

TOL = {"f32": 2e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}

# tests/test_kernels.py:62-70, plus queries past the keys and hd = 256
CASES = {
    "causal_gqa": (2, 128, 128, 4, 2, 64, True, None),
    "prefill_continuation": (1, 64, 192, 6, 6, 32, True, None),
    "window_mqa": (2, 128, 128, 4, 1, 64, True, 48),
    "bidirectional": (1, 96, 96, 8, 4, 64, False, None),
    "ragged": (1, 100, 100, 2, 2, 32, True, None),
    "sq_past_sk_causal": (1, 100, 60, 4, 2, 32, True, None),
    "sq_past_sk_bidirectional": (1, 100, 60, 4, 2, 32, False, None),
    "hd256_window": (1, 80, 80, 4, 1, 256, True, 24),
    "hd16": (2, 50, 50, 4, 2, 16, True, None),
}


def _inputs(case, dtype):
    B, Sq, Sk, H, K, hd = CASES[case][:6]
    rng = np.random.default_rng(sum(CASES[case][:6]))
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd))]
    j = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    # the same values in both packages: round to bf16 once, in JAX
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(TDT[dtype])
         for x in j]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.array(x.astype(jnp.float32))


def _rows_with_a_key(case):
    """Query rows that see at least one key (all but the first Sq - Sk
    rows of a causal case with Sq > Sk)."""
    _, Sq, Sk, _, _, _, causal, _ = CASES[case]
    return slice(max(0, Sq - Sk) if causal else 0, Sq)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_plain_matches_reference(case, dtype):
    causal, window = CASES[case][6:]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, dtype)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    tol = TOL[dtype]
    want_block = jattn.blockwise_attention(jq, jk, jv, causal=causal,
                                           window=window)
    want_mha = jref.mha_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want_block), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(want_mha), rtol=tol, atol=tol)
    # the Pallas kernel gives rows with no visible key another value
    rows = _rows_with_a_key(case)
    want_pallas = jops.flash_attention(jq, jk, jv, causal=causal,
                                       window=window, bq=32, bk=32,
                                       interpret=True)
    np.testing.assert_allclose(_np(got)[:, rows], _np(want_pallas)[:, rows],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["causal_gqa", "window_mqa",
                                  "sq_past_sk_causal", "hd256_window"])
def test_mha_ref_matches_reference(case, dtype):
    causal, window = CASES[case][6:]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, dtype)
    got = tref.mha_ref(tq, tk, tv, causal=causal, window=window)
    want = jref.mha_ref(jq, jk, jv, causal=causal, window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("q_block,kv_block", [(32, 32), (16, 64), (64, 16),
                                              (128, 128)])
def test_flash_plain_block_sizes(q_block, kv_block):
    """The blockwise loop at other tile sizes (ragged tails, several
    query and key blocks) against the naive oracle, f32 2e-5."""
    (_, _, _), (tq, tk, tv) = _inputs("ragged", "f32")
    want = tref.mha_ref(tq, tk, tv, causal=True)
    got = tref.flash_attention_ref(tq, tk, tv, causal=True, q_block=q_block,
                                   kv_block=kv_block)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    (_, _, _), (tq, tk, tv) = _inputs("window_mqa", "f32")
    want = tref.mha_ref(tq, tk, tv, causal=True, window=48)
    got = tref.flash_attention_ref(tq, tk, tv, causal=True, window=48,
                                   q_block=q_block, kv_block=kv_block)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_dispatch_on_cpu():
    """CPU tensors take the plain version and launch nothing; the CUDA
    kernel refuses CPU tensors; a window below 1 is refused."""
    _, (tq, tk, tv) = _inputs("ragged", "f32")
    before = tops.launch_counts()["flash_attention"]
    tops.flash_attention(tq, tk, tv)
    tops.flash_attention(tq, tk, tv, impl="torch")
    assert tops.launch_counts()["flash_attention"] == before
    with pytest.raises(ValueError, match="cuda"):
        tops.flash_attention(tq, tk, tv, impl="cuda")
    with pytest.raises(ValueError, match="window"):
        tops.flash_attention(tq, tk, tv, window=0)
    empty = tops.flash_attention(tq[:0], tk[:0], tv[:0])
    assert empty.shape == (0,) + tuple(tq.shape[1:])


# (B, S cache, H, K, hd, valid_len, window)
DECODE_CASES = {
    "gqa": (2, 64, 4, 2, 32, 40, None),
    "window": (2, 64, 4, 1, 16, 50, 12),
    "window_past_start": (1, 64, 4, 2, 32, 7, 12),
    "full_cache": (3, 48, 8, 8, 64, 48, None),
    "hd256_mqa": (1, 40, 4, 1, 256, 33, 32),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_attention_matches_reference(case, dtype):
    B, S, H, K, hd, valid, window = DECODE_CASES[case]
    rng = np.random.default_rng(S + valid)
    q = jnp.asarray(rng.normal(size=(B, 1, H, hd)), JDT[dtype])
    ck = jnp.asarray(rng.normal(size=(B, S, K, hd)), JDT[dtype])
    cv = jnp.asarray(rng.normal(size=(B, S, K, hd)), JDT[dtype])
    want = jattn.decode_attention(q, ck, cv, valid_len=valid, window=window)

    def t(x):
        return torch.from_numpy(_np(x)).to(TDT[dtype])

    got = tattn.decode_attention(t(q), t(ck), t(cv), valid_len=valid,
                                 window=window)
    assert got.dtype == TDT[dtype]
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
