"""Serving: batched prefill + greedy decode with a KV / SSM cache, and
the paper's §5 self-check applied to inference.

Port of ``repro.serving.engine``.  ``audit_decode`` replays a decode
step and compares CountSketches of the two logit arrays (K4s on the
card): a Byzantine or silently corrupting serving replica is caught
almost surely over time, by the randomized-check argument of §4.2.
``ServeEngine.generate`` audits each step with probability ``q_audit``,
drawing its coins from ``np.random.default_rng(seed)`` and keying step
i's sketch by seed + 1000 + i, as the reference does, and emits the
reference's span ``serve.audit_decode`` (with ``step``) around each
audit and its counters ``serve.audits`` and ``serve.audit_failures``
through ``repro_torch.obs``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import detection
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.obs import metrics as obmetrics
from repro_torch.obs import trace as obtrace


def serve_step(params, token, pos: int, cache, cfg):
    """One decode step (the reference's decode entry point)."""
    return M.decode_step(params, token, pos, cache, cfg)


def sketches_agree(s1: torch.Tensor, s2: torch.Tensor) -> bool:
    """The audit's test: |s1 - s2| <= 1e-5 (1 + |s1|) in every bucket."""
    return bool(((s1 - s2).abs() <= 1e-5 * (1.0 + s1.abs())).all())


def audit_decode(params, token, pos: int, cache, cfg, *, key: int,
                 k: int = 256, impl: str | None = None):
    """Replay a decode step and compare logit sketches.

    ``key`` is the seed n of the reference's ``jax.random.PRNGKey(n)``.
    Returns (logits, cache, consistent: bool).  The replay writes the same
    k/v at ``pos`` as the first run (``decode_step``) and reads the mamba
    state the first run left untouched, so it sees the cache the first
    run saw.
    """
    logits, new_cache = M.decode_step(params, token, pos, cache, cfg)
    logits2, _ = M.decode_step(params, token, pos, cache, cfg)
    ks = detection.key_scalar_for_seed(key)
    s1 = detection.hash_sign_sketch(logits.reshape(-1), ks, k, impl=impl)
    s2 = detection.hash_sign_sketch(logits2.reshape(-1), ks, k, impl=impl)
    return logits, new_cache, sketches_agree(s1, s2)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class ServeEngine:
    """Batched greedy generation over the model facade.

    ``device=None`` puts the parameters on the card (raising without
    one); ``impl`` picks the kernels' implementation (``None``: follow
    the device; ``"torch"``: the plain versions, for comparison).  After
    ``generate``: ``audits``, ``audit_failures``, ``phase_s`` (seconds
    of the prefill, of the prompt's replay through decode that fills a
    mamba cache or follows a cross cache, of the unaudited decode steps
    and of the audited ones, the card synchronized at each boundary)
    and, with
    ``record_logits``, ``logits``: the (B, V) logits each token was
    chosen from.
    """

    cfg: Any
    params: Any
    q_audit: float = 0.0
    seed: int = 0
    device: Any = None
    impl: str | None = None
    record_logits: bool = False

    def __post_init__(self):
        tfm.require_ported(self.cfg)
        self.device = M.resolve_device(self.device)
        self.params = M.to_device(self.params, self.device)
        self._rng = np.random.default_rng(self.seed)
        self.audits = 0
        self.audit_failures = 0
        self.phase_s: dict[str, float] = {}
        self.logits: list[torch.Tensor] = []

    def generate(self, tokens, steps: int, ctx=None) -> torch.Tensor:
        """Greedy generation.  tokens: (B, S) prompt; ctx: (B, T, D)
        context embeddings, which a model that attends to a context
        needs; returns (B, steps)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        S = tokens.shape[1]
        batch = {"tokens": tokens}
        if ctx is not None:
            batch["ctx"] = ctx
        self.logits = []
        t0 = time.perf_counter()
        logits, cache = M.prefill(self.params, batch, self.cfg,
                                  cache_len=S + steps, impl=self.impl)
        _sync(self.device)
        t_pre = time.perf_counter()
        # a mamba or cross cache: the prompt replayed through decode from
        # the prefill's cache (O(S) steps), as the reference does; its
        # last step's logits choose the first token.  Nothing writes the
        # cross caches, so the replay and every later step read them as
        # zero: the tokens do not depend on ctx, in the reference either
        if "mamba" in cache or "cross_k" in cache:
            for t in range(S):
                logits, cache = M.decode_step(self.params, tokens[:, t], t,
                                              cache, self.cfg)
            _sync(self.device)
        t1 = time.perf_counter()
        out = []
        audit_s = 0.0
        tok = torch.argmax(logits, dim=-1)
        for i in range(steps):
            if self.record_logits:
                self.logits.append(logits)
            out.append(tok)
            pos = S + i
            if self.q_audit and self._rng.random() < self.q_audit:
                _sync(self.device)
                ta = time.perf_counter()
                with obtrace.span("serve.audit_decode", step=i):
                    logits, cache, ok = audit_decode(
                        self.params, tok, pos, cache, self.cfg,
                        key=self.seed + 1000 + i, impl=self.impl)
                audit_s += time.perf_counter() - ta   # ok waited for it
                self.audits += 1
                self.audit_failures += int(not ok)
                obmetrics.counter("serve.audits").inc()
                if not ok:
                    obmetrics.counter("serve.audit_failures").inc()
            else:
                logits, cache = M.decode_step(self.params, tok, pos, cache,
                                              self.cfg)
            tok = torch.argmax(logits, dim=-1)
        _sync(self.device)
        self.phase_s = {"prefill": t_pre - t0, "replay": t1 - t_pre,
                        "decode": time.perf_counter() - t1 - audit_s,
                        "audit": audit_s}
        if not out:
            return torch.zeros((tokens.shape[0], 0), dtype=torch.int64,
                               device=self.device)
        return torch.stack(out, dim=1)


def token_agreement(ref_logits, ref_tokens, tokens, tol: float):
    """Greedy tokens compared where the reference's choice is clear.

    ref_logits: per step, the (B, V) logits the reference chose from;
    ref_tokens, tokens: (B, steps).  Row by row, steps are compared from
    the first until the first step whose reference top-2 margin is at
    most ``tol`` (the logit tolerance: a smaller margin lets rounding
    flip the choice, and the sequences may part from there on).  Returns
    (compared, agreed): the tokens compared and how many were equal; a
    row stops at its first unequal token, so ``agreed == compared`` is
    the check.
    """
    ref_tokens = torch.as_tensor(ref_tokens).cpu()
    tokens = torch.as_tensor(tokens).cpu()
    top2 = torch.stack([torch.as_tensor(lg).float().cpu().topk(2, dim=-1)
                        .values for lg in ref_logits])          # (T, B, 2)
    margin = top2[..., 0] - top2[..., 1]
    compared = agreed = 0
    for b in range(ref_tokens.shape[0]):
        for i in range(ref_tokens.shape[1]):
            if float(margin[i, b]) <= tol:
                break
            compared += 1
            if int(tokens[b, i]) != int(ref_tokens[b, i]):
                break
            agreed += 1
    return compared, agreed
