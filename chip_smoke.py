#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failed check exits nonzero:

1. the card: name and power limit, a build of every CUDA source;
2. each kernel against its plain PyTorch version on the card, at the
   engine's main-path shapes and at ragged shapes, with times (CUDA
   events, median after warm-up; K3, the single forms K3s, K4s, K5s and
   their yardsticks over 50 back-to-back calls, divided by 50) beside
   the card's bound and, where one PyTorch call computes the same
   function, that call's time; for K1, K2, K3, K3s, K5s and K6 also the
   kernel's device time from ``torch.profiler`` (its own kernel, by
   name), for K4s every kernel of the call, with one profiler window
   showing one launch per call; K1's, K2's and K4s's reruns bitwise
   equal; K1 (the sketch tables on the tensor cores: its SASS counted
   for HGMMA / HMMA) also at ragged (Ie, d, T, k) with k = 96 and 512, one key,
   one row, d < k; K4s at d = 1, 255, 256, 257, 513024; K6 (flash
   attention) at the llama3.2-1b and qwen3-4b prefill shapes, gemma3-1b's
   local and global layers, small f32 and bf16 ragged shapes (each held
   elementwise and, with a limit scaled to the data, per block of 64
   query rows), and one timing at the prefill_32k sequence length,
   beside SDPA's time;
3. the main paths, each driven through ``repro_torch.run_batch`` with
   the launch counts set to 0 just before and read just after, checked
   against the same run with the plain versions
   (``kernel_impl="torch"``): control exact, W within 1e-4*(1+max|W|),
   no honest worker identified:
   - gram_sweep (B = 32, T = 120, n_data = 64, d = 2^20): K1, K3;
   - fused_sweep (B = 256, T = 3, d = 2^20, default lr) with
     ``fused=True`` (K2) and ``fused=False`` (K4), which must agree with
     each other; the default lr diverges at this width, so both run
     again at a contractive lr with W held against the plain versions
     per trial; and once more with bf16 rows, against the f32 run;
   - per-trial problems (B = 8, 4 problems, T = 3, d = 2^20): K4, K5;
   - the device control plane (``schedule="device"``): the reference's
     adaptive_sweep (B = 256, T = 24, d = 2^13, adaptive q*_t,
     sign_flip) on the stream plane (K4, K3), and its trials at
     d = 2^20 on the stream plane and on the gram plane (K1, K3), each
     held against the plain versions (the decision trace, identify
     steps, kappa, meters and counters exact), once with
     ``telemetry=True``, and the two stream paths once in a profiler
     window (kernels a step, the card's busy share in the step loop); a
     contractive variant held per trial; B = 8, d = 4096 on the card
     against the CPU;
   - the "oracle" schedule (the numpy engine's host replay, the data
     plane on the card): adaptive_sweep (B = 256, T = 24, d = 2^13) on
     the gram (K1, K3), fused (K2, K3) and stream (K4, K3) planes, its
     control equal to the numpy engine's own run and its wall printed
     beside the warm ``schedule="device"`` wall; its trials at d = 2^20
     (B = 4) on the gram and stream planes; and the five named
     ``SCENARIOS`` at their defined size (d = 8, 300 steps) with no
     schedule argument, each also against the CPU run; every run held
     against the plain versions on the card, the scan's sketch verdicts
     equal to the replay's identify decisions;
   - the trials split (``phase_engine_split``): gram_sweep, fused_sweep
     and the device plane's adaptive_sweep through
     ``run_batch(mesh=...)`` at every device count up to the visible
     cards (on one card a mesh of cuda:0 twice), each shard's pass as
     many trials as the one-device run's, so control equal and W and
     losses bitwise; every card of the mesh used; the walls by device
     count; with two or more cards each engine kernel and K6 first run
     on a card that is not current, bitwise the kernel on card 0 and
     within its tolerance of its plain version;
   - each of those five engine paths once more with ``telemetry=True``:
     W, losses and detect flags bitwise those of the run without, the
     protocol counters equal to those of the plain versions' run on the
     card and six of them to their sums over the recorded schedule; the
     counter totals, the efficiency report (``obs.report``) and the
     summed ``pipeline.stage`` / ``pipeline.dispatch`` /
     ``pipeline.drain`` span times beside post_scan printed; one
     ``obs.trace.profile_trace`` window around a fused run, whose Chrome
     trace (``chiprun_out/profile/``) must parse and name K2's kernel
     once per launch;
   - the single-vector ops (``ops.sketch``, ``ops.vote``,
     ``ops.coded_encode``) at the reference kernel bench's shapes:
     K4s, K3s, K5s;
   and small inputs on the card against the CPU run (gram, fused,
   unfused, per-problem, a filter batch);
   - serving: llama3.2-1b at full width, random init, through
     ``ServeEngine.generate`` (B = 4, a 4096-token prompt, 32 greedy
     tokens, audits with q_audit = 0.25): K6 in each of the 16 prefill
     layers, K4s twice per audit; the audit count and no failure; the
     same run with the plain versions (prefill logits, and each step's
     logits while the tokens agree, within 3e-2*(1+max|logits|); tokens
     under the margin rule); the plain versions fed the kernel run's
     tokens (teacher-forced), every step's logits of every row (128 of
     128) within the same tolerance; one ``serve.audit_decode`` span and
     one ``serve.audits`` increment per audit; a tampered
     replica caught; reduced llama3.2-1b and gemma3-1b in f32 on the
     card against the CPU;
   - training (``phase_train``): llama3.2-1b at full width, random
     init, bf16, trained by ``repro_torch.train.Trainer`` with n = 8
     workers, f = 2, sign_flip on workers 2 and 5 (every step), sequence
     256, global batch 16, AdamW, deterministic mode: K6 at the three
     per-worker shapes (2, 8 and 16 rows), K4s at every leaf size and K3
     at the vote's (1, 5, 268435456) against their plain versions,
     reruns bitwise; two honest workers' gradients and sketches bitwise
     equal; three ``train_step``s (check, vote eliminating both, fast
     steps) with K6 16 per worker forward, K4s 11 per check member and K3
     11 per vote counted against the protocol's assignments (K6 twice a
     layer and worker: every layer is checkpointed under ``cfg.remat``,
     so its backward runs the forward again; an MoE layer's recompute
     routes as its forward, ``RoutingTape``); a check step
     with a Byzantine member leaving params and AdamW state bitwise
     unchanged; an identify step's update bitwise the update from an
     honest replica's gradient; each step kind's wall and its split
     (forward, backward, sketch, vote, update), the card's busy share
     and its kernels by device time (one profiler window), K6's share,
     tokens/s, peak memory; the same three steps with the plain versions
     (control equal; the first loss, the later losses' drops and each
     leaf's update held relatively, the limits set from readings, and a
     planted control without the protocol, whose update takes the
     Byzantine gradients, caught by them); reduced llama3.2-1b in f32
     trained on the card against the CPU (control exact, 1e-4);
   - the training cell's workers as ranks of a ``torch.distributed``
     group over the ``data`` axis (``phase_train_ranks``, through
     ``launch.train.rank_main``): (a) one NCCL rank in this process at
     full width and depth, its history, parameters and AdamW state
     bitwise the one-process ``Trainer``'s and its K6 / K4s / K3
     launches the protocol's; (b) two gloo ranks sharing the card
     (operands staged through host memory), depth cut to 2 layers,
     against the one-process run of the cut model: decisions equal,
     step 0 (a faulty check, the identify update) bitwise by checksum,
     the fast steps within one rounding plus 2 lr a weight and 0.1 of
     the update a leaf (a run missing the last update caught), a check
     with a Byzantine member leaving every rank unchanged, every rank
     bitwise rank 0's (``Ranks.agree``; one planted ulp caught); (c)
     one NCCL rank a card where more than one is visible, the same
     checks at full depth and an all-reduce's bus bandwidth;
   - the training cells' workers split over a model axis
     (``phase_train_tp``, tensor and expert parallel): K4s's shard form
     at every split leaf's shard of llama3.2-1b, mamba2-780m (model 2)
     and jamba (model 4) in bf16, and ragged blocks with misaligned
     vector starts in bf16 and f32, against its plain version, reruns
     bitwise, bf16 bitwise its f32 cast, timed in bf16 and f32 beside
     ``index_add_``; K6 at a rank's heads and at a ragged head
     count (starcoder2-7b's rank of 5 heads at model 8) beside SDPA; (a)
     two gloo ranks sharing the card at model 2, 2 layers, for
     llama3.2-1b and for mamba2-780m (its mixer split by heads, the
     gated RMSNorm's squares summed over the ranks), each against the
     one-process run (control equal,
     losses within 1e-4, each leaf's update within 0.1 of the update,
     every rank's gathered parameters bitwise rank 0's, launches by
     model rank as the protocol's, a fast step counted on the card equal
     to the ``--mesh tp`` dry-run's FLOPs and bytes); (b) where more
     than one card is visible, one NCCL rank a card (llama3.2-1b at full
     depth, model 2 x W 2 and model 4; phi3.5-moe at one layer, model 4,
     routed as the one-process run, ``RoutingTape``; mamba2-780m at
     model 2 x W 2 and model 4, its updates held to its f32 one-process
     run: no farther than the one-process bf16 run plus 0.05, and its
     last fast update taken back caught), the same checks and a model
     all-reduce's bus bandwidth; jamba at 5 layers, model 4, which one
     process cannot hold, against its plain versions' split run;
   - the plain steps with FSDP + TP (``phase_train_fsdp``, ``FSDP``):
     llama3.2-1b at full width, 2 layers, two gloo ranks sharing the
     card at data 2 x model 1 (``train.pjit_step`` on a
     ``train.ranks.StepMesh``): two AdamW train steps on each rank's 8
     of 16 rows, a prefill and four decode steps teacher-forced by the
     one-process run's tokens, against the one-process run from the
     same initial parameters (losses within 1e-4, each leaf's update
     within 0.1 of the update, logits within 3e-2 * (1 + max|logits|),
     every rank's gathered parameters bitwise rank 0's), K6's launches
     (twice a layer a train step, once a layer in the prefill), rank
     0's first step counted on the card equal to the dry-run's meta
     trace of the same rank (FLOPs, bytes, collectives by axis) and
     each rank's allocator peak within 1% of it; K6 at a rank's shape
     beside SDPA; ``scripts/chip_phases.py fsdp`` runs ``FSDP_CARDS``
     on four cards (its bf16 llama and phi 2 x 2 cells held to their
     float32 one-process run, ``FSDP_ANCHORED``);
   - ``long_500k``'s decode (``phase_long_decode``, ``LONG_DECODE``):
     gemma3-1b at full width, two gloo ranks sharing the card at data
     2, batch 1 on both, each holding half of a 524,288-position KV
     cache filled from the seed (keys scaled so that a softmax over
     them is peaked), three greedy steps across the block boundary fed
     the one-process run's tokens, against the one-process decode on
     the same cache (logits within 3e-2 * (1 + max|logits|), tokens
     held, ranks bitwise), a global layers' combine that leaves out
     rank 0's P.V partial as the planted control (it must fail),
     rank 0's first step counted on the card equal to the dry-run's
     meta trace at the same position and each rank's peak within 1%
     of it; ``scripts/chip_phases.py long`` runs ``LONG_CARDS`` on four
     cards;
   - the launch tools (``phase_dryrun``, ``DRYRUN``): llama3.2-1b's
     plain train (16 x 256, AdamW), prefill (4 x 4096) and decode (one
     token against a 4 x 4128 cache) steps at full width, each traced
     by the dry-run on meta tensors and then run on the card under the
     same counter: FLOPs, bytes accessed and argument bytes equal
     exactly, K6's launches its counted calls, the measured peak within
     ``DRYRUN_PEAK_REL`` of the prediction; the warm wall beside the
     roofline and the MFU; the BFT steps' bounds at 16 x 256 beside
     ``phase_train``'s walls; ``memprobe`` at one layer in bf16 and f32;
   - serving mamba2-780m (``phase_serving_replayed(MAMBA_SERVE)``): at
     full width,
     random init, bf16, through ``ServeEngine.generate`` (B = 4, a
     512-token prompt, two SSD chunks, replayed through decode to fill
     the SSM cache, 32 greedy tokens, q_audit = 0.25): K4s twice per
     audit and no other kernel; the audit count equal to the coins, no
     failure, one ``serve.audit_decode`` span and one ``serve.audits``
     increment per audit; the chunked prefill's last logits against the
     replay's; a decode step run twice on one cache, bitwise, its input
     cache unchanged; one decode step's kernels, busy time and byte
     bound (one profiler window); a tampered replica caught; K4s at the
     audit's 4 x 50280 against its plain version; reduced mamba2-780m in
     f32 on the card against the CPU (logits and cache 1e-4, tokens
     equal);
   - training mamba2-780m (``phase_train`` with ``MAMBA_TRAIN``): the
     checks of llama3.2-1b's training at its global batch 16, 24 of the
     48 layers (no K6; K4s 16 per check member, K3 16 per vote);
   - serving phi3.5-moe-42b-a6.6b (``phase_serving(MOE_SERVE)``): at
     full width, 16 of its 32 layers, the llama cell's traffic and
     checks (K6 at its prefill shape, the qwen3-4b one, hd 128), plus
     the prefill's dropped share of the top-2 choices (C = 2560 at
     N = 16384), a decode step run twice on one cache bitwise and
     profiled against its byte bound (every expert read), K4s at the
     audit's 4 x 32064 and reduced phi3.5-moe in f32 card vs CPU (the
     llama cell gets the replay and profile checks too);
   - training phi3.5-moe (``phase_train`` with ``MOE_TRAIN``): full
     width, one layer, the checks of llama3.2-1b's training (K4s 13 per
     check member, K3 13 per vote, at (1, 5, 419430400));
   - serving jamba-v0.1-52b (``phase_serving_replayed(HYBRID_SERVE)``):
     full width, 8 of its 32 layers (one attention period), the mamba
     cell's traffic and checks, K6 once in the prefill; the chunked
     prefill at a capacity that drops nothing against the replay (the
     config's own, which drops, beside it, not held); one training step
     of reduced jamba in f32 card vs CPU;
   - serving with a context (``phase_serving_ctx``): whisper-tiny at
     full size (``WHISPER_SERVE``: B = 4, ctx (4, 1500, 384), a 128-token
     prompt, 32 tokens, q_audit 0.25) and llama-3.2-vision-90b at full
     width, 10 of its 100 layers (``VISION_SERVE``: the mamba cell's
     traffic, ctx (4, 1601, 8192)), the cross-attention gates at
     ``CTX_GATE``; the prompt replayed through decode over the zero
     cross caches, as the reference's engine does: the audits, K6 at
     each prefill shape (whisper's encoder, decoder self- and
     cross-attention; vision's self- and cross-attention) counted by
     shape, K4s twice an audit, spans and counters; the prefill's logits
     with the kernels against the plain versions (3e-2 (1 + max|.|)) and
     moved beyond that by the context (``context_shifted``; a second
     i.i.d. draw's move printed), the tokens the same under that draw;
     the plain versions fed the kernel run's tokens; a decode step
     replayed bitwise, the cross caches left zero, the step profiled;
     a tampered replica caught; K6 at each shape and K4s at the
     audit's against their plain versions with times, SDPA and bounds;
     peak memory; reduced whisper-tiny and vision in f32 card vs CPU;
4. a ``{"kernels": [...]}`` line;
5. the last line, ``{"ok": true, "device": {...}}``.

A copy of the report goes to ``chiprun_out/chip_smoke.json``.  The
script imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"


GRAM_SWEEP = dict(B=32, T=120, n_data=64, d=1 << 20)
# benchmarks/bench_protocol.py:304-331 with its default knobs; the plan
# cuts it into chunks of 64 trials
FUSED_SWEEP = dict(B=256, T=3, n_data=64, d=1 << 20)
FUSED_CHUNK = 64
# benchmarks/bench_protocol.py:627-652 (adaptive_sweep) with its default
# knobs: adaptive q*_t, sign_flip, the device control plane; the same
# trials once more at the production d of gram_sweep and fused_sweep
ADAPTIVE_SWEEP = dict(B=256, T=24, n_data=64, d=1 << 13)
ADAPTIVE_D_FULL = 1 << 20
# per-trial problems: fused_sweep's trials over 4 problems; B = 8, where
# the reference's host-staged (B, n_data, d) f32 data is 2 GiB (the port
# gathers each chunk's rows on the card by problem index)
PER_PROBLEM = dict(B=8, T=3, n_data=64, d=1 << 20, problems=4)
# the "oracle" schedule at production d: the numpy engine's host replay
# holds a (B, 8, d) f64 gradient stack (256 MiB at B = 4) and reads the
# (64, d) f64 problem twice a trial and step, about 4.5 s a trial on the
# card's host; B = 2 in chunks of 1 (two chunks through the pipeline;
# cut from 8 in chunks of 4, then 4 in chunks of 2, to keep the script
# inside its time limit beside the model axis's phase), the plain
# versions replay the first ORACLE_PLAIN_FULL trials
ORACLE_B_FULL = 2
ORACLE_CHUNK_FULL = 1
ORACLE_PLAIN_FULL = 2
# the plain versions' run of adaptive_sweep under "oracle" at d = 2^13
# takes the first 64 of the 256 trials (its replay is the cost)
ORACLE_PLAIN_13 = 64
# K1's sketch tables at ragged shapes (Ie, d, T, k): k = 96 and 512, one
# key, one row, d < k, more keys (128) and rows (72) than one block takes
K1_RAGGED = [(5, 70001, 3, 96), (7, 30001, 130, 512), (66, 5000, 1, 256),
             (1, 9000, 4, 256), (4, 100, 3, 256), (80, 3001, 2, 256)]
# K4s's single vectors: the edges of one slab, and the serving audit's
# 4 x 128256 logits
K4S_D = [1, 255, 256, 257, 513_024]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(torch, fn, reps: int = 10, warm: int = 2,
              launches: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings, after warm-up, of
    ``launches`` back-to-back calls of ``fn`` divided by ``launches``
    (for a small kernel the host's time between two events is more than
    one launch's device time: the guides' rule is many launches)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def device_ms(torch, fn, kernel: str | None, calls: int = 20):
    """The card's time per call of ``fn`` from ``torch.profiler``: the
    CUDA kernels whose name holds ``kernel`` (every kernel of the call
    when None, for a library call whose kernel name is its own), summed
    over ``calls``; None if the profiler recorded no such time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if getattr(e, "device_type", None) == DeviceType.CUDA
             and e.name != "Activity Buffer Request"    # the profiler's own
             and (kernel is None or kernel in e.name))
    return us / 1e3 / calls if us > 0 else None


def cuda_kernel_events(prof) -> list:
    """(name, µs) of each CUDA event a finished ``torch.profiler`` window
    recorded, the profiler's own buffer requests left out, from the raw
    Kineto events (``prof.events()`` would build a Python object for
    every event, about a quarter of a millisecond each)."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and e.name() != "Activity Buffer Request"]


def kernel_times(torch, fn) -> dict:
    """{kernel name: (ms, launches)} of one call of ``fn`` (after one
    warm call), from one ``torch.profiler`` window over the card's
    activity alone (a window that also records the host's operators
    takes seconds for every ten thousand kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for name, us in cuda_kernel_events(prof):
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + us / 1e3, n + 1)
    return out


def sass_counts(name: str, kernel: str) -> dict:
    """Tensor-core and FMA instructions in ``kernel``'s SASS, from
    ``cuobjdump -sass`` of the built library ``name``."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-400:]}")
    import re

    counts, inside = {"HMMA": 0, "HGMMA": 0, "FFMA": 0}, False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line) if inside else None
        if m:
            ops = [t for t in m.group(1).split() if not t.startswith("@")]
            op = ops[0].split(".")[0] if ops else ""
            if op in counts:
                counts[op] += 1
    return counts


def kernel_names(torch, fn, calls: int = 50) -> dict:
    """{kernel name: launches} of the CUDA kernels ``calls`` calls of
    ``fn`` run, from one ``torch.profiler`` window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names: dict = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA and \
                e.name != "Activity Buffer Request":   # the profiler's own
            names[e.name] = names.get(e.name, 0) + 1
    return names


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def close(a, b, rtol: float, atol: float) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def tile_rel_err(got, want, rows: int = 64) -> float:
    """The largest ||got - want|| / ||want|| (Frobenius) over blocks of
    ``rows`` query rows of (B, S, H, hd) outputs, all batches and heads
    of a block together: a limit scaled to the data, so a fault in one
    query tile shows even where the outputs are small (the late rows of
    a long causal sequence average thousands of values)."""
    d, w = (got.float() - want.float()), want.float()
    worst = 0.0
    for r0 in range(0, got.shape[1], rows):
        den = float(w[:, r0:r0 + rows].norm())
        num = float(d[:, r0:r0 + rows].norm())
        worst = max(worst, num / den if den > 0 else num)
    return worst


def rel_err(a, b) -> float:
    """max|a - b| / max(1, max|b|): the check for sums whose terms
    cancel (products over long d)."""
    return max_err(a, b) / max(1.0, float(b.abs().max())) if b.numel() \
        else 0.0


def roofline():
    """The port's roofline (``repro_torch.launch.roofline``): the card's
    constants (H100 SXM data sheet, 700 W) and each kernel's cost."""
    from repro_torch.launch import roofline as RL

    return RL


def kernel_bound(name: str, **dims) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations") of one call of kernel
    ``name`` at ``dims`` (``roofline.kernel_cost``)."""
    return roofline().kernel_bound_ms(name, **dims)


def entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by,
          library_ms):
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{source}",
                replaces=replaces, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}  count={torch.cuda.device_count()}  "
          f"torch {torch.__version__}  cuda {torch.version.cuda}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    took = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s for {sorted(took)} "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.stem}: {line.strip()}")
    return card_line, name, build_s


def phase_kernels(torch):
    """Each kernel against its plain version on the card."""
    import numpy as np

    from repro_torch.kernels import gram as gm
    from repro_torch.kernels import majority_vote as mv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows_of = lambda *shape: torch.randn(*shape, generator=gen,   # noqa: E731
                                         device=dev)
    report = {}

    # -- K1: gram factors ---------------------------------------------------
    T, Ie, d, k = GRAM_SWEEP["T"], GRAM_SWEEP["n_data"] + 2, \
        GRAM_SWEEP["d"], 256
    keys = np.uint32(0x9E3779B9) * (np.arange(T, dtype=np.uint32) + 1)
    rows = rows_of(Ie, d)
    _, _, sk_k = gm.gram_factors_cuda(rows, None, keys, with_gram=False)
    _, _, sk_p = gm.gram_factors_plain(rows, None, keys, with_gram=False)
    torch.cuda.synchronize()
    err_sk = max_err(sk_k, sk_p)
    worst = float(((sk_k - sk_p).abs() / (1e-3 + 2e-5 * sk_p.abs())).max())
    print(f"K1 gram SK (T={T}, Ie={Ie}, d=2^20): max|kernel-plain| = "
          f"{err_sk:.3e} (tolerance: atol 1e-3 + rtol 2e-5; the worst "
          f"element at {worst:.3f} of its tolerance)")
    check(close(sk_k, sk_p, 2e-5, 1e-3), "K1 sketch tables disagree")
    again = gm.gram_factors_cuda(rows, None, keys, with_gram=False)[2]
    check(bool(torch.equal(sk_k, again)), "K1 reruns differ at the main "
                                          "shape")
    print("K1 gram SK: rerun bitwise equal at the main shape")
    del again
    G_k, _, _ = gm.gram_factors_cuda(rows, None, keys[:1])
    G_p, _, _ = gm.gram_factors_plain(rows, None, keys[:1])
    err_g = max_err(G_k, G_p) / float(G_p.abs().max())
    print(f"K1 gram G (Ie={Ie}, d=2^20): max|kernel-plain|/max|plain| = "
          f"{err_g:.3e} (tolerance 1e-4)")
    check(err_g <= 1e-4, "K1 G disagrees")
    for (Ie_r, d_r, T_r, B_r) in ((10, 70001, 5, 3), (3, 255, 2, 1)):
        keys_r = np.uint32(0x9E3779B9) * (np.arange(T_r, dtype=np.uint32) + 1)
        R_r, W_r = rows_of(Ie_r, d_r), rows_of(B_r, d_r)
        out_k = gm.gram_factors_cuda(R_r, W_r, keys_r)
        out_p = gm.gram_factors_plain(R_r, W_r, keys_r)
        for nm, a, b in zip(("G", "S0", "SK"), out_k, out_p):
            if nm == "SK":
                ok, err = close(a, b, 2e-5, 1e-3), max_err(a, b)
            else:
                err = max_err(a, b) / float(b.abs().max())
                ok = err <= 1e-4
            print(f"K1 ragged (Ie={Ie_r}, d={d_r}, T={T_r}, W0 ({B_r}, d)) "
                  f"{nm}: err {err:.3e}")
            check(ok, f"K1 ragged {nm} disagrees")
    # the sketch tables alone at ragged shapes: other k, one key, one row,
    # d < k, more keys and rows than one block takes
    for (Ie_r, d_r, T_r, k_r) in K1_RAGGED:
        keys_r = np.uint32(0x9E3779B9) * (np.arange(T_r, dtype=np.uint32) + 1)
        R_r = rows_of(Ie_r, d_r)
        a = gm.gram_factors_cuda(R_r, None, keys_r, k_r, with_gram=False)[2]
        b = gm.gram_factors_plain(R_r, None, keys_r, k_r, with_gram=False)[2]
        torch.cuda.synchronize()
        print(f"K1 ragged SK (Ie={Ie_r}, d={d_r}, T={T_r}, k={k_r}): err "
              f"{max_err(a, b):.3e}")
        check(close(a, b, 2e-5, 1e-3), f"K1 ragged SK disagrees at "
                                       f"{(Ie_r, d_r, T_r, k_r)}")

    call = lambda: gm.gram_factors_cuda(rows, None, keys,   # noqa: E731
                                        with_gram=False)
    ms = median_ms(torch, call)
    dev_ms = device_ms(torch, call, "sketch_tables_kernel", calls=10)
    plain_ms = median_ms(torch, lambda: gm.gram_factors_plain(
        rows, None, keys, with_gram=False), reps=10, warm=1)
    # library yardstick: one einsum over a precomputed sign table (the
    # reference's XLA fallback); the port never calls it
    from repro_torch.kernels import ref as _ref

    idx = torch.arange(d, device=dev)
    kt = torch.from_numpy(keys.astype(np.int64)).to(dev)
    signs = _ref.hash_signs_ref(idx[None, :], kt[:, None]).reshape(T, -1, k)
    g3 = rows.reshape(Ie, -1, k)
    library_ms = median_ms(torch, lambda: torch.einsum("imb,tmb->tib",
                                                        g3, signs))
    del signs, g3
    # R read once and SK written once, against three bf16 tensor-core
    # passes of 2 T Ie d operations; the CUDA-core bound of the f32
    # kernel it replaced (T Ie d signed adds at 33.5e12 a second) beside it
    b_ms, b_by = kernel_bound("gram_factors", Ie=Ie, d=d, T=T, k=k)
    core_ms = T * Ie * d / roofline().F32_ADDS_S * 1e3
    report["gram_factors"] = entry(
        "gram_factors", "gram.cu", "src/repro/kernels/gram.py:45", err_sk,
        ms, plain_ms, b_ms, b_by, library_ms)
    report["gram_factors"].update(device_ms=dev_ms,
                                  cuda_core_bound_ms=core_ms,
                                  sass=sass_counts("gram",
                                                   "sketch_tables_kernel"))
    check(report["gram_factors"]["sass"]["HGMMA"]
          + report["gram_factors"]["sass"]["HMMA"] > 0,
          "K1's sketch tables run no tensor-core instruction")
    print(f"K1 gram SK: kernel_ms={ms:.4f} (sketch_tables_kernel, profiler: "
          f"{fmt_ms(dev_ms)}) plain_ms={plain_ms:.4f} library_ms="
          f"{library_ms:.4f} bound_ms={b_ms:.4f} ({b_by}), {b_ms / ms:.1%} "
          f"of bound; the f32 CUDA-core bound {core_ms:.4f} "
          f"({core_ms / ms:.1%}); SASS of sketch_tables_kernel: "
          f"{report['gram_factors']['sass']}")
    del rows, sk_k, sk_p

    # -- K3: batched pairwise relmax ----------------------------------------
    main_shape = (GRAM_SWEEP["B"], 8, 256)
    x_main = None
    for shape in (main_shape, (32, 5, 65536), (7, 3, 70001)):
        x = rows_of(*shape)
        x[:, 1] = x[:, 0]                     # a planted agreeing pair
        rk = mv.pairwise_relmax_batched_cuda(x)
        rp = mv.pairwise_relmax_batched_plain(x)
        torch.cuda.synchronize()
        err = max_err(rk, rp)
        print(f"K3 relmax {shape}: max|kernel-plain| = {err:.3e} "
              f"(tolerance: rtol 1e-6)")
        check(close(rk, rp, 1e-6, 0.0), f"K3 disagrees at {shape}")
        check(bool((rk[:, 0, 1] == 0).all()), "K3 planted pair not 0")
        if shape == main_shape:
            x_main, err_main = x, err
    # 50 back-to-back calls an event pair: one call's device time is
    # less than the host's call
    ms = median_ms(torch, lambda: mv.pairwise_relmax_batched_cuda(x_main),
                   reps=20, launches=50)
    plain_ms = median_ms(torch, lambda: mv.pairwise_relmax_batched_plain(
        x_main), reps=20, launches=50)
    dev_ms = device_ms(torch, lambda: mv.pairwise_relmax_batched_cuda(
        x_main), "relmax_kernel", calls=50)
    B, R, dd = main_shape
    # one f32 division per element and pair
    b_ms, b_by = kernel_bound("pairwise_relmax_batched", B=B, R=R, d=dd)
    report["pairwise_relmax_batched"] = entry(
        "pairwise_relmax_batched", "majority_vote.cu",
        "src/repro/kernels/majority_vote.py:63", err_main, ms, plain_ms,
        b_ms, b_by, None)
    report["pairwise_relmax_batched"]["device_ms"] = dev_ms
    print(f"K3 relmax {main_shape}: call ms (50 calls / 50): kernel "
          f"{ms:.4f}, plain {plain_ms:.4f}; device ms (profiler): "
          f"relmax_kernel {fmt_ms(dev_ms)}; bound_ms={b_ms:.6f} ({b_by})")
    return report


def sign_table(torch, d: int, key: int, dev):
    """The (d,) ±1 signs of one key (the library yardsticks' operand)."""
    from repro_torch.kernels import ref as _ref

    return _ref.hash_signs_ref(torch.arange(d, device=dev), key)


def phase_stream_kernels(torch):
    """K2, K4, K5 and the single forms K3s, K4s, K5s against their plain
    versions on the card: the main paths' shapes, ragged shapes (d not a
    multiple of k or of the tile, Ie not a multiple of 8, B = 1)."""
    from repro_torch.kernels import coded_encode as enc
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import majority_vote as mv
    from repro_torch.kernels import sketch as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rand = lambda *shape: torch.randn(*shape, generator=gen,     # noqa: E731
                                      device=dev)
    report = {}
    k, key = 256, 0x9E3779B9

    # -- K2: fused step ---------------------------------------------------
    def k2_check(B, Ie, d, dtype):
        rows = rand(Ie, d)
        if dtype == "bf16":
            rows = rows.to(torch.bfloat16)
        W, cw = rand(B, d), rand(B, Ie) * 0.01
        cw[0] = 0.0                                  # a dead trial's row
        W0 = W.clone()
        want = fs.fused_step_plain(rows, W0, cw, key)
        got = fs.fused_step_cuda(rows, W, cw, key)
        torch.cuda.synchronize()
        errs = [max_err(a, b) for a, b in zip(got, want)]
        ok = (rel_err(got[0], want[0]) <= 1e-5
              and rel_err(got[1], want[1]) <= 1e-5
              and close(got[2], want[2], 2e-5, 1e-3)
              and bool(torch.equal(got[0][0], W0[0])))
        print(f"K2 fused_step {dtype} (B={B}, Ie={Ie}, d={d}): max|kernel-"
              f"plain| W' {errs[0]:.3e} resid {errs[1]:.3e} sk {errs[2]:.3e}"
              f" (tolerance: 1e-5 of max|.| for W' and resid, rtol 2e-5 + "
              f"atol 1e-3 for sk; zero cw row keeps W bitwise)")
        check(ok, f"K2 {dtype} disagrees at {(B, Ie, d)}")
        return max(errs), rows, W, cw

    B2, Ie2, d2 = FUSED_CHUNK, FUSED_SWEEP["n_data"] + 2, FUSED_SWEEP["d"]
    for shape in ((1, 3, 300), (70, 13, 70001), (5, 258, 2000)):
        for dtype in ("f32", "bf16"):
            k2_check(*shape, dtype)
    k2_check(B2, Ie2, d2, "bf16")
    err2, rows, W, cw = k2_check(B2, Ie2, d2, "f32")
    runs = [fs.fused_step_cuda(rows, W.clone(), cw, key) for _ in range(2)]
    check(all(bool(torch.equal(a, b)) for a, b in zip(*runs)),
          "K2 reruns differ at the main shape")
    del runs
    ms = median_ms(torch, lambda: fs.fused_step_cuda(rows, W, cw, key))
    plain_ms = median_ms(torch, lambda: fs.fused_step_plain(rows, W, cw, key))
    rows_bf = rows.to(torch.bfloat16)
    ms_bf = median_ms(torch, lambda: fs.fused_step_cuda(rows_bf, W, cw, key))
    dev_k2 = {}                          # the kernel and its span sum
    for label, r in (("f32", rows), ("bf16", rows_bf)):
        for kern in ("fused_step_kernel", "span_sum_kernel"):
            dev_k2[f"{label} {kern}"] = device_ms(
                torch, lambda: fs.fused_step_cuda(r, W, cw, key), kern,
                calls=10)
    b_ms, b_by = kernel_bound("fused_step", Ie=Ie2, B=B2, d=d2, k=k)
    report["fused_step"] = entry(
        "fused_step", "fused_step.cu", "src/repro/kernels/fused_step.py:50",
        err2, ms, plain_ms, b_ms, b_by, None)
    report["fused_step"].update(bf16_ms=ms_bf, device_ms=dev_k2)
    print(f"K2 fused_step (B={B2}, Ie={Ie2}, d=2^20): kernel_ms={ms:.4f} "
          f"(bf16 rows: {ms_bf:.4f}) plain_ms={plain_ms:.4f} bound_ms="
          f"{b_ms:.4f} ({b_by}), {b_ms / ms:.1%} of bound (bf16 rows "
          f"{b_ms / ms_bf:.1%}); device ms (profiler): "
          + ", ".join(f"{k} {fmt_ms(v)}" for k, v in dev_k2.items())
          + "; library: none (no single PyTorch call fuses the update, the "
          "residual and the sketch)")
    del rows, rows_bf, W, cw

    # -- K4 and K4s: CountSketch -------------------------------------------
    def k4_check(B, d):
        g = rand(B, d)
        got, want = sk.sketch_batched_cuda(g, key), \
            sk.sketch_batched_plain(g, key)
        torch.cuda.synchronize()
        print(f"K4 sketch_batched (B={B}, d={d}): max|kernel-plain| = "
              f"{max_err(got, want):.3e} (tolerance: rtol 2e-5 + atol 1e-3)")
        check(close(got, want, 2e-5, 1e-3), f"K4 disagrees at {(B, d)}")
        return max_err(got, want), g

    for shape in ((1, 255), (9, 70001),
                  (PER_PROBLEM["problems"] * PER_PROBLEM["n_data"] + 2,
                   PER_PROBLEM["d"])):
        k4_check(*shape)
    B4, d4 = FUSED_SWEEP["n_data"] + 2, FUSED_SWEEP["d"]
    err4, g = k4_check(B4, d4)
    ms = median_ms(torch, lambda: sk.sketch_batched_cuda(g, key))
    plain_ms = median_ms(torch, lambda: sk.sketch_batched_plain(g, key))
    signs = sign_table(torch, d4, key, dev).reshape(-1, k)
    g3 = g.reshape(B4, -1, k)
    library_ms = median_ms(torch, lambda: torch.einsum("bmk,mk->bk", g3,
                                                       signs))
    b_ms, b_by = kernel_bound("sketch_batched", B=B4, d=d4, k=k)
    report["sketch_batched"] = entry(
        "sketch_batched", "sketch.cu", "src/repro/kernels/sketch.py:77",
        err4, ms, plain_ms, b_ms, b_by, library_ms)
    print(f"K4 sketch_batched (B={B4}, d=2^20): kernel_ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} library_ms={library_ms:.4f} (einsum over a sign "
          f"table) bound_ms={b_ms:.4f} ({b_by})")
    gp = rand(PER_PROBLEM["problems"] * PER_PROBLEM["n_data"] + 2,
              PER_PROBLEM["d"])
    ms_pp = median_ms(torch, lambda: sk.sketch_batched_cuda(gp, key))
    print(f"K4 sketch_batched (B={gp.shape[0]}, d=2^20, the per-problem "
          f"rows): kernel_ms={ms_pp:.4f} bound_ms="
          f"{gp.numel() * 4 / roofline().HBM_BYTES_S * 1e3:.4f} (bytes)")
    del g, g3, gp

    d4s = 1_000_000                      # bench_kernels.py's single sketch
    x = rand(d4s)
    got, want = sk.sketch_cuda(x, 7), sk.sketch_plain(x, 7)
    err = max_err(got, want)
    print(f"K4s sketch (d={d4s}): max|kernel-plain| = {err:.3e} "
          f"(tolerance: rtol 2e-5 + atol 1e-3)")
    check(close(got, want, 2e-5, 1e-3), "K4s disagrees")
    check(bool(torch.equal(got, sk.sketch_cuda(x, 7))),
          "K4s reruns differ at d = 1e6")
    for d_r in (*K4S_D, 70001):
        xr = rand(d_r)
        a_r, b_r = sk.sketch_cuda(xr, 7), sk.sketch_plain(xr, 7)
        check(close(a_r, b_r, 2e-5, 1e-3), f"K4s disagrees at d={d_r}")
        check(bool(torch.equal(a_r, sk.sketch_cuda(xr, 7))),
              f"K4s reruns differ at d={d_r}")
        print(f"K4s sketch (d={d_r}): max|kernel-plain| = "
              f"{max_err(a_r, b_r):.3e}; rerun bitwise equal")
    # one profiler window of 50 calls: the kernels each call launches
    names = kernel_names(torch, lambda: sk.sketch_cuda(x, 7), calls=50)
    print(f"K4s sketch: kernels launched in 50 calls: {names}")
    check(sum(names.values()) == 50 and all("sketch_single_kernel" in n
                                            for n in names),
          "K4s is not one launch per call")
    k4s = {}
    x_audit = rand(K4S_D[-1])
    for label, v in (("d=1e6", x), (f"d={K4S_D[-1]}", x_audit)):
        fn = lambda: sk.sketch_cuda(v, 7)          # noqa: E731
        k4s[label] = dict(
            ms=median_ms(torch, fn, launches=50),
            device_ms=device_ms(torch, fn, None, calls=50),
            bound_ms=kernel_bound("sketch", d=v.numel(), k=k)[0])
    ms, dev_ms = k4s["d=1e6"]["ms"], k4s["d=1e6"]["device_ms"]
    plain_ms = median_ms(torch, lambda: sk.sketch_plain(x, 7), launches=50)
    xs_ = torch.nn.functional.pad(x, (0, (-d4s) % k)).reshape(-1, k)
    signs = sign_table(torch, xs_.numel(), 7, dev).reshape(-1, k)
    library_ms = median_ms(torch, lambda: torch.einsum("mk,mk->k", xs_,
                                                       signs), launches=50)
    b_ms, b_by = kernel_bound("sketch", d=d4s, k=k)
    report["sketch"] = entry("sketch", "sketch.cu",
                             "src/repro/kernels/sketch.py:25", err, ms,
                             plain_ms, b_ms, b_by, library_ms)
    report["sketch"].update(device_ms=dev_ms, shapes=k4s)
    print(f"K4s sketch: call ms (50 calls / 50) at d=1e6: kernel {ms:.4f}, "
          f"plain {plain_ms:.4f}, einsum {library_ms:.4f}; device ms "
          f"(profiler, every kernel of the call) {fmt_ms(dev_ms)}; bound_ms="
          f"{b_ms:.5f} ({b_by}); at d={K4S_D[-1]} (the serving audit): call "
          f"{k4s[f'd={K4S_D[-1]}']['ms']:.4f}, device "
          f"{fmt_ms(k4s[f'd={K4S_D[-1]}']['device_ms'])}")
    check(ms < library_ms, "K4s is slower than its einsum at d = 1e6")
    del x, xs_, signs, x_audit

    # -- K5 and K5s: linear encode -----------------------------------------
    def k5_check(B, n_sym, m, d):
        c, g = rand(B, n_sym, m), rand(B, m, d)
        got = enc.coded_encode_batched_cuda(c, g)
        want = enc.coded_encode_batched_plain(c, g)
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"K5 coded_encode_batched (B={B}, n_sym={n_sym}, m={m}, "
              f"d={d}): max|kernel-plain| = {err:.3e} (tolerance 1e-5 of "
              f"max|plain|)")
        check(rel_err(got, want) <= 1e-5, f"K5 disagrees at {(B, n_sym, m, d)}")
        return err, c, g

    for shape in ((1, 3, 5, 255), (2, 9, 7, 70001)):
        k5_check(*shape)
    B5, m5, d5 = PER_PROBLEM["B"], PER_PROBLEM["n_data"], PER_PROBLEM["d"]
    err5, c, g = k5_check(B5, 1, m5, d5)
    ms = median_ms(torch, lambda: enc.coded_encode_batched_cuda(c, g))
    plain_ms = median_ms(torch, lambda: enc.coded_encode_batched_plain(c, g))
    library_ms = median_ms(torch, lambda: torch.bmm(c, g))
    b_ms, b_by = kernel_bound("coded_encode_batched", B=B5, n_sym=1, m=m5,
                              d=d5)
    report["coded_encode_batched"] = entry(
        "coded_encode_batched", "coded_encode.cu",
        "src/repro/kernels/coded_encode.py:51", err5, ms, plain_ms, b_ms,
        b_by, library_ms)
    print(f"K5 coded_encode_batched (8,1,64)@(8,64,2^20): kernel_ms={ms:.4f}"
          f" plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (bmm) "
          f"bound_ms={b_ms:.4f} ({b_by})")
    del c, g

    C, G = rand(4, 4), rand(4, 200_000)  # bench_kernels.py's single encode
    got, want = enc.coded_encode_cuda(C, G), enc.coded_encode_plain(C, G)
    err = max_err(got, want)
    check(rel_err(got, want) <= 1e-5, "K5s disagrees")
    check(rel_err(enc.coded_encode_cuda(C[:3, :3], G[:3, :70001]),
                  enc.coded_encode_plain(C[:3, :3], G[:3, :70001])) <= 1e-5,
          "K5s disagrees at a ragged shape")
    G_r = rand(4, 200_001)               # rows not 16-byte aligned
    check(rel_err(enc.coded_encode_cuda(C, G_r),
                  enc.coded_encode_plain(C, G_r)) <= 1e-5,
          "K5s disagrees at d = 200001")
    del G_r
    ms = median_ms(torch, lambda: enc.coded_encode_cuda(C, G), launches=50)
    plain_ms = median_ms(torch, lambda: enc.coded_encode_plain(C, G),
                         launches=50)
    library_ms = median_ms(torch, lambda: C @ G, launches=50)
    dev_ms = device_ms(torch, lambda: enc.coded_encode_cuda(C, G),
                       "encode_kernel")
    lib_dev_ms = device_ms(torch, lambda: C @ G, None)
    b_ms, b_by = kernel_bound("coded_encode", n_sym=4, m=4, d=200_000)
    report["coded_encode"] = entry(
        "coded_encode", "coded_encode.cu",
        "src/repro/kernels/coded_encode.py:21", err, ms, plain_ms, b_ms, b_by,
        library_ms)
    report["coded_encode"].update(device_ms=dev_ms,
                                  library_device_ms=lib_dev_ms)
    print(f"K5s coded_encode (4,4)@(4,2e5): max|kernel-plain| = {err:.3e}; "
          f"call ms (50 calls / 50): kernel {ms:.4f}, plain {plain_ms:.4f}, "
          f"C @ G {library_ms:.4f}; device ms (profiler): encode_kernel "
          f"{fmt_ms(dev_ms)}, C @ G's kernels {fmt_ms(lib_dev_ms)}; bound_ms="
          f"{b_ms:.5f} ({b_by})")

    # -- K3s: single pairwise relmax ---------------------------------------
    R3, d3 = 7, 100_000                  # bench_kernels.py's single vote
    x = rand(R3, d3)
    x[1] = x[0]
    got, want = mv.pairwise_relmax_cuda(x), mv.pairwise_relmax_plain(x)
    err = max_err(got, want)
    check(close(got, want, 1e-6, 0.0) and float(got[0, 1]) == 0.0,
          "K3s disagrees")
    check(close(mv.pairwise_relmax_cuda(x[:3, :255]),
                mv.pairwise_relmax_plain(x[:3, :255]), 1e-6, 0.0),
          "K3s disagrees at a ragged shape")
    ms = median_ms(torch, lambda: mv.pairwise_relmax_cuda(x), launches=50)
    plain_ms = median_ms(torch, lambda: mv.pairwise_relmax_plain(x),
                         launches=50)
    dev_ms = device_ms(torch, lambda: mv.pairwise_relmax_cuda(x),
                       "relmax_kernel", calls=50)
    b_ms, b_by = kernel_bound("pairwise_relmax", R=R3, d=d3)
    report["pairwise_relmax"] = entry(
        "pairwise_relmax", "majority_vote.cu",
        "src/repro/kernels/majority_vote.py:30", err, ms, plain_ms, b_ms,
        b_by, None)
    report["pairwise_relmax"]["device_ms"] = dev_ms
    print(f"K3s pairwise_relmax (R={R3}, d={d3}): max|kernel-plain| = "
          f"{err:.3e}; call ms (50 calls / 50): kernel {ms:.4f}, plain "
          f"{plain_ms:.4f}; device ms (profiler): relmax_kernel "
          f"{fmt_ms(dev_ms)}; bound_ms={b_ms:.5f} ({b_by})")
    return report


def counted(fn):
    """Run ``fn`` with every launch count set to 0 just before; return
    its result and the counts read just after."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = fn()
    return out, ops.launch_counts()


def require_launched(launches, names, path):
    print(f"{path} launches: {launches}")
    for name in names:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {path} path")


def gram_sweep_specs(TrialSpec, B, T, n_data, d):
    return [TrialSpec(byz=(2, 5), attack="drift", q=0.2, steps=T, seed=s,
                      n_data=n_data, d=d, lr=float(n_data) / d,
                      label=f"gram_sweep/s{s}") for s in range(B)]


def same_control(a, b) -> bool:
    """Identify steps, efficiency, q-trace, detect flags and schedule
    arrays equal; ``b`` may hold the first trials of ``a``'s batch only
    (its run on ``a``'s first specs)."""
    nb = b.detect_flags.shape[1]
    if not all(ra.identify_step == rb.identify_step
               and ra.efficiency == rb.efficiency
               and ra.q_trace == rb.q_trace for ra, rb in zip(a, b)):
        return False
    if not (a.detect_flags[:, :nb] == b.detect_flags).all():
        return False
    return all((v[:, :nb] == b.schedule.arrays[key]).all()
               for key, v in a.schedule.arrays.items())


def w_close(a, b) -> tuple[float, float]:
    import numpy as np

    Wb = np.stack([r.w for r in b])
    Wa = np.stack([r.w for r, _ in zip(a, Wb)])
    return float(np.abs(Wa - Wb).max()), 1e-4 * (1 + float(np.abs(Wb).max()))


def check_honest(specs, res) -> None:
    import numpy as np

    for s, r in zip(specs, res):
        honest_hit = set(r.identify_step) - set(s.byz)
        check(not honest_hit, f"{s.label}: honest workers {honest_hit} "
                              f"identified")
        check(not np.asarray(r.state.identified)[
            [w for w in range(s.n) if w not in s.byz]].any(),
            f"{s.label}: an honest worker was eliminated")


def check_vs_plain(label, res, specs, n=None, **kw) -> float:
    """The same run with the plain versions on the card (on the first
    ``n`` specs where ``n`` is given): control exact, W within
    1e-4*(1+max|W|)."""
    import repro_torch

    plain = repro_torch.run_batch(specs[:n], mesh=None, kernel_impl="torch",
                                  **kw)
    check(same_control(res, plain),
          f"{label}: control differs between kernels and plain versions")
    err, tol = w_close(res, plain)
    print(f"{label} W: max|kernels-plain| = {err:.3e} (tolerance "
          f"1e-4*(1+max|W|) = {tol:.3e})")
    check(err <= tol, f"{label}: W differs between kernels and plain "
                      f"versions")
    return err


def bitwise(a, b) -> bool:
    """Equal bit for bit (NaNs included)."""
    import numpy as np

    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        (a.view(np.uint8) == b.view(np.uint8)).all())


def schedule_sums(arr) -> dict:
    """Six of the counters as sums over the recorded (T, B, ...) schedule
    arrays, as the reference's test_counters_match_recorded_schedule
    checks them."""
    live, checks = arr["live"], arr["checks"]
    vote1, identify = arr["vote1"], arr["identify"]
    return {"steps": live.sum(0), "checks": checks.sum(0),
            "redundant_steps": (checks | vote1).sum(0),
            "identify_rounds": identify.sum(0),
            "vote_rounds": (identify | vote1).sum(0),
            "tamper_events": arr["tam1"].sum(axis=(0, 2))
            + arr["tam2"].sum(axis=(0, 2))}


def check_telemetry(label, off, run, plain=None) -> dict:
    """``run(**kw)`` (a path's ``run_batch`` call) once more with
    ``telemetry=True``: W, losses and detect flags bitwise those of
    ``off``, the run without; the counters equal to those of the same
    run with the plain versions on the card (``plain``, or run here),
    and six of them to their sums over the recorded schedule.  Prints
    the counter totals, the efficiency report and the pipeline's span
    times."""
    import numpy as np

    from repro_torch.obs import report
    from repro_torch.obs import trace as obtrace
    from repro_torch.obs.telemetry import TEL_KEYS

    obtrace.clear()
    on = run(telemetry=True)
    spans = {}
    for e in obtrace.spans():
        if e["name"].startswith("pipeline."):
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur_ns"] / 1e9
    check(off.telemetry is None and on.telemetry is not None,
          f"{label}: telemetry missing or unasked")
    check(bitwise(on.detect_flags, off.detect_flags)
          and all(bitwise(a.w, b.w)
                  and bitwise(np.asarray(a.losses), np.asarray(b.losses))
                  for a, b in zip(on, off)),
          f"{label}: telemetry=True changed W, losses or detect flags")
    if plain is None:
        plain = run(telemetry=True, kernel_impl="torch")
    for k in TEL_KEYS:
        check(np.array_equal(on.telemetry.counters[k],
                             plain.telemetry.counters[k]),
              f"{label}: counter {k} differs between kernels and plain "
              f"versions")
    del plain
    for k, v in schedule_sums(on.schedule.arrays).items():
        check(np.array_equal(on.telemetry.counters[k], v),
              f"{label}: counter {k} is not its sum over the schedule")
    totals = on.telemetry.totals()
    print(f"{label} telemetry=True: W, losses and detect flags bitwise "
          f"those of the run without; counters equal to the plain "
          f"versions' and to the schedule sums; totals {totals}")
    print(report.render_report(on))
    print(f"{label} pipeline spans (s, summed over chunks): "
          + ", ".join(f"{k}={v:.4f}" for k, v in sorted(spans.items()))
          + f"; post_scan {on.phase_s['post_scan']:.4f}, scan "
          f"{on.phase_s['scan']:.4f}, wall {on.elapsed_s:.4f}")
    return dict(totals=totals, report=report.efficiency_rows(on),
                spans_s=spans, phases_s=on.phase_s, wall_s=on.elapsed_s)


def profile_fused(specs) -> dict:
    """A ``profile_trace`` window around one fused_sweep run: its Chrome
    trace must parse and name K2's kernel, once per launch."""
    import shutil

    import repro_torch
    from repro_torch.obs import trace as obtrace

    pdir, label = ROOT / "chiprun_out" / "profile", "fused_sweep_fused"
    shutil.rmtree(pdir / label, ignore_errors=True)
    with obtrace.profile_trace(label, profile_dir=str(pdir)):
        _, launches = counted(lambda: repro_torch.run_batch(
            specs, mesh=None, fused=True))
    files = sorted((pdir / label).glob("*.pt.trace.json"))
    check(len(files) == 1, f"profile_trace wrote {len(files)} Chrome traces")
    events = json.loads(files[0].read_text())["traceEvents"]
    k2 = [e["name"] for e in events
          if "fused_step_kernel" in str(e.get("name", ""))
          and e.get("cat") == "kernel"]
    print(f"profile_trace window around fused_sweep fused=True: "
          f"{files[0].relative_to(ROOT)} ({files[0].stat().st_size} bytes, "
          f"{len(events)} events); K2 as {k2[0] if k2 else None!r}, "
          f"{len(k2)} kernel events for {launches['fused_step']} launches")
    check(len(k2) == launches["fused_step"] > 0,
          "the profile_trace Chrome trace does not name K2's kernel once "
          "per launch")
    return dict(trace=str(files[0].relative_to(ROOT)), events=len(events),
                k2_kernel=k2[0], k2_events=len(k2))


def run_path(label, run, expect, reps: int = 3):
    """Warm-up, then ``reps`` runs; the first timed run is counted.
    Returns (first result, its launch counts, the timing summary)."""
    import statistics

    run()                                              # warm-up
    res, launches = counted(run)
    times = [(res.elapsed_s, res.phase_s)]
    for _ in range(reps - 1):
        r = run()
        times.append((r.elapsed_s, r.phase_s))
        del r
    require_launched(launches, expect, label)
    print(res.plan.explain())
    wall = statistics.median(t[0] for t in times)
    phases = {k: statistics.median(t[1][k] for t in times)
              for k in times[0][1]}
    print(f"{label} warm wall (median of {reps}): {wall:.4f} s; phases (s): "
          + ", ".join(f"{k}={v:.4f}" for k, v in phases.items()))
    return res, launches, dict(wall_s=wall, phases_s=phases)


def phase_gram(torch):
    import numpy as np

    import repro_torch

    specs = gram_sweep_specs(repro_torch.TrialSpec, **GRAM_SWEEP)

    def run(**kw):
        return repro_torch.run_batch(specs, mesh=None, **kw)

    res, launches, info = run_path(
        "gram_sweep", run, ("gram_factors", "pairwise_relmax_batched"))
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    check(res.plan.data_plane == "gram", "gram_sweep is not the gram plane")
    check(res.plan.schedule_mode == "vector", "schedule is not 'vector'")
    W = np.stack([r.w for r in res])
    L = np.array([r.losses for r in res])
    check(W.shape == (GRAM_SWEEP["B"], GRAM_SWEEP["d"]), f"W shape {W.shape}")
    check(bool(np.isfinite(W).all() and np.isfinite(L).all()),
          "non-finite W or losses")
    del W
    check_honest(specs, res)
    info["w_err_vs_plain"] = check_vs_plain("gram_sweep", res, specs)
    info["telemetry"] = check_telemetry("gram_sweep", res, run)
    info["identify_rounds"] = int(res.schedule.arrays["identify"].sum())
    print(f"identify rounds: {info['identify_rounds']}; detect flags: "
          f"{int(res.detect_flags.sum())}; efficiency (mean): "
          f"{statistics.mean(r.efficiency for r in res):.6f}")
    return launches, info


def fused_sweep_specs(TrialSpec, B, T, n_data, d, problems=0):
    return [TrialSpec(byz=(2, 5), attack="drift", q=0.2, steps=T, seed=s,
                      n_data=n_data, d=d,
                      problem_seed=s % problems if problems else 0,
                      label=f"fused_sweep/s{s}") for s in range(B)]


def per_trial_close(a, b) -> float:
    """max over trials of max|a.w - b.w| / (1 + max|b.w|), the measure
    of bench_protocol.py:340-344."""
    import numpy as np

    return max(float(np.abs(ra.w - rb.w).max())
               / (1.0 + float(np.abs(rb.w).max())) for ra, rb in zip(a, b))


def phase_stream(torch):
    """fused_sweep through the fused plane (K2) and the unfused scan
    (K4), bf16 rows once, and the per-trial-problem run (K4, K5)."""
    import numpy as np

    import repro_torch

    TS = repro_torch.TrialSpec
    specs = fused_sweep_specs(TS, **FUSED_SWEEP)
    out, launches = {}, {}

    def run(**kw):
        return repro_torch.run_batch(specs, mesh=None, **kw)

    fu, launches["fused"], out["fused"] = run_path(
        "fused_sweep fused=True", lambda: run(fused=True), ("fused_step",))
    check(fu.plan.fused and fu.plan.chunk_trials == FUSED_CHUNK,
          f"fused_sweep plan: fused={fu.plan.fused}, chunk="
          f"{fu.plan.chunk_trials}")
    W = np.stack([r.w for r in fu])
    check(W.shape == (FUSED_SWEEP["B"], FUSED_SWEEP["d"])
          and bool(np.isfinite(W).all()), "fused_sweep W shape or values")
    del W
    check_honest(specs, fu)
    out["fused"]["w_err_vs_plain"] = check_vs_plain(
        "fused_sweep fused=True", fu, specs, fused=True)
    out["fused"]["telemetry"] = check_telemetry(
        "fused_sweep fused=True", fu, lambda **kw: run(fused=True, **kw))
    out["fused"]["profile"] = profile_fused(specs)

    un, launches["unfused"], out["unfused"] = run_path(
        "fused_sweep fused=False", lambda: run(fused=False),
        ("sketch_batched",))
    check(not un.plan.fused and un.plan.data_plane == "stream",
          "fused=False did not run the unfused stream scan")
    check_honest(specs, un)
    out["unfused"]["w_err_vs_plain"] = check_vs_plain(
        "fused_sweep fused=False", un, specs, fused=False)
    out["unfused"]["telemetry"] = check_telemetry(
        "fused_sweep fused=False", un, lambda **kw: run(fused=False, **kw))
    check(same_control(fu, un), "fused and unfused control differ")
    err = per_trial_close(fu, un)
    print(f"fused vs unfused: max over trials of max|dW|/(1+max|W|) = "
          f"{err:.3e} (tolerance 1e-4); detect flags "
          f"{int(fu.detect_flags.sum())}, identify rounds "
          f"{int(fu.schedule.arrays['identify'].sum())}")
    check(err <= 1e-4, "fused and unfused W differ")
    out["fused_vs_unfused"] = err
    del un

    # the default lr diverges here (max|W| ~ 1e8 after 3 steps), which
    # makes the 1e-4*(1+max|W|) check loose: hold both planes against the
    # plain versions per trial once more at a contractive lr
    c_specs = [dataclasses.replace(s, lr=s.n_data / (4.0 * s.d))
               for s in specs]
    held = {}
    for plane, kernel in (("fused", "fused_step"), ("unfused",
                                                     "sketch_batched")):
        label = f"fused_sweep contractive {plane}"
        kw = dict(fused=plane == "fused")
        res, launches[f"contractive_{plane}"] = counted(
            lambda: repro_torch.run_batch(c_specs, mesh=None, **kw))
        require_launched(launches[f"contractive_{plane}"], (kernel,), label)
        plain = repro_torch.run_batch(c_specs, mesh=None,
                                      kernel_impl="torch", **kw)
        check(same_control(res, plain),
              f"{label}: control differs between kernels and plain versions")
        err = per_trial_close(res, plain)
        del plain
        print(f"{label} (lr = n_data/(4d)) W: max over trials of "
              f"max|kernels-plain|/(1+max|W|) = {err:.3e} (tolerance 1e-4); "
              f"max|W| = {max(float(np.abs(r.w).max()) for r in res):.3e}")
        check(err <= 1e-4, f"{label}: W differs between kernels and plain "
                           f"versions")
        out[f"contractive_{plane}_w_err_vs_plain"] = err
        held[plane] = res
    err = per_trial_close(held["fused"], held["unfused"])
    print(f"contractive fused vs unfused: max over trials of "
          f"max|dW|/(1+max|W|) = {err:.3e} (tolerance 1e-4)")
    check(same_control(held["fused"], held["unfused"]) and err <= 1e-4,
          "contractive fused and unfused runs differ")
    out["contractive_fused_vs_unfused"] = err
    del held, res

    def run_bf16(**kw):
        return run(fused=True, stream_dtype="bf16", **kw)

    bf, launches["bf16"] = counted(run_bf16)
    require_launched(launches["bf16"], ("fused_step",), "bf16 fused_sweep")
    check(bf.plan.stream_dtype == "bf16" and same_control(bf, fu),
          "bf16 run: plan or control differs from the f32 run")
    err = per_trial_close(bf, fu)
    print(f"bf16 rows vs f32 (fused_sweep): max over trials of "
          f"max|dW|/(1+max|W|) = {err:.3e} (tolerance 3e-2); wall "
          f"{bf.elapsed_s:.4f} s, phases (s): "
          + ", ".join(f"{k}={v:.4f}" for k, v in bf.phase_s.items()))
    check(err <= 3e-2, "bf16 W too far from the f32 run")
    out["bf16"] = dict(wall_s=bf.elapsed_s, phases_s=bf.phase_s,
                       w_rel_err_vs_f32=err,
                       telemetry=check_telemetry("fused_sweep bf16", bf,
                                                 run_bf16))
    del bf, fu

    pp_specs = fused_sweep_specs(TS, **PER_PROBLEM)

    def run_pp(**kw):
        return repro_torch.run_batch(pp_specs, mesh=None, **kw)

    pp, launches["per_problem"] = counted(run_pp)
    require_launched(launches["per_problem"],
                     ("sketch_batched", "coded_encode_batched"),
                     "per-problem")
    print(pp.plan.explain())
    check(not pp.plan.shared_problem and not pp.plan.fused,
          "per-problem run did not take the per-trial-problem plan")
    check_honest(pp_specs, pp)
    print(f"per-problem wall (one run): {pp.elapsed_s:.4f} s; phases (s): "
          + ", ".join(f"{k}={v:.4f}" for k, v in pp.phase_s.items()))
    out["per_problem"] = dict(wall_s=pp.elapsed_s, phases_s=pp.phase_s)
    out["per_problem"]["w_err_vs_plain"] = check_vs_plain(
        "per-problem", pp, pp_specs)
    out["per_problem"]["telemetry"] = check_telemetry("per-problem", pp,
                                                      run_pp)
    return launches, out


def adaptive_sweep_specs(TrialSpec, B, T, n_data, d, lr=None):
    kw = {} if lr is None else dict(lr=lr)
    return [TrialSpec(byz=(2, 5), attack="sign_flip", q=None, steps=T,
                      seed=s, n_data=n_data, d=d, label=f"adaptive_sweep/s{s}",
                      **kw) for s in range(B)]


def same_trace(a, b, q_exact: bool = True) -> bool:
    """The device plane's decisions: the trace's check, detect and
    faulty2, identify steps, kappa and meters equal; q equal, or within
    rtol 1e-5 / atol 1e-6 (another card's or host's f32 loss)."""
    import numpy as np

    ta, tb = a.device_trace, b.device_trace
    if not all(np.array_equal(ta[k], tb[k])
               for k in ("check", "detect", "faulty2")):
        return False
    if q_exact:
        q_ok = np.array_equal(ta["q"], tb["q"])
    else:
        q_ok = np.allclose(ta["q"], tb["q"], rtol=1e-5, atol=1e-6)
    return q_ok and all(
        ra.identify_step == rb.identify_step
        and ra.state.kappa == rb.state.kappa
        and ra.efficiency == rb.efficiency
        and ra.state.meter.history == rb.state.meter.history
        for ra, rb in zip(a, b))


def profile_device(label, specs, kw) -> dict:
    """A ``profile_trace`` window around one device-control run: the
    kernels' device time over the scan's (the card's busy share inside
    the step loop, both under the profiler), and the kernels and launch
    calls a step.  The trace is parsed and removed."""
    import shutil

    import repro_torch
    from repro_torch.obs import trace as obtrace

    pdir = ROOT / "chiprun_out" / "profile"
    name = "device_" + "".join(c if c.isalnum() else "_" for c in label)
    shutil.rmtree(pdir / name, ignore_errors=True)
    with obtrace.profile_trace(name, profile_dir=str(pdir)):
        res = repro_torch.run_batch(specs, mesh=None, schedule="device", **kw)
    files = sorted((pdir / name).glob("*.pt.trace.json"))
    check(len(files) == 1, f"profile_trace wrote {len(files)} Chrome traces")
    events = json.loads(files[0].read_text())["traceEvents"]
    shutil.rmtree(pdir / name)
    kern = [e for e in events if e.get("cat") == "kernel"]
    launch_calls = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                       and "LaunchKernel" in str(e.get("name", "")))
    steps = res.plan.steps * -(-len(specs) // res.plan.chunk_trials)
    kernel_s = sum(e["dur"] for e in kern) / 1e6
    scan_s = res.phase_s["scan"]
    out = dict(kernel_events=len(kern), launch_calls=launch_calls,
               kernels_per_step=len(kern) / steps,
               kernel_s=kernel_s, scan_s=scan_s,
               busy_share=kernel_s / scan_s,
               scan_ms_per_step=1e3 * scan_s / steps)
    print(f"{label} under the profiler: {len(kern)} kernels "
          f"({out['kernels_per_step']:.1f} a step, {launch_calls} launch "
          f"calls), kernel time {kernel_s:.4f} s of scan {scan_s:.4f} s: "
          f"busy share {out['busy_share']:.3f}; "
          f"{out['scan_ms_per_step']:.3f} ms a step")
    return out


def phase_device_control(torch):
    """The device control plane (``schedule="device"``): adaptive_sweep
    as the reference defines it (B = 256, T = 24, d = 2^13, lr 0.05),
    then its trials at d = 2^20 on the stream plane and on the gram plane
    (lr = n_data/d, gram_sweep's: lr 0.05 overflows float32 there within
    the 24 steps), each against the plain versions on the card; a
    contractive variant held per trial; small inputs against the CPU."""
    import numpy as np

    import repro_torch

    TS = repro_torch.TrialSpec
    t0 = time.perf_counter()
    out, launches = {}, {}
    cell = ADAPTIVE_SWEEP
    # (label, specs, knobs, kernels, timed runs, profiled): the phase
    # stays near a minute with two timed runs and no profiler window on
    # the d = 2^20 gram path
    full = adaptive_sweep_specs(TS, **dict(cell, d=ADAPTIVE_D_FULL),
                                lr=cell["n_data"] / ADAPTIVE_D_FULL)
    paths = [
        ("adaptive_sweep", adaptive_sweep_specs(TS, **cell), {},
         ("sketch_batched", "pairwise_relmax_batched"), 3, True),
        ("adaptive_sweep d=2^20 stream", full, {},
         ("sketch_batched", "pairwise_relmax_batched"), 2, True),
        ("adaptive_sweep d=2^20 gram", full, dict(data_plane="gram"),
         ("gram_factors", "pairwise_relmax_batched"), 2, False),
    ]
    for label, specs, kw, kernels, reps, profiled in paths:
        def run(**more):
            return repro_torch.run_batch(specs, mesh=None, schedule="device",
                                         **kw, **more)

        res, launches[label], info = run_path(label, run, kernels, reps)
        plane = "gram" if kw else "stream"
        check(res.plan.control == "device" and res.schedule.mode == "device"
              and res.plan.data_plane == plane,
              f"{label}: plan {res.plan.control}/{res.plan.data_plane}")
        W = np.stack([r.w for r in res])
        check(W.shape == (len(specs), specs[0].d)
              and bool(np.isfinite(W).all()), f"{label}: W shape or values")
        del W
        check_honest(specs, res)
        # one plain run serves both comparisons: telemetry is
        # output-neutral, which check_telemetry holds for the kernels
        plain = run(kernel_impl="torch", telemetry=True)
        check(same_trace(res, plain) and same_control(res, plain),
              f"{label}: the trace differs between kernels and plain "
              f"versions")
        err, tol = w_close(res, plain)
        print(f"{label} W: max|kernels-plain| = {err:.3e} (tolerance "
              f"1e-4*(1+max|W|) = {tol:.3e})")
        check(err <= tol, f"{label}: W differs between kernels and plain "
                          f"versions")
        info["w_err_vs_plain"] = err
        info["telemetry"] = check_telemetry(label, res, run, plain)
        del plain
        info["checks"] = int(res.device_trace["check"].sum())
        info["detects"] = int(res.device_trace["detect"].sum())
        info["eliminations"] = int(res.device_trace["faulty2"].sum())
        info["identified_by_step"] = sorted(
            {s for r in res for s in r.identify_step.values()})
        if profiled:
            info["profile"] = profile_device(label, specs, kw)
        print(f"{label}: {info['checks']} checks, {info['detects']} "
              f"detects, {info['eliminations']} eliminations; identify "
              f"steps {info['identified_by_step']}; efficiency (mean) "
              f"{statistics.mean(r.efficiency for r in res):.6f}")
        out[label] = info
        del res

    # the cell's lr 0.05 makes W grow ~14x a step at d = 2^13 (the
    # reference's own losses overflow float32 by step 23): hold the
    # values per trial once more at a contractive lr
    c_specs = adaptive_sweep_specs(TS, **cell,
                                   lr=cell["n_data"] / (4.0 * cell["d"]))
    res, launches["adaptive_sweep contractive"] = counted(
        lambda: repro_torch.run_batch(c_specs, mesh=None, schedule="device"))
    require_launched(launches["adaptive_sweep contractive"],
                     ("sketch_batched", "pairwise_relmax_batched"),
                     "adaptive_sweep contractive")
    plain = repro_torch.run_batch(c_specs, mesh=None, schedule="device",
                                  kernel_impl="torch")
    check(same_trace(res, plain), "adaptive_sweep contractive: the trace "
                                  "differs between kernels and plain versions")
    err = per_trial_close(res, plain)
    L = np.array([r.losses for r in res])
    print(f"adaptive_sweep contractive (lr = n_data/(4d)) W: max over "
          f"trials of max|kernels-plain|/(1+max|W|) = {err:.3e} (tolerance "
          f"1e-4); losses finite: {bool(np.isfinite(L).all())}; "
          f"{int(res.device_trace['detect'].sum())} detects")
    check(err <= 1e-4 and bool(np.isfinite(L).all()),
          "adaptive_sweep contractive: W differs between kernels and plain "
          "versions, or a loss is not finite")
    check_honest(c_specs, res)
    out["contractive_w_err_vs_plain"] = err
    del res, plain

    # small inputs on the card against the CPU: B = 8, d = 4096
    small = {}
    for lr_name, lr in (("cell lr", None), ("contractive lr", 64.0 / 16384)):
        for plane, kw in (("stream", {}), ("gram", dict(data_plane="gram"))):
            specs = adaptive_sweep_specs(TS, B=8, T=cell["T"], n_data=64,
                                         d=4096, lr=lr)
            on_card = repro_torch.run_batch(specs, mesh=None,
                                            schedule="device", **kw)
            on_cpu = repro_torch.run_batch(specs, mesh=None, schedule="device",
                                           device="cpu", **kw)
            label = f"small {plane}, {lr_name}"
            check(same_trace(on_card, on_cpu, q_exact=False),
                  f"{label}: card vs CPU trace")
            err, tol = w_close(on_card, on_cpu)
            print(f"{label} (B=8, d=4096) card vs CPU: same trace; "
                  f"max|dW| = {err:.3e} (tolerance {tol:.3e})")
            check(err <= tol, f"{label}: card vs CPU W")
            small[label] = err
    out["small_vs_cpu_w_err"] = small
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase_device_control: {out['phase_s']:.1f} s")
    return launches, out


def oracle_kernels(res) -> tuple:
    """The kernels a host-control run's plan must launch: its data
    plane's (K1 gram, K2 fused, K4 stream) and K3 when the schedule has
    an identify round or a draco vote."""
    plane = ("gram_factors" if res.plan.data_plane == "gram"
             else "fused_step" if res.plan.fused else "sketch_batched")
    arr = res.schedule.arrays
    voted = bool(arr["identify"].any() or arr["vote1"].any())
    return (plane,) + (("pairwise_relmax_batched",) if voted else ())


def detect_equals_identify(res) -> bool:
    """The scan's sketch verdict equals the replay's identify decision on
    every check row (tests/test_engine_parity.py:177-185)."""
    arr = res.schedule.arrays
    return not ((res.detect_flags != arr["identify"]) & arr["checks"]).any()


def same_numpy_control(res, npb) -> bool:
    """q-trace, identify steps, kappa and meters equal to the numpy
    engine's own run of the same specs: under "oracle" the schedule is
    that engine's run, so this shows that the replay is deterministic."""
    return all(a.q_trace == b.q_trace and a.identify_step == b.identify_step
               and a.state.kappa == b.state.kappa
               and a.state.meter.history == b.state.meter.history
               and a.efficiency == b.efficiency for a, b in zip(res, npb))


def phase_oracle(torch, device_wall_s: float):
    """The "oracle" schedule (the port's numpy engine replays every trial
    on the host; the data plane runs on the card): adaptive_sweep as the
    reference defines it (B = 256, T = 24, d = 2^13, sign_flip, adaptive
    q*) on the gram (K1, K3), fused (K2, K3) and stream (K4, K3) planes;
    its trials at d = 2^20 (B = ORACLE_B_FULL in chunks of
    ORACLE_CHUNK_FULL) on the gram and stream planes; then the five named
    scenarios at their defined size with no schedule argument ("auto"
    resolves to "oracle").  Each run is held against the same run with
    the plain versions on the card (control and detect flags exact, W
    within 1e-4*(1+max|W|); on the first ORACLE_PLAIN_13 or
    ORACLE_PLAIN_FULL trials of adaptive_sweep); at d = 2^13 also W
    against the numpy engine's f64 W, per trial within
    1e-4*(1+max|W|); the scenarios also against the CPU run."""
    import numpy as np

    import repro_torch
    from repro_torch.core import engine as nengine

    TS = repro_torch.TrialSpec
    t0 = time.perf_counter()
    out, launches = {}, {}
    cell = ADAPTIVE_SWEEP
    specs13 = adaptive_sweep_specs(TS, **cell)
    t1 = time.perf_counter()
    npb13 = nengine.run_batch(specs13)
    numpy_s = time.perf_counter() - t1
    print(f"oracle: the numpy engine alone on adaptive_sweep (B="
          f"{cell['B']}, d=2^13): {numpy_s:.4f} s")
    full_cell = dict(cell, B=ORACLE_B_FULL, d=ADAPTIVE_D_FULL)
    full = adaptive_sweep_specs(TS, **full_cell,
                                lr=cell["n_data"] / ADAPTIVE_D_FULL)
    chunked = dict(chunk_trials=ORACLE_CHUNK_FULL)
    # (label, specs, knobs, data plane, fused, trials of the plain run)
    paths = [
        ("oracle adaptive_sweep gram", specs13, {}, "gram", False,
         ORACLE_PLAIN_13),
        ("oracle adaptive_sweep fused", specs13, dict(fused=True), "stream",
         True, ORACLE_PLAIN_13),
        ("oracle adaptive_sweep stream", specs13, dict(fused=False),
         "stream", False, ORACLE_PLAIN_13),
        ("oracle adaptive_sweep d=2^20 gram", full, chunked, "gram", False,
         ORACLE_PLAIN_FULL),
        ("oracle adaptive_sweep d=2^20 stream", full,
         dict(chunked, fused=False), "stream", False, ORACLE_PLAIN_FULL),
    ]
    for label, specs, kw, plane, fused, n_plain in paths:
        # every kernel was built and run by the earlier phases: the first
        # run is warm (the replay is numpy), so it is the timed one
        res, launches[label] = counted(
            lambda: repro_torch.run_batch(specs, mesh=None,
                                          schedule="oracle", **kw))
        require_launched(launches[label], oracle_kernels(res), label)
        check(res.plan.schedule_mode == "oracle"
              and res.plan.control == "host" and res.schedule.mode == "oracle"
              and not res.schedule.used_proxy
              and res.plan.data_plane == plane and res.plan.fused == fused,
              f"{label}: plan {res.plan.schedule_mode}/{res.plan.data_plane}"
              f"/fused={res.plan.fused}")
        W = np.stack([r.w for r in res])
        check(W.shape == (len(specs), specs[0].d)
              and bool(np.isfinite(W).all()), f"{label}: W shape or values")
        del W
        check_honest(specs, res)
        info = dict(wall_s=res.elapsed_s, phases_s=res.phase_s,
                    B=len(specs), d=specs[0].d,
                    chunk_trials=res.plan.chunk_trials, plain_trials=n_plain)
        if specs is specs13:
            check(same_numpy_control(res, npb13),
                  f"{label}: control differs from the numpy engine's run")
            # the card's f32 W against the numpy engine's f64 W, an
            # answer independent of the plain versions
            info["w_err_vs_numpy"] = per_trial_close(res, npb13)
            print(f"{label} W vs the numpy engine (f64): max over trials of "
                  f"max|dW|/(1+max|W|) = {info['w_err_vs_numpy']:.3e} "
                  f"(tolerance 1e-4)")
            check(info["w_err_vs_numpy"] <= 1e-4,
                  f"{label}: W differs from the numpy engine's")
        else:
            check(res.plan.chunk_trials == ORACLE_CHUNK_FULL,
                  f"{label}: chunk_trials {res.plan.chunk_trials}")
        check(detect_equals_identify(res),
              f"{label}: a sketch verdict differs from the replay's")
        info["w_err_vs_plain"] = check_vs_plain(label, res, specs, n_plain,
                                                schedule="oracle", **kw)
        info["identify_rounds"] = int(res.schedule.arrays["identify"].sum())
        info["eliminations"] = sum(r.state.kappa for r in res)
        print(f"{label} (B={len(specs)}, d={specs[0].d}): wall "
              f"{res.elapsed_s:.4f} s; phases (s): "
              + ", ".join(f"{k}={v:.4f}" for k, v in res.phase_s.items())
              + f"; {info['identify_rounds']} identify rounds, "
              f"{info['eliminations']} eliminations")
        out[label] = info
        del res
    # schedule="device" runs adaptive_sweep on the stream plane: the
    # oracle's stream-plane wall is the one to set beside it
    stream13 = out["oracle adaptive_sweep stream"]["wall_s"]
    gram13 = out["oracle adaptive_sweep gram"]["wall_s"]
    out["oracle_vs_device_wall"] = stream13 / device_wall_s
    print(f"adaptive_sweep (B=256, T=24, d=2^13): oracle wall {stream13:.4f} "
          f"s (stream plane; gram plane {gram13:.4f} s) against the warm "
          f"schedule=\"device\" wall {device_wall_s:.4f} s (stream plane): "
          f"{stream13 / device_wall_s:.2f}x")

    scen = {}
    for name, matrix in repro_torch.SCENARIOS.items():
        specs = matrix.expand()
        res, launches[f"scenario {name}"] = counted(
            lambda: matrix.run(backend="torch", mesh=None))
        require_launched(launches[f"scenario {name}"], oracle_kernels(res),
                         f"scenario {name}")
        check(res.plan.schedule_mode == "oracle"
              and res.plan.kernel_impl == "cuda",
              f"scenario {name}: plan {res.plan.schedule_mode}")
        check(detect_equals_identify(res),
              f"scenario {name}: a sketch verdict differs from the replay's")
        check(all(np.isfinite(r.w).all() for r in res),
              f"scenario {name}: non-finite W")
        errs = {}
        for other_name, other in (
                ("plain", matrix.run(backend="torch", mesh=None,
                                     kernel_impl="torch")),
                ("cpu", matrix.run(backend="torch", mesh=None, device="cpu"))):
            check(same_control(res, other),
                  f"scenario {name}: control differs from the {other_name} "
                  f"run")
            # per trial: the "none" trials diverge under sign_flip
            errs[other_name] = per_trial_close(res, other)
            check(errs[other_name] <= 1e-4,
                  f"scenario {name}: W differs from the {other_name} run")
        exact = sum(r["exact"] for r in res.summarize())
        scen[name] = dict(trials=len(specs), data_plane=res.plan.data_plane,
                          fused=res.plan.fused, wall_s=res.elapsed_s,
                          phases_s=res.phase_s,
                          w_err_vs_plain=errs["plain"],
                          w_err_vs_cpu=errs["cpu"],
                          exact_rows=exact, rows=len(res.summarize()))
        print(f"scenario {name} ({len(specs)} trials, "
              f"{res.plan.data_plane}{' fused' if res.plan.fused else ''}): "
              f"wall {res.elapsed_s:.4f} s; W max over trials of "
              f"max|dW|/(1+max|W|): vs plain {errs['plain']:.3e}, vs CPU "
              f"{errs['cpu']:.3e}; {exact} of {len(res.summarize())} "
              f"summary rows exact")
    out["scenarios"] = scen
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase_oracle: {out['phase_s']:.1f} s")
    return launches, out


# the trials split (``phase_engine_split``): gram_sweep, fused_sweep and
# the device plane's adaptive_sweep through ``run_batch(mesh=...)``, a
# chunk of SPLIT_PASS[path] x c trials split into c shards of
# SPLIT_PASS[path], against one device's passes of as many trials (the
# same step loop on the same rows: bitwise); on one card the mesh lists
# cuda:0 twice
SPLIT_PASS = {"gram_sweep": 8, "fused_sweep": FUSED_CHUNK,
              "adaptive_sweep": 64}


def allocations(torch, card: int) -> int:
    """The caching allocator's allocations on ``card`` so far."""
    return torch.cuda.memory_stats(card).get("allocation.all.allocated", 0)


def split_mesh(count: int):
    """A trials mesh of ``count`` shards over the visible cards in turn
    (on one card: cuda:0 ``count`` times)."""
    import torch

    from repro_torch.sharding import TrialsMesh

    n = torch.cuda.device_count()
    return TrialsMesh(tuple(f"cuda:{i % n}" for i in range(count)))


def other_card_kernels(torch, card: int) -> dict:
    """Each engine kernel (K1, K2, K3, K3s, K4, K4s, K5, K5s) and K6 on
    card ``card`` while card 0 is current: bitwise the same kernel on
    card 0's copy of the inputs, and within the kernel's tolerance of its
    plain version on ``card`` (the tolerances of ``phase_kernels``)."""
    import numpy as np

    from repro_torch.kernels import ops

    dev = torch.device("cuda", card)
    gen = torch.Generator(device=dev).manual_seed(7)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    keys = np.uint32(0x9E3779B9) * (np.arange(5, dtype=np.uint32) + 1)
    x = r(6, 8, 4099)
    x[:, 1] = x[:, 0]
    qkv = (r(2, 320, 8, 64).bfloat16(), r(2, 320, 2, 64).bfloat16(),
           r(2, 320, 2, 64).bfloat16())
    sk = (2e-5, 1e-3)
    # name: (call(impl, *args), args, [(rtol, atol) or "rel" per output])
    cases = {
        "gram_factors": (lambda impl, R, W: ops.gram_factors(
            R, W, keys, impl=impl), (r(66, 70001), r(9, 70001)),
            ["rel", "rel", sk]),
        "fused_step": (lambda impl, R, W, cw: ops.fused_step(
            R, W.clone(), cw, 7, impl=impl), (r(66, 70001), r(9, 70001),
                                              r(9, 66)),
            ["rel", "rel", sk]),
        "pairwise_relmax_batched": (lambda impl, a: ops.
                                    batched_pairwise_relmax(a, impl=impl),
                                    (x,), [(1e-6, 0.0)]),
        "pairwise_relmax": (lambda impl, a: ops.pairwise_relmax(
            a, impl=impl), (x[0],), [(1e-6, 0.0)]),
        "sketch_batched": (lambda impl, a: ops.batched_sketch(
            a, 11, impl=impl), (r(66, 70001),), [sk]),
        "sketch": (lambda impl, a: ops.sketch(a, 11, impl=impl),
                   (r(513024),), [sk]),
        "coded_encode_batched": (lambda impl, c, g: ops.batched_coded_encode(
            c, g, impl=impl), (r(4, 3, 8), r(4, 8, 5003)), ["rel"]),
        "coded_encode": (lambda impl, c, g: ops.coded_encode(
            c, g, impl=impl), (r(4, 4), r(4, 20003)), ["rel"]),
        "flash_attention": (lambda impl, q, k, v: ops.flash_attention(
            q, k, v, impl=impl), qkv, [(2e-2, 2e-2)]),
    }
    out = {}
    with torch.cuda.device(0):
        for name, (call, args, tols) in cases.items():
            check(torch.cuda.current_device() == 0, "card 0 is not current")
            got = call("cuda", *args)
            torch.cuda.synchronize(dev)
            want = call("torch", *args)
            on0 = call("cuda", *(a.to("cuda:0") for a in args))
            got = [t for t in (got if isinstance(got, tuple) else (got,))
                   if t is not None]
            want = [t for t in (want if isinstance(want, tuple) else (want,))
                    if t is not None]
            on0 = [t for t in (on0 if isinstance(on0, tuple) else (on0,))
                   if t is not None]
            errs, ok = [], True
            for a, b, c, tol in zip(got, want, on0, tols):
                check(a.device == dev, f"{name} returned on {a.device}")
                if tol == "rel":
                    e = rel_err(a, b)
                    ok &= e <= 1e-5
                else:
                    e = max_err(a.float(), b.float())
                    ok &= close(a.float(), b.float(), *tol)
                errs.append(e)
                ok &= bitwise(a.cpu().numpy() if a.dtype != torch.bfloat16
                              else a.view(torch.int16).cpu().numpy(),
                              c.cpu().numpy() if c.dtype != torch.bfloat16
                              else c.view(torch.int16).cpu().numpy())
            print(f"{name} on cuda:{card}, cuda:0 current: vs plain "
                  f"{max(errs):.3e}, bitwise the kernel on cuda:0")
            check(ok, f"{name} on cuda:{card} with cuda:0 current differs "
                      f"from its plain version or from the kernel on "
                      f"cuda:0")
            out[name] = max(errs)
    return out


def phase_engine_split(torch):
    """The trials split over the cards (``run_batch(mesh=...)``): each
    path at every device count in ``counts`` (1, 2, 4, ... up to the
    cards; on one card 1 and cuda:0 twice), control equal to the
    one-device run and W bitwise at matching passes, every card of the
    mesh used, the walls by device count; with two or more cards each
    engine kernel launched on a card that is not current against its
    plain version first (those launches are not counted)."""
    import numpy as np

    import repro_torch
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    TS = repro_torch.TrialSpec
    cards = torch.cuda.device_count()
    counts = [1] + [c for c in (2, 4, 8) if c <= max(2, cards)]
    if cards > 2 and cards not in counts:
        counts.append(cards)
    other = {f"cuda:{j}": other_card_kernels(torch, j)
             for j in range(1, cards)}
    paths = [
        ("gram_sweep", gram_sweep_specs(TS, **GRAM_SWEEP), {},
         ("gram_factors", "pairwise_relmax_batched")),
        ("fused_sweep", fused_sweep_specs(TS, **FUSED_SWEEP),
         dict(fused=True), ("fused_step", "pairwise_relmax_batched")),
        ("adaptive_sweep", adaptive_sweep_specs(TS, **ADAPTIVE_SWEEP),
         dict(schedule="device"), ("sketch_batched",
                                   "pairwise_relmax_batched")),
    ]
    out = {"cards": cards, "counts": counts, "other_card_kernels": other,
           "paths": {}}
    ops.reset_launch_counts()
    for label, specs, kw, _ in paths:
        P = SPLIT_PASS[label]
        one, walls = None, {}
        for c in counts:
            mesh = None if c == 1 else split_mesh(c)
            allocs = [allocations(torch, j) for j in range(cards)]
            runs = [repro_torch.run_batch(specs, mesh=mesh,
                                          chunk_trials=P * c, **kw)
                    for _ in range(2)]
            res = runs[0]
            check(res.plan.n_devices == c and res.plan.chunk_trials == P * c,
                  f"{label}: the plan splits over {res.plan.n_devices}, "
                  f"want {c}")
            walls[c] = dict(wall_s=runs[1].elapsed_s,
                            phases_s=runs[1].phase_s)
            if c == 1:
                one = res
                continue
            used = sorted({d.index for d in mesh.devices})
            idle = [j for j in used if allocations(torch, j) == allocs[j]]
            check(not idle, f"{label}: cards {idle} of the mesh unused")
            same = same_trace(one, res) if res.plan.control == "device" \
                else same_control(one, res)
            exact = all(bitwise(a.w, b.w) and a.losses == b.losses
                        for r in runs for a, b in zip(one, r))
            where = ", ".join(str(d) for d in mesh.devices)
            print(f"{label} split over {c} ({where}), passes of {P}: "
                  f"control equal {same}, W and losses bitwise the "
                  f"one-device run {exact}")
            check(same and exact, f"{label}: the split over {c} differs "
                                  f"from one device")
        out["paths"][label] = walls
        print(f"{label} walls by device count (s; the second of two runs):"
              + ";".join(f" {c}: {w['wall_s']:.4f} (" + ", ".join(
                  f"{k} {v:.4f}" for k, v in w["phases_s"].items()) + ")"
                  for c, w in walls.items()))
    launches = ops.launch_counts()
    require_launched(launches, sorted({k for *_, ks in paths for k in ks}),
                     "engine split")
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase_engine_split: {out['phase_s']:.1f} s")
    return launches, out


def phase_single_path(torch):
    """The single-vector ops through their public entry points, at the
    reference kernel bench's shapes (benchmarks/bench_kernels.py:53-65):
    no engine path calls them."""
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    g = torch.randn(1_000_000, generator=gen, device=dev)
    reps = g[None, :100_000].repeat(7, 1)
    reps[1] *= -3.0
    C = torch.randn(4, 4, generator=gen, device=dev)
    G = torch.randn(4, 200_000, generator=gen, device=dev)

    def run(impl=None):
        out = (ops.sketch(g, 7, impl=impl), ops.vote(reps, impl=impl),
               ops.coded_encode(C, G, impl=impl))
        torch.cuda.synchronize()
        return out

    (s_k, v_k, e_k), launches = counted(run)
    require_launched(launches, ("sketch", "pairwise_relmax", "coded_encode"),
                     "single-vector ops")
    s_p, v_p, e_p = run("torch")
    check(close(s_k, s_p, 2e-5, 1e-3) and rel_err(e_k, e_p) <= 1e-5,
          "single-vector ops disagree with their plain versions")
    check(all(bool(torch.equal(a, b)) for a, b in zip(v_k, v_p))
          and bool(v_k[2]) and v_k[1].tolist() == [i == 1 for i in range(7)],
          "ops.vote did not single out the tampered replica")
    return launches


def phase_small_vs_cpu(torch):
    """Small contractive inputs on the card against the CPU run of the
    plain versions: gram, fused, unfused, per-problem, a filter batch."""
    import repro_torch

    TS = repro_torch.TrialSpec
    base = dict(byz=(2, 5), attack="drift", n_data=64)
    small = [TS(**base, q=0.3, steps=40, seed=s, d=4096, lr=16.0 / 4096)
             for s in range(4)]
    modes = [("none", 0.2), ("filter:median", 0.2), ("filter:krum", 0.2),
             ("draco", None), ("deterministic", None), ("randomized", 0.2)]
    d_f = 1 << 16
    filt = [TS(**base, mode=m, q=q, steps=12, seed=s, d=d_f,
               lr=64.0 / (4 * d_f)) for m, q in modes for s in range(3)]
    cases = {
        "gram": (small, {}),
        "fused": (small, dict(fused=True)),
        "unfused": (small, dict(fused=False)),
        "per_problem": ([dataclasses.replace(s, problem_seed=s.seed % 2)
                         for s in small], {}),
        "filters": (filt, {}),
    }
    errs = {}
    for name, (specs, kw) in cases.items():
        on_card = repro_torch.run_batch(specs, mesh=None, **kw)
        on_cpu = repro_torch.run_batch(specs, mesh=None, device="cpu", **kw)
        check(on_card.plan == dataclasses.replace(
            on_cpu.plan, kernel_impl="cuda"), f"{name}: card vs CPU plan")
        check(same_control(on_card, on_cpu), f"{name}: card vs CPU control")
        err, tol = w_close(on_card, on_cpu)
        print(f"small {name} ({on_card.plan.data_plane}, fused="
              f"{on_card.plan.fused}, B={len(specs)}) card vs CPU: "
              f"max|dW| = {err:.3e} (tolerance {tol:.3e})")
        check(err <= tol, f"{name}: card vs CPU W")
        errs[name] = err
    return errs


# K6 at the serving path's shapes: (label, B, S, H, K, hd, window), bf16,
# causal; the llama3.2-1b prefill first (its row in the kernels line)
ATTN_SHAPES = [
    ("llama3.2-1b prefill", 4, 4096, 32, 8, 64, None),
    ("qwen3-4b and phi3.5-moe prefill", 4, 4096, 32, 8, 128, None),
    ("jamba-v0.1-52b prefill", 4, 512, 32, 8, 128, None),
    ("gemma3-1b local layer", 1, 4096, 4, 1, 256, 512),
    ("gemma3-1b global layer", 1, 4096, 4, 1, 256, None),
]
# SHAPES["prefill_32k"]'s sequence length at B = 1 (configs/base.py:217)
ATTN_LONG = ("prefill_32k length", 1, 32768, 32, 8, 64, None)
# small f32 / bf16 shapes: (B, Sq, Sk, H, K, hd, causal, window)
ATTN_RAGGED = [
    (2, 100, 100, 4, 2, 16, True, None),
    (1, 64, 192, 6, 6, 32, True, None),
    (2, 130, 130, 4, 1, 64, True, 48),
    (1, 97, 97, 8, 4, 64, False, None),
    (1, 100, 60, 4, 2, 32, True, None),
    (1, 33, 1500, 4, 2, 128, True, None),
    (1, 200, 200, 4, 1, 256, True, 64),
]
# the serving cell: llama3.2-1b at full width, prompt cut from
# SHAPES["prefill_32k"] (32768 x 32) to 4096 x 4; K6 at its prefill shape
# (ATTN_SHAPES), reduced llama3.2-1b and gemma3-1b in f32 card vs CPU
SERVE = dict(arch="llama3.2-1b", B=4, S=4096, steps=32, q_audit=0.25,
             seed=0, k6_shape="llama3.2-1b prefill",
             small=("llama3.2-1b", "gemma3-1b"))


def attn_bound(B, Sq, Sk, H, K, hd, causal, window, itemsize):
    """K6's bound: q, k, v read once and o written once against the bf16
    tensor-core peak for 4 B H hd (unmasked pairs) operations."""
    RL = roofline()
    c = RL.kernel_cost("flash_attention", B=B, Sq=Sq, Sk=Sk, H=H, K=K,
                       hd=hd, causal=causal, window=window,
                       dtype="bfloat16" if itemsize == 2 else "float32")
    return RL.bound_ms(c.bytes, c.flops, RL.BF16_OPS_S)


def held_attention(got, want, dtype, what):
    """K6's two checks against its plain version, both printed before
    either is applied: elementwise (f32 2e-5, bf16 2e-2, abs + rel), and
    the relative error of every 64-query-row block (f32 1e-5, bf16 1e-2:
    the sound kernel gives about 2.5e-3 in bf16, from P's rounding to
    bf16 and the output's)."""
    import torch

    tol, tile_tol = ((2e-5, 1e-5) if dtype == torch.float32
                     else (2e-2, 1e-2))
    err = max_err(got.float(), want.float())
    tile = tile_rel_err(got, want)
    print(f"K6 {what} {str(dtype)[6:]}: max|kernel-plain| = {err:.3e} "
          f"(tolerance {tol} abs + rel); worst 64-row block "
          f"||kernel-plain|| / ||plain|| = {tile:.3e} (limit {tile_tol})")
    check(close(got.float(), want.float(), tol, tol),
          f"K6 disagrees at {what} {dtype}")
    check(tile <= tile_tol, f"K6 disagrees at {what} {dtype} (block "
                            f"relative error {tile:.3e})")
    return err, tile


def phase_attention_kernel(torch):
    """K6 against its plain version on the card, at the serving path's
    shapes and at small ragged ones, with its time beside the plain
    version's and SDPA's (a yardstick the port never calls)."""
    from repro_torch.kernels import flash_attention as fa

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)

    def qkv(B, Sq, Sk, H, K, hd, dtype):
        return [torch.randn(*s, generator=gen, device=dev).to(dtype)
                for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd))]

    def sdpa(q, k, v, window):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            return lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        # the same masks as an explicit one (kv expanded beforehand)
        S = q.shape[1]
        i = torch.arange(S, device=dev)
        keep = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        G = q.shape[2] // k.shape[2]
        kt = kt.repeat_interleave(G, dim=1)
        vt = vt.repeat_interleave(G, dim=1)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=keep)

    rows = {}
    for shape in ATTN_RAGGED:
        B, Sq, Sk, H, K, hd, causal, window = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(B, Sq, Sk, H, K, hd, dtype)
            got = fa.flash_attention_cuda(q, k, v, causal, window)
            want = fa.flash_attention_plain(q, k, v, causal, window)
            torch.cuda.synchronize()
            held_attention(got, want, dtype, f"ragged {shape}")
    for label, B, S, H, K, hd, window in ATTN_SHAPES:
        q, k, v = qkv(B, S, S, H, K, hd, torch.bfloat16)
        got = fa.flash_attention_cuda(q, k, v, True, window)
        want = fa.flash_attention_plain(q, k, v, True, window)
        torch.cuda.synchronize()
        err, tile = held_attention(got, want, torch.bfloat16,
                                   f"the {label} shape")
        again = fa.flash_attention_cuda(q, k, v, True, window)
        check(bool(torch.equal(got, again)), f"K6 rerun differs ({label})")
        del got, want, again
        ms = median_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, True, window), reps=5, launches=5)
        plain_ms = median_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, True, window), reps=3, warm=1)
        library_ms = median_ms(torch, sdpa(q, k, v, window), reps=5,
                               launches=5)
        dev_ms = device_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, True, window), "flash_hopper_kernel", calls=5)
        b_ms, b_by = attn_bound(B, S, S, H, K, hd, True, window, 2)
        rows[label] = dict(err=err, tile_rel_err=tile, ms=ms,
                           device_ms=dev_ms,
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=b_ms, bound_by=b_by)
        print(f"K6 {label} (B={B}, S={S}, H={H}, K={K}, hd={hd}, window="
              f"{window}) bf16: rerun bitwise equal; kernel_ms={ms:.4f} "
              f"(flash_hopper_kernel, profiler: {fmt_ms(dev_ms)}) plain_ms="
              f"{plain_ms:.4f} sdpa_ms={library_ms:.4f} bound_ms="
              f"{b_ms:.4f} ({b_by}); {b_ms / ms:.1%} of bound")
        del q, k, v
    label, B, S, H, K, hd, window = ATTN_LONG
    q, k, v = qkv(B, S, S, H, K, hd, torch.bfloat16)
    ms = median_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, True,
                                                          window), reps=3)
    library_ms = median_ms(torch, sdpa(q, k, v, window), reps=3)
    b_ms, b_by = attn_bound(B, S, S, H, K, hd, True, window, 2)
    rows[label] = dict(ms=ms, library_ms=library_ms, bound_ms=b_ms,
                       bound_by=b_by)
    print(f"K6 {label} (B={B}, S={S}, H={H}, K={K}, hd={hd}) bf16, one "
          f"timing: kernel_ms={ms:.4f} sdpa_ms={library_ms:.4f} bound_ms="
          f"{b_ms:.4f} ({b_by}); {b_ms / ms:.1%} of bound")
    del q, k, v
    main = rows[ATTN_SHAPES[0][0]]
    report = {"flash_attention": entry(
        "flash_attention", "flash_attention.cu",
        "src/repro/kernels/flash_attention.py:33", main["err"], main["ms"],
        main["plain_ms"], main["bound_ms"], main["bound_by"],
        main["library_ms"])}
    return report, rows


def logits_tol(logits, rel: float) -> float:
    return rel * (1.0 + float(logits.abs().max()))


def cell_cfg(sv):
    """The cell's config: the arch at full width, its depth cut to
    ``sv["layers"]`` where set, in ``sv["dtype"]`` where set."""
    from repro_torch.configs import get_config

    cfg = get_config(sv["arch"])
    if sv.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=sv["layers"])
    if sv.get("dtype"):
        cfg = dataclasses.replace(cfg, dtype=sv["dtype"])
    return cfg


def teacher_forced_logits(cfg, params, prompt, out, coins, sv, ctx=None):
    """The plain versions fed a run's greedy tokens ``out`` (B, steps):
    yields, per step, the (B, V) logits that step's token was chosen from
    (the prompt's last-token logits, from the prefill or, with a cross
    cache, its replay through decode as the engine runs it; then each
    decode step's), the run's audited steps replayed as audits with the
    same keys (``coins``: the run's audit coins).  So every step of every
    row can be held against the run, whether or not the two runs' greedy
    choices would part."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.engine import audit_decode

    B, S = prompt.shape
    steps = out.shape[1]
    tokens = torch.as_tensor(prompt, device=out.device)
    batch = {"tokens": tokens} if ctx is None else {"tokens": tokens,
                                                    "ctx": ctx}
    lg, cache = M.prefill(params, batch, cfg, cache_len=S + steps,
                          impl="torch")
    if "cross_k" in cache:
        for t in range(S):
            lg, cache = M.decode_step(params, tokens[:, t], t, cache, cfg)
    yield lg
    for i in range(steps - 1):
        if coins[i] < sv["q_audit"]:
            lg, cache, ok = audit_decode(params, out[:, i], S + i, cache, cfg,
                                         key=sv["seed"] + 1000 + i,
                                         impl="torch")
            check(ok, f"teacher-forced plain run: audit at step {i} failed")
        else:
            lg, cache = M.decode_step(params, out[:, i], S + i, cache, cfg)
        yield lg


def serve_audited(torch, cfg, params, prompt, steps, sv, ctx=None):
    """One ``ServeEngine.generate`` run with audits (and ``ctx``), the
    launch counts set to 0 just before: (engine, tokens, launches, the
    audit coins, the span and counter counts); checks one
    ``serve.audit_decode`` span and one ``serve.audits`` increment per
    audit, the audits equal to the seeded coins and no failure."""
    import numpy as np

    from repro_torch.obs import metrics as obmetrics
    from repro_torch.obs import trace as obtrace
    from repro_torch.serving import ServeEngine

    def serve():
        eng = ServeEngine(cfg, params, q_audit=sv["q_audit"],
                          seed=sv["seed"], record_logits=True)
        return eng, eng.generate(prompt, steps, ctx=ctx)

    def serve_counters():
        return (obmetrics.counter("serve.audits").value,
                obmetrics.counter("serve.audit_failures").value)

    obtrace.clear()
    before = serve_counters()
    (eng, out), launches = counted(serve)
    n_spans = sum(e["name"] == "serve.audit_decode" for e in obtrace.spans())
    audits_inc, failures_inc = (a - b for a, b in zip(serve_counters(),
                                                      before))
    print(f"serving {cfg.name} (B={prompt.shape[0]}, S={prompt.shape[1]}, "
          f"{steps} tokens, q_audit={sv['q_audit']}) launches: {launches}")
    print(f"serve.audit_decode spans {n_spans}, engine audits {eng.audits}; "
          f"counters serve.audits +{audits_inc}, serve.audit_failures "
          f"+{failures_inc}")
    check(n_spans == audits_inc == eng.audits
          and failures_inc == eng.audit_failures,
          f"{cfg.name}: serving spans or counters disagree with the "
          f"engine's audits")
    coins = np.random.default_rng(sv["seed"]).random(steps)
    want_audits = int((coins < sv["q_audit"]).sum())
    check(eng.audits == want_audits and eng.audit_failures == 0,
          f"audits {eng.audits} (want {want_audits}), failures "
          f"{eng.audit_failures}")
    check(tuple(out.shape) == (prompt.shape[0], steps) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()), "bad token array")
    check(all(bool(torch.isfinite(lg).all()) for lg in eng.logits),
          "non-finite logits")
    return eng, out, launches, coins, dict(
        audit_spans=n_spans, audit_counter_increments=audits_inc)


def check_serving_launches(cfg, launches, audits) -> None:
    """K6 once per attention of the prefill (every self-attention layer,
    encoder layer and cross-attention), K4s twice per audit, no other
    kernel."""
    from repro_torch.models.transformer import attn_layer_indices, num_cross

    want = {"flash_attention": cfg.encoder_layers + len(
        attn_layer_indices(cfg)) + num_cross(cfg), "sketch": 2 * audits}
    check(all(launches[k] == v for k, v in want.items()) and
          sum(launches.values()) == sum(want.values()),
          f"{cfg.name} serving launched {launches}, want {want} and "
          f"nothing else")


def tampered_replica_caught(cfg, params, prompt) -> None:
    """A Byzantine replica (examples/serve_audit.py: final-norm scale[0]
    x 3): its decode logits' audit sketch differs from the honest
    replica's, which a rerun of the honest one matches."""
    from repro_torch.core import detection
    from repro_torch.models import model as M
    from repro_torch.serving.engine import sketches_agree

    scale = params["final_norm"]["scale"].clone()
    scale[0] *= 3.0
    bad = dict(params, final_norm={"scale": scale})
    ks = detection.key_scalar_for_seed(7)

    def sketch_of(p):
        lg, _ = M.decode_step(p, prompt[:, 0], 0, M.allocate_cache(
            cfg, prompt.shape[0], 16, M.params_device(p)), cfg)
        return detection.hash_sign_sketch(lg.reshape(-1), ks)

    honest = sketch_of(params)
    caught = not sketches_agree(honest, sketch_of(bad))
    print(f"tampered replica caught by the audit sketch: {caught}")
    check(caught and sketches_agree(honest, sketch_of(params)),
          "the audit did not single out the tampered replica")


def decode_step_bytes(cfg, params, B: int, kv_len: int) -> float:
    """Bytes one decode step must move at batch B with ``kv_len`` valid
    cache positions: every layer weight once (every expert of an MoE
    layer: the reference's grouped products read all of them), the
    unembedding matrix read in bf16 and its f32 copy written and read
    (the reference's f32 unembed), the k/v of the valid positions read,
    the mamba state and conv buffers read and written, the cross caches
    read, the (B, V) f32 logits written."""
    from repro_torch.core import tree
    from repro_torch.models import model as M

    def nbytes(t):
        return sum(x.numel() * x.element_size() for x in tree.leaves(t))

    emb = params["embed"]
    table = (emb["tokens"] if cfg.tie_embeddings else emb["head"]).numel()
    cache = M.allocate_cache(cfg, B, kv_len, "meta")
    return (nbytes(params["layers"]) + table * (2 + 4 + 4)
            + nbytes([cache.get(n, []) for n in ("k", "v", "cross_k",
                                                 "cross_v")])
            + 2 * nbytes(cache.get("mamba", {})) + B * cfg.vocab_size * 4)


def decode_step_profile(torch, cfg, params, token, pos, cache, B) -> dict:
    """One decode step: its CUDA-event time, its kernels and the card's
    busy time in it (one profiler window), beside the byte bound."""
    from repro_torch.models import model as M

    def one_step():
        M.decode_step(params, token, pos, cache, cfg)

    step_ms = median_ms(torch, one_step, reps=5, warm=1)
    times = kernel_times(torch, one_step)
    busy_ms = sum(ms for ms, _ in times.values())
    n_kernels = sum(n for _, n in times.values())
    b_ms = decode_step_bytes(cfg, params, B, pos + 1) \
        / roofline().HBM_BYTES_S * 1e3
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:5]
    print(f"decode step (B={B}): {step_ms:.4f} ms (CUDA events), {n_kernels}"
          f" kernels, card busy {busy_ms:.4f} ms ({busy_ms / step_ms:.1%}); "
          f"byte bound {b_ms:.4f} ms ({b_ms / step_ms:.1%} of the step); by "
          f"device time: " + "; ".join(
              f"{name[:50]} {ms:.3f} ms x{n}" for name, (ms, n) in top))
    return dict(decode_step_ms=step_ms, decode_step_kernels=n_kernels,
                decode_step_busy_ms=busy_ms, decode_step_bound_ms=b_ms,
                decode_step_top=[(n[:80], ms, c) for n, (ms, c) in top])


def decode_replayed_bitwise(torch, cfg, params, cache, token, pos) -> None:
    """A decode step run twice on one cache: logits, k/v and new mamba
    tensors bitwise equal, the input cache's mamba tensors unchanged
    (the audit's premise)."""
    from repro_torch.models import model as M

    kept = {n: x.clone() for n, x in cache.get("mamba", {}).items()}
    l1, c1 = M.decode_step(params, token, pos, cache, cfg)
    kv1 = [cache[n][:, :, pos].clone() for n in ("k", "v") if n in cache]
    l2, c2 = M.decode_step(params, token, pos, cache, cfg)
    kv2 = [cache[n][:, :, pos] for n in ("k", "v") if n in cache]
    same = bool(torch.equal(l1, l2)) and all(
        torch.equal(a, b) for a, b in zip(kv1, kv2)) and all(
        torch.equal(cache["mamba"][n], kept[n]) and
        torch.equal(c1["mamba"][n], c2["mamba"][n]) for n in kept)
    print(f"decode step replayed on one cache: logits, k/v and new mamba "
          f"tensors bitwise equal, input cache unchanged: {same}")
    check(same, f"{cfg.name}: a replayed decode step differs or changed "
                f"its input cache")


class RoutingTape:
    """The MoE routing's discrete choices in one run (``record``): per
    ``moe.routing`` call, the expert indices, slots and keep; or those
    choices given to another run (``replay``), whose gates come from its
    own router probabilities at the replayed indices.  A top-k choice
    flips where a router margin lies under the attention kernel's bf16
    rounding, and a flip moves the capacity slots of every later token
    of its expert, so the plain versions' run is held against the
    kernels' with the kernels' routing, as it is fed their tokens.
    ``flips`` counts the replayed choices that the run's own routing
    would have made otherwise (expert or rank), of ``choices``.

    Under ``cfg.remat`` the backward runs each layer's forward again
    (``torch.utils.checkpoint``): a routing call made inside the backward
    is that recompute, so it is neither recorded nor given the next
    entry; it must equal, and is given, the choices of the same layer's
    forward (the last call on its router)."""

    def __init__(self):
        self.calls, self.flips, self.choices = [], 0, 0
        self.recomputes = 0
        self._last: dict = {}

    @staticmethod
    def _recompute() -> bool:
        import torch

        return torch._C._current_graph_task_id() != -1

    @contextlib.contextmanager
    def _patched(self, fn):
        from repro_torch.models import moe as moe_mod

        real = moe_mod.routing
        moe_mod.routing = lambda *a: fn(real, *a)
        try:
            yield self
        finally:
            moe_mod.routing = real

    def record(self):
        import torch

        from repro_torch.kernels import _account

        def fn(real, *a):
            out = real(*a)
            if _account.COUNTER is not None:
                # a step counted for the dry-run's comparison: the tape
                # keeps and compares nothing there, so it counts no bytes
                return out
            entry = (out[1], out[3], out[4])
            key = a[0]["router"].data_ptr()
            if self._recompute():
                self.recomputes += 1
                check(all(torch.equal(x, y) for x, y in
                          zip(entry, self._last[key])),
                      "a recomputed layer routed otherwise than its "
                      "forward")
            else:
                self.calls.append(entry)
                self._last[key] = entry
            return out

        return self._patched(fn)

    def replay(self, then_own: bool = False):
        """``then_own``: once the recorded calls are spent, the run routes
        as its own routing says (a run that goes on past the recorded
        one)."""
        import torch

        from repro_torch.kernels import _account
        from repro_torch.models import moe as moe_mod

        calls = iter(self.calls)

        def fn(real, *a):
            out = real(*a)
            probs, idx, _, _, _, C, _ = out
            key = a[0]["router"].data_ptr()
            if self._recompute():
                self.recomputes += 1
                if self._last[key] is None:
                    return out
                r_idx, r_slot, r_keep = self._last[key]
            else:
                entry = next(calls, None)
                if entry is None and then_own:
                    self._last[key] = None
                    return out
                r_idx, r_slot, r_keep = entry or (None,) * 3
                check(r_idx is not None and r_idx.shape == idx.shape,
                      "a routing replay does not match the recorded run's "
                      "calls")
                r_idx, r_slot, r_keep = (t.to(idx.device) for t in
                                         (r_idx, r_slot, r_keep))
                self._last[key] = (r_idx, r_slot, r_keep)
                self.flips += int((idx != r_idx).sum())
                self.choices += idx.numel()
            check(_account.COUNTER is None,
                  "a replayed routing is no operator of the model: a step "
                  "counted for the dry-run routes as its own routing says")
            g = probs.gather(1, r_idx)
            g = g / torch.clamp(g.sum(dim=-1, keepdim=True), min=1e-9)
            _, local = moe_mod.exclusive_slots(r_idx, probs.shape[-1])
            return (probs, r_idx, g * r_keep.to(g.dtype), r_slot, r_keep, C,
                    local)

        return self._patched(fn)


def drop_share(cfg, calls, N: int, label: str = "the kernel run") -> dict:
    """The prefill's routing (its MoE layers' ``RoutingTape`` calls):
    per layer the share of top-k choices the capacity dropped."""
    from repro_torch.models import moe as moe_mod

    shares = [float((~keep).sum()) / keep.numel() for _, _, keep in calls]
    C = moe_mod.capacity(cfg, N)
    print(f"prefill MoE routing of {label} (N = {N} tokens, C = {C}): "
          f"dropped share "
          f"of top-{cfg.moe.top_k} choices per MoE layer "
          f"{[round(x, 4) for x in shares]}, mean "
          f"{sum(shares) / len(shares):.4f}")
    return dict(capacity=C, dropped_share=shares,
                dropped_share_mean=sum(shares) / len(shares))


def audit_sketch_row(torch, d: int, name: str, dev) -> dict:
    """K4s at an audit's d (the (B, V) logits flattened) against its
    plain version, a rerun bitwise, and timed: a kernels-line row."""
    from repro_torch.kernels import sketch as sk

    x = torch.randn(d, generator=torch.Generator(device=dev).manual_seed(21),
                    device=dev)
    got, want = sk.sketch_cuda(x, 7), sk.sketch_plain(x, 7)
    err, rel = max_err(got, want), rel_err(got, want)
    check(rel <= 1e-5, f"K4s disagrees at the audit's d={d}")
    check(bool(torch.equal(got, sk.sketch_cuda(x, 7))),
          f"K4s rerun differs at d={d}")
    kk = 256
    ms = median_ms(torch, lambda: sk.sketch_cuda(x, 7), launches=50)
    plain_ms = median_ms(torch, lambda: sk.sketch_plain(x, 7), reps=5)
    signs = sign_table(torch, d + (-d) % kk, 7, dev).reshape(-1, kk)
    xs_ = torch.nn.functional.pad(x, (0, (-d) % kk)).reshape(-1, kk)
    library_ms = median_ms(torch, lambda: torch.einsum("mk,mk->k", xs_,
                                                       signs), launches=50)
    kb_ms, kb_by = kernel_bound("sketch", d=d, k=kk)
    print(f"K4s sketch at the audit's d={d}: max|kernel-plain| = "
          f"{err:.3e}, / max(1, max|plain|) = {rel:.3e} (tolerance 1e-5); "
          f"rerun bitwise equal; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"einsum_ms={library_ms:.4f} bound_ms={kb_ms:.4f} ({kb_by})")
    return entry(name, "sketch.cu", "src/repro/kernels/sketch.py:25", err,
                 ms, plain_ms, kb_ms, kb_by, library_ms)


def attention_row(rows, shape: str, name: str) -> dict:
    """A kernels-line row for K6 from ``phase_attention_kernel``'s
    measurement at a serving path's prefill shape."""
    r = rows[shape]
    return entry(name, "flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:33", r["err"], r["ms"],
                 r["plain_ms"], r["bound_ms"], r["bound_by"], r["library_ms"])


def small_serving_vs_cpu(torch, arch: str, S: int, replayed: bool) -> dict:
    """Reduced ``arch`` in f32 served on the card against the CPU (B = 2,
    an S-token prompt, 8 tokens, q_audit 0.5): the same audits, no
    failure; logits within 1e-4 (1 + max|.|) at every step whose earlier
    tokens agree.  ``replayed`` (a mamba or cross cache: the prompt
    replayed through decode): the tokens equal and the cache after the
    replay within 1e-4 (1 + max|.|); else the tokens under the margin
    rule.  A model that attends to a context gets one from a numpy seed,
    its gates at CTX_GATE, and its prefill's logits (which the replay's
    replace) are held too."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.transformer import uses_context
    from repro_torch.serving import ServeEngine, token_agreement

    rc = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rp = M.init(rc, 0, device="cpu")
    rprompt = np.random.default_rng(1).integers(0, rc.vocab_size,
                                                size=(2, S))
    ctx = None
    if uses_context(rc):
        set_gates(rp, CTX_GATE)
        ctx = context_draw(rc, 2, 1)
    batch = {"tokens": rprompt, "ctx": ctx}
    runs, caches, pre = {}, {}, {}
    for d_ in ("cpu", "cuda"):
        e = ServeEngine(rc, rp, q_audit=0.5, seed=0, device=d_,
                        record_logits=True)
        runs[d_] = (e, e.generate(rprompt, 8, ctx=ctx).cpu())
        if replayed:
            pre[d_], c = M.prefill(e.params, batch, rc, S + 8)
            for t in range(S):
                _, c = M.decode_step(e.params, rprompt[:, t], t, c, rc)
            parts = c["mamba"] if "mamba" in c else c
            caches[d_] = {n: x.cpu() for n, x in parts.items()}
    (ec, oc), (eg, og) = runs["cpu"], runs["cuda"]
    tol = logits_tol(torch.stack(ec.logits), 1e-4)
    err = max(max_err(eg.logits[i].cpu(), ec.logits[i])
              for i in range(8) if torch.equal(og[:, :i], oc[:, :i]))
    n_cmp, n_agr = token_agreement(ec.logits, oc, og, tol)
    cache_err = max((max_err(caches["cuda"][n], caches["cpu"][n]) /
                     (1 + float(caches["cpu"][n].abs().max()))
                     for n in caches.get("cpu", {})), default=0.0)
    pre_err = max_err(pre["cuda"].cpu(), pre["cpu"]) if ctx is not None \
        else 0.0
    print(f"small {rc.name} f32 card vs CPU: logits max|d| = {err:.3e} "
          f"(tolerance {tol:.3e}); tokens compared {n_cmp}, agreed "
          f"{n_agr}, equal {bool(torch.equal(og, oc))}; cache "
          f"max|d|/(1+max|.|) = {cache_err:.3e} (tolerance 1e-4); audits "
          f"{eg.audits} / {ec.audits}" + (
              f"; the prefill's logits with the context max|d| = "
              f"{pre_err:.3e}" if ctx is not None else ""))
    check(n_agr == n_cmp and n_cmp > 0 and eg.audits == ec.audits and
          eg.audit_failures == 0 and (torch.equal(og, oc) or not replayed),
          f"{rc.name}: card vs CPU tokens or audits differ")
    check(err <= tol and cache_err <= 1e-4 and pre_err <= tol,
          f"{rc.name}: card vs CPU logits or cache differ")
    return dict(logits_err=err, compared=n_cmp, agreed=n_agr,
                cache_err=cache_err, prefill_err=pre_err)


# the MoE serving cell: phi3.5-moe-42b-a6.6b at full width (d_model 4096,
# 32 heads, 8 kv heads of 128, 16 experts top-2 with d_ff 6400, vocab
# 32064 untied, bf16), random init, its depth cut from 32 to 16 layers
# (one layer is 1.30 B parameters, 2.60 GB: 32 layers do not fit the
# card's 80 GB), in the llama cell's traffic; K6 at its prefill shape
# (4, 4096, 32, 8, 128) is phase_attention_kernel's hd-128 shape
MOE_SERVE = dict(SERVE, arch="phi3.5-moe-42b-a6.6b", layers=16,
                 k6_shape="qwen3-4b and phi3.5-moe prefill",
                 small=("phi3.5-moe-42b-a6.6b",), tag="moe_serving")


def phase_serving(torch, attention, sv):
    """``sv``'s model (SERVE: llama3.2-1b; MOE_SERVE: phi3.5-moe at 16 of
    32 layers) served at full width through ServeEngine.generate, against
    the same run with the plain versions and the plain versions fed its
    tokens; a decode step replayed on one cache and profiled; the MoE
    prefill's dropped share; the tampered replica; reduced configs in
    f32 on the card against the CPU.  Returns (launches, kernels-line
    rows of its own (those of a cell with a ``tag``), report)."""
    import gc

    import numpy as np

    from repro_torch.configs.base import layer_kinds
    from repro_torch.models import model as M
    from repro_torch.serving import ServeEngine, token_agreement

    gc.collect()
    torch.cuda.empty_cache()
    cfg = cell_cfg(sv)
    B, S, steps = sv["B"], sv["S"], sv["steps"]
    t0 = time.perf_counter()
    params = M.init(cfg, sv["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dev = M.params_device(params)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               size=(B, S))
    # warm-up (cuBLAS handles, the kernel libraries): a short run
    ServeEngine(cfg, params).generate(prompt[:, :256], 2)

    def serve(impl=None):
        eng = ServeEngine(cfg, params, q_audit=sv["q_audit"],
                          seed=sv["seed"], impl=impl, record_logits=True)
        return eng, eng.generate(prompt, steps)

    tape = RoutingTape()
    with tape.record():
        eng, out, launches, coins, spans = serve_audited(
            torch, cfg, params, prompt, steps, sv)
    check_serving_launches(cfg, launches, eng.audits)
    k6_ms = attention[sv["k6_shape"]]["ms"]
    prefill_s, audit_s = eng.phase_s["prefill"], eng.phase_s["audit"]
    decode_s = eng.phase_s["decode"] + audit_s        # every step
    plain_steps = steps - eng.audits
    k6_share = cfg.num_layers * k6_ms / (prefill_s * 1e3)
    print(f"model init {init_s:.4f} s; prefill {prefill_s:.4f} s; decode "
          f"{decode_s:.4f} s = {decode_s / steps * 1e3:.4f} ms per step, "
          f"{B * steps / decode_s:.1f} tokens/s (unaudited steps "
          f"{eng.phase_s['decode'] / max(1, plain_steps) * 1e3:.4f} ms each, "
          f"audited {audit_s / max(1, eng.audits) * 1e3:.4f} ms each); K6 "
          f"{cfg.num_layers} x {k6_ms:.4f} ms = {k6_share:.1%} of the "
          f"prefill; audits {eng.audits}, failures {eng.audit_failures}")
    extra = {}
    if cfg.moe:
        n_moe = sum(k.ffn == "moe" for k in layer_kinds(cfg))
        extra = drop_share(cfg, tape.calls[:n_moe], B * S)
        # the plain versions' prefill with their own routing: not held
        own = RoutingTape()
        with own.record():
            lg_own, _ = M.prefill(params, {"tokens": prompt}, cfg,
                                  impl="torch")
        flips = sum(int((a[0] != b[0]).sum()) for a, b in
                    zip(own.calls, tape.calls[:n_moe]))
        extra.update(own_routing_prefill_err=max_err(lg_own, eng.logits[0]),
                     own_routing_flips=flips,
                     own_routing_dropped_share_mean=drop_share(
                         cfg, own.calls, B * S, "the plain versions")[
                             "dropped_share_mean"])
        print(f"plain prefill with its own routing (not held): last-token "
              f"logits max|d| = {extra['own_routing_prefill_err']:.3e}; "
              f"{flips} of {n_moe * B * S * cfg.moe.top_k} top-k choices "
              f"differ from the kernel run's (expert or rank)")
        del lg_own, own

    with tape.replay():
        eng_p, out_p = serve("torch")
    check(eng_p.audits == eng.audits and eng_p.audit_failures == 0,
          "plain run: audits differ")
    tol = logits_tol(eng_p.logits[0], 3e-2)
    prefill_err = max_err(eng.logits[0], eng_p.logits[0])
    compared, agreed = token_agreement(eng_p.logits, out_p, out, tol)
    # how far each row's tokens run equal from the start; while they do,
    # that row's logits are held to the same tolerance
    lead = [next((i for i in range(steps) if out[r, i] != out_p[r, i]),
                 steps) for r in range(B)]
    step_err = max(max_err(eng.logits[i][r], eng_p.logits[i][r])
                   for r in range(B) for i in range(lead[r] + 1)
                   if i < steps)
    print(f"kernels vs plain" + (" (the plain run given the kernel run's "
                                   "routing)" if cfg.moe else "") +
          f": prefill last-token logits max|d| = "
          f"{prefill_err:.3e} (tolerance {tol:.3e}); greedy tokens compared "
          f"under the margin rule {compared}, agreed {agreed} of "
          f"{B * steps}; each row's tokens equal for its first {lead} "
          f"steps, its logits there max|d| = {step_err:.3e}; plain "
          f"prefill {eng_p.phase_s['prefill']:.4f} s")
    check(prefill_err <= tol,
          "prefill logits differ between kernels and plain")
    check(step_err <= tol, "decode logits differ between kernels and plain "
                           "while the tokens agree")
    check(agreed == compared, "greedy tokens differ between kernels and plain")
    del eng_p, out_p

    forced_err, forced_held, forced_worst = 0.0, 0, 0.0
    forced = RoutingTape()
    forced.calls = tape.calls
    with forced.replay():
        for i, lg in enumerate(teacher_forced_logits(cfg, params, prompt,
                                                     out, coins, sv)):
            for r in range(B):
                e = max_err(eng.logits[i][r], lg[r])
                t = logits_tol(lg[r], 3e-2)
                forced_err = max(forced_err, e)
                forced_worst = max(forced_worst, e / t)
                forced_held += int(e <= t)
    print(f"kernels vs plain, teacher-forced (the kernel run's tokens"
          + (" and routing" if cfg.moe else "") + f" fed to the plain "
          f"versions): {forced_held} of {B * steps} step-rows within "
          f"3e-2*(1+max|logits|), max|d| = {forced_err:.3e} (worst "
          f"{forced_worst:.3f} of its tolerance)"
          + (f"; their own routing would differ in {forced.flips} of "
             f"{forced.choices} choices" if cfg.moe else ""))
    extra.update(forced_routing_flips=forced.flips,
                 forced_routing_choices=forced.choices)
    del tape, forced
    check(forced_held == B * steps, "teacher-forced decode logits differ "
                                    "between kernels and plain")

    _, cache = M.prefill(params, {"tokens": prompt}, cfg,
                         cache_len=S + steps)
    decode_replayed_bitwise(torch, cfg, params, cache, out[:, 0], S)
    extra.update(decode_step_profile(torch, cfg, params, out[:, 0], S, cache,
                                     B))
    del cache
    tampered_replica_caught(cfg, params, prompt)
    audits, failures = eng.audits, eng.audit_failures
    del params, eng
    gc.collect()
    torch.cuda.empty_cache()

    rows = {}
    if sv.get("tag"):
        tag = sv["tag"]
        rows[f"flash_attention_{tag}"] = attention_row(
            attention, sv["k6_shape"], f"flash_attention_{tag}")
        rows[f"sketch_{tag}"] = audit_sketch_row(
            torch, B * cfg.vocab_size, f"sketch_{tag}", dev)
    small = {arch: small_serving_vs_cpu(torch, arch, 40, False)
             for arch in sv["small"]}
    return launches, rows, dict(
        init_s=init_s, prefill_s=prefill_s, decode_s=decode_s,
        audit_s=audit_s, leading_equal_tokens_vs_plain=lead,
        step_logits_err_vs_plain=step_err,
        decode_ms_per_step=decode_s / steps * 1e3,
        tokens_per_s=B * steps / decode_s, k6_share_of_prefill=k6_share,
        audits=audits, audit_failures=failures, **spans,
        prefill_logits_err_vs_plain=prefill_err,
        tokens_compared=compared, forced_step_rows_held=forced_held,
        forced_logits_err=forced_err, tokens_agreed=agreed,
        small_vs_cpu=small, **extra)


# the mamba serving cell: mamba2-780m at full width (48 layers, d_model
# 1536, d_inner 3072, 48 heads of 64, d_state 128, chunk 256, vocab
# 50280 tied, bf16), random init, seed 0; B = 4, a 512-token prompt (two
# SSD chunks), 32 greedy tokens, q_audit = 0.25
MAMBA_SERVE = dict(arch="mamba2-780m", B=4, S=512, steps=32, q_audit=0.25,
                   seed=0, tag="mamba_audit")
# the hybrid serving cell: jamba-v0.1-52b at full width (d_model 4096,
# d_inner 8192, 128 SSM heads of 64, d_state 16, 32 heads / 8 kv heads of
# 128, 16 experts top-2 with d_ff 14336, vocab 65536 untied, bf16),
# random init, its depth cut from 32 to 8 layers, one attention period
# (7 mamba layers and attention at 4; MoE on the odd layers, the MLP on
# the even ones; 12.7 B parameters in the layers); the mamba cell's
# traffic; K6 once, in the attention layer's prefill
HYBRID_SERVE = dict(MAMBA_SERVE, arch="jamba-v0.1-52b", layers=8,
                    k6_shape="jamba-v0.1-52b prefill", tag="jamba_serving")
# the chunked prefill's last-position logits against the logits of the
# prompt replayed token by token through decode, as max|d| <=
# MAMBA_CHUNKED_REL * (1 + max|replay logits|): bf16 rounding over 48
# layers, in other places in the two (the prefill's conv rounds after
# each shifted add, the decode's once; other GEMM shapes).  Read on an
# H100: 2.67e-2 (argmax equal in 4 of 4 rows); in f32 the two agree to
# 3e-6, and in bf16 each lies about 3e-2 from the f32 logits (48 layers
# at d_model 256 on the CPU).  For an MoE model the prefill takes a
# capacity that drops no choice (a decode step of B = 4 tokens never
# drops one: C = 8 >= B), so that the two compute the same function
MAMBA_CHUNKED_REL = 5e-2


def phase_serving_replayed(torch, attention, sv):
    """``sv``'s model (MAMBA_SERVE: mamba2-780m; HYBRID_SERVE: jamba at 8
    of 32 layers) served at full width through ServeEngine.generate (the
    chunked prefill, the prompt replayed through decode to fill the SSM
    cache, audited greedy decode): the audits against the seeded coins,
    K6 once per attention layer and K4s twice an audit, the spans and
    counters, the chunked prefill's logits against the replay's, a
    decode step replayed on one cache, the tampered replica, K4s at the
    audit's shape against its plain version, and the reduced model in
    f32 on the card against the CPU (jamba also one training step).
    Returns (launches, kernels-line rows, report)."""
    import gc

    import numpy as np

    from repro_torch.configs.base import layer_kinds
    from repro_torch.models import model as M
    from repro_torch.serving import ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = cell_cfg(sv)
    B, S, steps = sv["B"], sv["S"], sv["steps"]
    t_phase = time.perf_counter()
    params = M.init(cfg, sv["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    dev = M.params_device(params)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               size=(B, S))
    ServeEngine(cfg, params).generate(prompt[:, :16], 2)     # warm-up

    tape = RoutingTape()
    with tape.record():
        eng, out, launches, _, spans = serve_audited(torch, cfg, params,
                                                     prompt, steps, sv)
    check_serving_launches(cfg, launches, eng.audits)
    ph = eng.phase_s
    decode_s = ph["decode"] + ph["audit"]
    plain_steps = steps - eng.audits
    print(f"model init {init_s:.4f} s; prefill {ph['prefill']:.4f} s; "
          f"replay {ph['replay']:.4f} s ({ph['replay'] / S * 1e3:.4f} ms a "
          f"prompt token); decode {decode_s:.4f} s = "
          f"{decode_s / steps * 1e3:.4f} ms per step, "
          f"{B * steps / decode_s:.1f} tokens/s (unaudited steps "
          f"{ph['decode'] / max(1, plain_steps) * 1e3:.4f} ms each, audited "
          f"{ph['audit'] / max(1, eng.audits) * 1e3:.4f} ms each); audits "
          f"{eng.audits}, failures {eng.audit_failures}")

    # the chunked SSD against the sequential replay, at full width; with
    # MoE layers, the prefill at a capacity that drops nothing and with
    # the replay's routing (a decode step of B tokens drops nothing)
    extra, same_fn, routed = {}, cfg, contextlib.nullcontext()
    rep = eng.logits[0]
    if cfg.moe:
        n_moe = sum(k.ffn == "moe" for k in layer_kinds(cfg))
        extra = drop_share(cfg, tape.calls[:n_moe], B * S)
        same_fn = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        for name, c in (("dropping", cfg), ("own_routing", same_fn)):
            lg, _ = M.prefill(params, {"tokens": prompt}, c)
            extra[f"{name}_prefill_vs_replay_err"] = max_err(lg, rep)
        replay = RoutingTape()
        for j in range(n_moe):
            idx = torch.stack([tape.calls[n_moe * (1 + t) + j][0]
                               for t in range(S)], dim=1).reshape(B * S, -1)
            flat = torch.nn.functional.one_hot(
                idx, cfg.moe.num_experts).reshape(idx.numel(), -1)
            slot = ((flat.cumsum(0) - flat) * flat).sum(-1).reshape(idx.shape)
            replay.calls.append((idx, slot, torch.ones_like(slot,
                                                            dtype=torch.bool)))
        routed = replay.replay()
    with routed:
        pre, _ = M.prefill(params, {"tokens": prompt}, same_fn)
    if cfg.moe:
        extra.update(replay_routing_flips=replay.flips,
                     replay_routing_choices=replay.choices)
    del tape
    chunk_err = max_err(pre, rep)
    chunk_tol = logits_tol(rep, MAMBA_CHUNKED_REL)
    scale = chunk_tol / MAMBA_CHUNKED_REL                  # 1 + max|logits|
    same_top = int((pre.argmax(-1) == rep.argmax(-1)).sum())
    print(f"chunked prefill vs replayed prompt, last-position logits: "
          f"max|d| = {chunk_err:.4e}, {chunk_err / scale:.4e} of 1 + "
          f"max|logits| = {scale:.4f} "
          f"(limit {MAMBA_CHUNKED_REL}); argmax equal in {same_top} of {B} "
          f"rows" + (f" (the no-drop prefill given the replay's routing, "
                     f"whose own would differ in {replay.flips} of "
                     f"{replay.choices} choices); not held: with its own "
                     f"routing max|d| = "
                     f"{extra['own_routing_prefill_vs_replay_err']:.4e}, at "
                     f"the config's capacity (which drops) "
                     f"{extra['dropping_prefill_vs_replay_err']:.4e}"
                     if cfg.moe else ""))
    check(chunk_err <= chunk_tol, "the chunked prefill's logits differ from "
                                  "the replay's")

    cache = M.allocate_cache(cfg, B, S + steps, dev)
    for t in range(4):
        _, cache = M.decode_step(params, prompt[:, t], t, cache, cfg)
    decode_replayed_bitwise(torch, cfg, params, cache, prompt[:, 4], 4)
    extra.update(decode_step_profile(torch, cfg, params, out[:, 0], 5, cache,
                                     B))
    tampered_replica_caught(cfg, params, prompt)
    audits, failures = eng.audits, eng.audit_failures
    del params, cache, eng
    gc.collect()
    torch.cuda.empty_cache()

    tag = sv["tag"]
    rows = {f"sketch_{tag}": audit_sketch_row(
        torch, B * cfg.vocab_size, f"sketch_{tag}", dev)}
    if sv.get("k6_shape"):
        rows[f"flash_attention_{tag}"] = attention_row(
            attention, sv["k6_shape"], f"flash_attention_{tag}")
    small = small_serving_vs_cpu(torch, sv["arch"], 32, True)
    if cfg.moe:
        small["train"] = train_small_vs_cpu(torch, sv["arch"], steps=1)
    phase_s = time.perf_counter() - t_phase
    print(f"phase_serving_replayed ({cfg.name}): {phase_s:.1f} s")
    return launches, rows, dict(
        init_s=init_s, phase_s_split=ph, decode_s=decode_s,
        decode_ms_per_step=decode_s / steps * 1e3,
        replay_ms_per_token=ph["replay"] / S * 1e3,
        tokens_per_s=B * steps / decode_s, audits=audits,
        audit_failures=failures, **spans, chunked_vs_replay_err=chunk_err,
        chunked_vs_replay_tol=chunk_tol, argmax_equal_rows=same_top,
        small_vs_cpu=small, phase_s=phase_s, **extra)


# the context cells (bf16, random init, seed 0; each ctx (B, Tctx,
# d_model) standard normals from np.random.default_rng, seeds 1 and 2).
# whisper-tiny at full size (configs/whisper_tiny.py: 4 encoder and 4
# decoder layers, d_model 384, 6 heads of 64, d_ff 1536, vocab 51865
# tied; 41 M parameters), B = 4, ctx (4, 1500, 384), a 128-token prompt
# (160 positions stay under the released model's 448), 32 tokens,
# q_audit 0.25; K6 12 times a prefill: the encoder (4, 1500, 1500, 6, 6,
# 64) non-causal, decoder self-attention (4, 128, 128) causal,
# cross-attention (4, 128, 1500) non-causal
WHISPER_SERVE = dict(arch="whisper-tiny", B=4, S=128, steps=32,
                     q_audit=0.25, seed=0, tag="whisper")
# llama-3.2-vision-90b at full width (configs/llama_3_2_vision_90b.py:
# d_model 8192, 64 heads / 8 kv heads of 128, d_ff 28672, vocab 128256
# untied), its depth cut from 100 to 10 layers: two periods of 5,
# cross-attention at 4 and 9 (a layer is 855.6 M parameters; the 100
# layers are 171 GB, more than the card's 80; the 10 and the embeddings
# 10.66 B parameters, 21.3 GB); the mamba cell's traffic with ctx (4,
# 1601, 8192); K6 10 times a prefill: self-attention (4, 512, 512, 64,
# 8, 128) causal, cross-attention (4, 512, 1601) non-causal
VISION_SERVE = dict(arch="llama-3.2-vision-90b", layers=10, B=4, S=512,
                    steps=32, q_audit=0.25, seed=0, tag="vision")
# every cross-attention layer's gate after init: the reference
# initializes gate_attn to 0, and tanh(0) = 0 makes a cross-attention
# layer add nothing, so a phase at 0 would check nothing of it
CTX_GATE = 0.5


def set_gates(params, value: float) -> None:
    """Every ``cross_attn`` layer's ``gate_attn`` set to ``value``."""
    for p in params["layers"]:
        if "gate_attn" in p["mixer"]:
            p["mixer"]["gate_attn"].fill_(value)


def context_draw(cfg, B: int, seed: int):
    """A (B, Tctx, d_model) f32 context of standard normals."""
    import numpy as np

    T = (cfg.num_encoder_positions if cfg.is_encoder_decoder
         else cfg.num_vision_tokens)
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model), dtype=np.float32)


def context_shifted(ctx, seed: int):
    """``ctx`` plus one (B, 1, d_model) standard-normal offset a row,
    shared by all its positions (as the patches of one image share their
    statistics).  Two i.i.d. contexts differ in ways that cross-attention
    averages away: its weights over 1601 keys are near uniform at random
    init, so each output row is a mean of 1601 i.i.d. values, and at
    llama-3.2-vision-90b's width two such contexts move the last-token
    logits about as much as bf16 rounding does; a shared offset moves
    every key and value alike and survives the mean."""
    import numpy as np

    B, _, D = ctx.shape
    return ctx + np.random.default_rng(seed).standard_normal(
        (B, 1, D), dtype=np.float32)


def ctx_attention_shapes(cfg, B: int, S: int) -> dict:
    """{label: ((B, Sq, Sk, H, K, hd, causal), launches)} of K6 in one
    prefill of a model that attends to a context: the encoder's layers,
    the self-attention layers, the cross-attentions."""
    from repro_torch.models.transformer import attn_layer_indices, num_cross

    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T = (cfg.num_encoder_positions if cfg.is_encoder_decoder
         else cfg.num_vision_tokens)
    out = {"encoder": ((B, T, T, H, K, hd, False), cfg.encoder_layers),
           "self": ((B, S, S, H, K, hd, True), len(attn_layer_indices(cfg))),
           "cross": ((B, S, T, H, K, hd, False), num_cross(cfg))}
    return {k: v for k, v in out.items() if v[1]}


@contextlib.contextmanager
def attention_tape():
    """K6's launches by shape while open: {(B, Sq, Sk, H, K, hd, causal):
    launches}."""
    from repro_torch.kernels import flash_attention as fa

    real, seen = fa.flash_attention_cuda, {}

    def taped(q, k, v, causal=True, window=None, scale=None):
        key = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
               bool(causal))
        seen[key] = seen.get(key, 0) + 1
        return real(q, k, v, causal, window, scale)

    fa.flash_attention_cuda = taped
    try:
        yield seen
    finally:
        fa.flash_attention_cuda = real


def ctx_attention_rows(torch, shapes, tag: str) -> dict:
    """K6 at each of a context cell's prefill shapes against its plain
    version (``held_attention``'s bf16 bounds), a rerun bitwise, and
    timed beside the plain version, SDPA (``is_causal`` as the shape,
    ``enable_gqa``) and the bound: kernels-line rows
    ``flash_attention_<tag>_<label>`` with the cell's launches."""
    from repro_torch.kernels import flash_attention as fa

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    rows = {}
    for label, ((B, Sq, Sk, H, K, hd, causal), n) in shapes.items():
        q, k, v = [torch.randn(*s, generator=gen, device=dev).to(
            torch.bfloat16) for s in ((B, Sq, H, hd), (B, Sk, K, hd),
                                      (B, Sk, K, hd))]
        what = f"{tag} {label} ({B}, {Sq}, {Sk}, {H}, {K}, {hd}, causal=" \
               f"{causal})"
        got = fa.flash_attention_cuda(q, k, v, causal)
        want = fa.flash_attention_plain(q, k, v, causal)
        err, tile = held_attention(got, want, torch.bfloat16, what)
        check(bool(torch.equal(got, fa.flash_attention_cuda(q, k, v,
                                                            causal))),
              f"K6 rerun differs at {what}")
        ms = median_ms(torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                              causal),
                       launches=10)
        plain_ms = median_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal), reps=3, warm=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), launches=10)
        dev_ms = device_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, causal), "flash", calls=10)
        b_ms, b_by = attn_bound(B, Sq, Sk, H, K, hd, causal, None, 2)
        name = f"flash_attention_{tag}_{label}"
        rows[name] = entry(name, "flash_attention.cu",
                           "src/repro/kernels/flash_attention.py:33", err,
                           ms, plain_ms, b_ms, b_by, library_ms)
        rows[name].update(launches=n, device_ms=dev_ms, tile_rel_err=tile)
        print(f"K6 {what}: rerun bitwise equal; kernel_ms={ms:.4f} (device "
              f"{fmt_ms(dev_ms)}) plain_ms={plain_ms:.4f} sdpa_ms="
              f"{library_ms:.4f} bound_ms={b_ms:.4f} ({b_by}); "
              f"{b_ms / ms:.1%} of bound; {n} launches a prefill")
        del q, k, v, qt, kt, vt, got, want
    return rows


def phase_serving_ctx(torch, sv):
    """``sv``'s model (WHISPER_SERVE: whisper-tiny; VISION_SERVE:
    llama-3.2-vision-90b at 10 of 100 layers) served at full width with
    a context through ServeEngine.generate (the prefill with the encoder
    and cross-attention, then the prompt replayed through decode over
    the zero cross caches, as the reference does, and audited greedy
    decode): the audits against the seeded coins, K6 at each prefill
    shape as many times as the model has such attentions, K4s twice an
    audit, the spans and counters; the prefill's logits with the kernels
    against the plain versions, and moved by the context beyond that
    tolerance; the tokens the same under a second context; the
    plain versions fed the kernel run's tokens; a decode step replayed
    on one cache, the cross caches left zero; the tampered replica; K6
    at the cell's shapes and K4s at the audit's against their plain
    versions; the reduced model in f32 on the card against the CPU.
    Returns (launches, kernels-line rows with their launches, report)."""
    import gc

    import numpy as np

    from repro_torch.core import tree
    from repro_torch.models import model as M
    from repro_torch.serving import ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = cell_cfg(sv)
    B, S, steps, tag = sv["B"], sv["S"], sv["steps"], sv["tag"]
    t_phase = time.perf_counter()
    params = M.init(cfg, sv["seed"])
    set_gates(params, CTX_GATE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    n_params = sum(x.numel() for x in tree.leaves(params))
    dev = M.params_device(params)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               size=(B, S))
    ctxs = [context_draw(cfg, B, seed) for seed in (1, 2)]
    print(f"{cfg.name}: {cfg.num_layers} decoder layers, "
          f"{cfg.encoder_layers} encoder layers, {n_params} parameters "
          f"(init {init_s:.4f} s), cross-attention gates {CTX_GATE}; ctx "
          f"{ctxs[0].shape}")
    ServeEngine(cfg, params).generate(prompt[:, :16], 2, ctx=ctxs[0])

    with attention_tape() as taped:
        eng, out, launches, coins, spans = serve_audited(
            torch, cfg, params, prompt, steps, sv, ctx=ctxs[0])
    check_serving_launches(cfg, launches, eng.audits)
    shapes = ctx_attention_shapes(cfg, B, S)
    want = {shape: n for shape, n in shapes.values()}
    print(f"K6 launches by shape (B, Sq, Sk, H, K, hd, causal): {taped}")
    check(taped == want, f"{cfg.name}: K6 launched {taped}, want {want}")
    ph = eng.phase_s
    decode_s = ph["decode"] + ph["audit"]
    plain_steps = steps - eng.audits
    print(f"prefill {ph['prefill']:.4f} s; replay {ph['replay']:.4f} s "
          f"({ph['replay'] / S * 1e3:.4f} ms a prompt token); decode "
          f"{decode_s:.4f} s = {decode_s / steps * 1e3:.4f} ms per step, "
          f"{B * steps / decode_s:.1f} tokens/s (unaudited steps "
          f"{ph['decode'] / max(1, plain_steps) * 1e3:.4f} ms each, audited "
          f"{ph['audit'] / max(1, eng.audits) * 1e3:.4f} ms each); audits "
          f"{eng.audits}, failures {eng.audit_failures}")

    # the prefill's logits, which the replay's replace in generate: the
    # kernels against the plain versions; moved by the second i.i.d.
    # context (reported) and by the first one shifted (held beyond the
    # tolerance: the context is live)
    batch = {"tokens": prompt, "ctx": ctxs[0]}
    pre, _ = M.prefill(params, batch, cfg)
    pre_plain, _ = M.prefill(params, batch, cfg, impl="torch")
    tol = logits_tol(pre_plain, 3e-2)
    pre_err = max_err(pre, pre_plain)
    moved = {}
    for name, c in (("iid", ctxs[1]), ("shifted", context_shifted(ctxs[0],
                                                                  3))):
        other, _ = M.prefill(params, {"tokens": prompt, "ctx": c}, cfg)
        moved[name] = max_err(other, pre)
        del other
    print(f"prefill last-token logits: kernels vs plain max|d| = "
          f"{pre_err:.4e} (tolerance {tol:.4e} = 3e-2 (1 + max|.|)); the "
          f"second i.i.d. context moves them by {moved['iid']:.4e} (not "
          f"held), the first one with a shared offset a row by "
          f"{moved['shifted']:.4e} (held: more than the tolerance)")
    check(pre_err <= tol, f"{cfg.name}: prefill logits differ between "
                          f"kernels and plain")
    check(moved["shifted"] > tol, f"{cfg.name}: the context does not reach "
                                  f"the prefill's logits")
    del pre, pre_plain

    # generate under the second context: the same tokens, since the
    # replay and decode read the zero cross caches (the reference's too)
    other = ServeEngine(cfg, params, q_audit=sv["q_audit"], seed=sv["seed"])
    same_tokens = bool(torch.equal(other.generate(prompt, steps,
                                                  ctx=ctxs[1]), out))
    print(f"generate's tokens under the second context equal the first's: "
          f"{same_tokens}")
    check(same_tokens, f"{cfg.name}: generate's tokens depend on ctx")
    del other

    forced_err, forced_held = 0.0, 0
    for i, lg in enumerate(teacher_forced_logits(cfg, params, prompt, out,
                                                 coins, sv, ctx=ctxs[0])):
        for r in range(B):
            e = max_err(eng.logits[i][r], lg[r])
            forced_err = max(forced_err, e)
            forced_held += int(e <= logits_tol(lg[r], 3e-2))
    print(f"kernels vs plain, teacher-forced (the kernel run's tokens fed "
          f"to the plain versions, the prompt replayed): {forced_held} of "
          f"{B * steps} step-rows within 3e-2*(1+max|logits|), max|d| = "
          f"{forced_err:.3e}")
    check(forced_held == B * steps, "teacher-forced decode logits differ "
                                    "between kernels and plain")

    _, cache = M.prefill(params, batch, cfg, cache_len=S + steps)
    decode_replayed_bitwise(torch, cfg, params, cache, out[:, 0], S)
    extra = decode_step_profile(torch, cfg, params, out[:, 0], S, cache, B)
    zero = not (cache["cross_k"].any() or cache["cross_v"].any())
    print(f"the cross caches after prefill and decode steps are zero: "
          f"{zero}")
    check(zero, f"{cfg.name}: a cross cache was written")
    tampered_replica_caught(cfg, params, prompt)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    audits, failures = eng.audits, eng.audit_failures
    del params, cache, eng
    gc.collect()
    torch.cuda.empty_cache()

    rows = ctx_attention_rows(torch, shapes, tag)
    sketch_row = audit_sketch_row(torch, B * cfg.vocab_size,
                                  f"sketch_{tag}_audit", dev)
    sketch_row["launches"] = launches["sketch"]
    rows[sketch_row["name"]] = sketch_row
    check(sum(r["launches"] for r in rows.values()) ==
          sum(launches.values()), f"{cfg.name}: rows miss launches")
    small = small_serving_vs_cpu(torch, sv["arch"], 24, True)
    phase_s = time.perf_counter() - t_phase
    print(f"phase_serving_ctx ({cfg.name}): {phase_s:.1f} s; peak memory "
          f"{peak_gib:.2f} GiB")
    return launches, rows, dict(
        init_s=init_s, parameters=n_params, phase_s_split=ph,
        decode_s=decode_s, decode_ms_per_step=decode_s / steps * 1e3,
        replay_ms_per_token=ph["replay"] / S * 1e3,
        tokens_per_s=B * steps / decode_s, audits=audits,
        audit_failures=failures, **spans, k6_by_shape={
            str(k): n for k, n in taped.items()},
        prefill_logits_err_vs_plain=pre_err, prefill_tol=tol,
        prefill_moved_by_ctx=moved, tokens_same_under_ctx=same_tokens,
        forced_step_rows_held=forced_held, forced_logits_err=forced_err,
        peak_gib=peak_gib, small_vs_cpu=small, phase_s=phase_s, **extra)


# the training cell: llama3.2-1b at full width (16 layers, d_model 2048,
# vocab 128256, bf16), random init, n = 8 workers of which f = 2 may be
# Byzantine, sequence 256, global batch 16, AdamW; sign_flip on workers
# 2 and 5, which tamper every time (p_tamper 1)
TRAIN = dict(arch="llama3.2-1b", n=8, f=2, seq_len=256, global_batch=16,
             byz=(2, 5), scale=10.0, lr=1e-4, steps=3)
# the mamba training cell: mamba2-780m at full width (d_model 1536,
# d_inner 3072, 48 heads of 64, d_state 128, chunk 256, vocab 50280
# tied, bf16) in TRAIN's protocol and batch: each layer's four or five
# (rows, 1, 48, 256, 256) f32 intra-chunk tensors (about 1.3 GB a layer
# at 16 rows) live only while that layer runs, as every layer is
# checkpointed (cfg.remat).  Its depth is cut from 48 layers to 8 to
# keep the script inside its time limit beside the model axis's phase
# (its host-bound steps run about 170,000 kernels at 48);
# ``scripts/chip_phases.py mamba_full`` runs all 48
MAMBA_TRAIN = dict(TRAIN, arch="mamba2-780m", layers=8)
# the MoE training cell: phi3.5-moe-42b-a6.6b at full width (MOE_SERVE's
# widths), its depth cut from 32 layers to 1 (1.56 B parameters with the
# embeddings, 1.26x llama3.2-1b's 1.24 B), in TRAIN's protocol and batch;
# the identify vote stacks 5 replicas of an expert leaf (1, 16, 4096,
# 6400) in f32: 2,097,152,000 elements, 8.39 GB
MOE_TRAIN = dict(TRAIN, arch="phi3.5-moe-42b-a6.6b", layers=1)
# the kernels' training run against the plain versions' run (bf16
# weights, K6's bf16 P.V against the plain version's f32 one): the first
# loss (the forward alone), relatively; each later loss's drop from the
# first, relatively to the plain run's drop; and each leaf's update
# p_final - p_init, as ||p_kern - p_plain|| / ||update_plain||.  A leaf
# that the plain run leaves unchanged (the norm scales: an update of
# 3e-4 is under half of bf16's ulp at 1.0) must stay unchanged.  The
# planted control, the update with two sign-flipped gradients in the
# mean, must exceed the drop and update limits on every moving leaf.
# Readings on an H100 (PERF.md section 6): the kernels' run 3.5e-6,
# 3.1e-4 and 0.010..0.066; the planted control's drop 1.9 and updates
# 1.60..1.65.
TRAIN_LOSS0_REL = 1e-4
TRAIN_DROP_REL = 1e-2
TRAIN_UPDATE_REL = 0.2


def train_cfg_objects(spec):
    from repro_torch.core.randomized import BFTConfig
    from repro_torch.optim import OptConfig
    from repro_torch.train import AttackConfig, TrainerConfig

    cfg = cell_cfg(spec)
    opt = OptConfig(kind="adamw", peak_lr=spec["lr"], warmup_steps=1,
                    total_steps=100)
    tc = TrainerConfig(seq_len=spec["seq_len"],
                       global_batch=spec["global_batch"], log_every=0)
    attack = AttackConfig("sign_flip", 1.0, spec["scale"])
    return cfg, opt, tc, attack, BFTConfig


def train_seed(n, f, byz) -> int:
    """The first protocol seed whose step-0 check (deterministic mode)
    puts a Byzantine worker in a replica group and whose identify round
    holds both: the run then checks, votes, eliminates both and goes on
    with fast steps (the protocol's streams only; no card work)."""
    from repro_torch.core.randomized import BFTConfig, ProtocolState

    for seed in range(1000):
        st = ProtocolState.create(BFTConfig(n=n, f=f, mode="deterministic",
                                            seed=seed))
        st.decide_check(1.0)
        a, ai = st.assignment_check(), st.assignment_identify()
        if (a.group_of_worker[list(byz)] >= 0).any() and \
                (ai.group_of_worker[list(byz)] >= 0).all():
            return seed
    fail("no protocol seed puts both Byzantine workers in step 0's vote")


def expected_train_launches(f_t: int, n_active: int, identified: bool,
                            L: int, leaves: int, remat: bool = True) -> dict:
    """Launches of one deterministic-mode step from the state before it:
    a check (r = f_t+1) or, with f_t = 0, a fast step; an identify round
    (r = 2f_t+1) after a fault.  K6 once per layer per computing
    worker's forward, and under ``remat`` once more in its backward (the
    layer's forward recomputed); K4s once per leaf per check member, K3
    once per leaf per identify round."""
    L = 2 * L if remat else L
    out = {"flash_attention": 0, "sketch": 0, "pairwise_relmax_batched": 0}
    if f_t == 0:
        out["flash_attention"] = L * n_active
        return out
    r = f_t + 1
    members = n_active // r * r
    out["flash_attention"] = L * members
    out["sketch"] = leaves * members
    if identified:
        r = 2 * f_t + 1
        out["flash_attention"] += L * (n_active // r * r)
        out["pairwise_relmax_batched"] = leaves
    return out


def train_kernels(torch, cfg, leaf_sizes, row_counts, spec, tag):
    """K6 at the training path's per-worker shapes (a model with
    attention layers), K4s at every leaf size, K3 at the identify vote's
    largest leaf, each against its plain version on the card with a
    bitwise rerun, and timed; the kernels line's rows are named
    ``<kernel>_<tag>``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import majority_vote as mv
    from repro_torch.kernels import sketch as sk

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    S, H, K, hd = spec["seq_len"], cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    report, rows = {}, {}
    for B in row_counts if H else ():
        q, k, v = [torch.randn(*s, generator=gen, device=dev).to(
            torch.bfloat16) for s in ((B, S, H, hd), (B, S, K, hd),
                                      (B, S, K, hd))]
        got = fa.flash_attention_cuda(q, k, v)
        want = fa.flash_attention_plain(q, k, v)
        err, tile = max_err(got.float(), want.float()), tile_rel_err(got, want)
        check(close(got.float(), want.float(), 2e-2, 2e-2) and tile <= 1e-2,
              f"K6 disagrees at the training shape ({B}, {S})")
        check(bool(torch.equal(got, fa.flash_attention_cuda(q, k, v))),
              f"K6 rerun differs at the training shape ({B}, {S})")
        ms = median_ms(torch, lambda: fa.flash_attention_cuda(q, k, v),
                       launches=20)
        plain_ms = median_ms(torch, lambda: fa.flash_attention_plain(q, k, v),
                             reps=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), launches=20)
        b_ms, b_by = attn_bound(B, S, S, H, K, hd, True, None, 2)
        rows[B] = dict(err=err, tile_rel_err=tile, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"K6 training shape (B={B}, S={S}, H={H}, K={K}, hd={hd}) bf16: "
              f"max|kernel-plain| = {err:.3e}, worst 64-row block {tile:.3e} "
              f"(tolerances 2e-2 abs + rel, 1e-2); rerun bitwise equal; "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms="
              f"{library_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        del q, k, v, qt, kt, vt, got, want
    if rows:
        r6 = rows[max(row_counts)]
        report[f"flash_attention_{tag}"] = entry(
            f"flash_attention_{tag}", "flash_attention.cu",
            "src/repro/kernels/flash_attention.py:33", r6["err"], r6["ms"],
            r6["plain_ms"], r6["bound_ms"], r6["bound_by"], r6["library_ms"])

    kk = 256
    for d in sorted(set(leaf_sizes)):
        x = torch.randn(d, generator=gen, device=dev)
        got, want = sk.sketch_cuda(x, 7), sk.sketch_plain(x, 7)
        err, rel = max_err(got, want), rel_err(got, want)
        # a bucket sums d / 256 signed terms (a million at the largest
        # leaves), so the f32 error scales with the sums' size, not with
        # each bucket's (which may cancel to near 0)
        print(f"K4s sketch at the leaf size d={d}: max|kernel-plain| = "
              f"{err:.3e}, / max(1, max|plain|) = {rel:.3e} (tolerance "
              f"1e-5)")
        check(rel <= 1e-5, f"K4s disagrees at d={d}")
        check(bool(torch.equal(got, sk.sketch_cuda(x, 7))),
              f"K4s rerun differs at d={d}")
        if d == max(leaf_sizes):
            ms = median_ms(torch, lambda: sk.sketch_cuda(x, 7), launches=10)
            plain_ms = median_ms(torch, lambda: sk.sketch_plain(x, 7), reps=3,
                                 warm=1)
            signs = sign_table(torch, d + (-d) % kk, 7, dev).reshape(-1, kk)
            xs_ = F.pad(x, (0, (-d) % kk)).reshape(-1, kk)
            library_ms = median_ms(torch, lambda: torch.einsum(
                "mk,mk->k", xs_, signs), launches=10)
            b_ms, b_by = kernel_bound("sketch", d=d, k=kk)
            report[f"sketch_{tag}"] = entry(
                f"sketch_{tag}", "sketch.cu",
                "src/repro/kernels/sketch.py:25", err, ms, plain_ms, b_ms,
                b_by, library_ms)
            print(f"K4s sketch d={d}: kernel_ms={ms:.4f} plain_ms="
                  f"{plain_ms:.4f} einsum_ms={library_ms:.4f} bound_ms="
                  f"{b_ms:.4f} ({b_by}); {b_ms / ms:.1%} of bound")
            del signs, xs_
        del x, got, want

    d = max(leaf_sizes)
    R = 2 * spec["f"] + 1
    x = torch.randn(1, R, d, generator=gen, device=dev)
    x[0, 2] = x[0, 0]                                # one agreeing pair
    got = mv.pairwise_relmax_batched_cuda(x)
    want = mv.pairwise_relmax_batched_plain(x)
    err = max_err(got, want)
    check(close(got, want, 1e-6, 0.0) and float(got[0, 0, 2]) == 0.0,
          f"K3 disagrees at (1, {R}, {d})")
    check(bool(torch.equal(got, mv.pairwise_relmax_batched_cuda(x))),
          "K3 rerun differs at the training shape")
    ms = median_ms(torch, lambda: mv.pairwise_relmax_batched_cuda(x),
                   launches=10)
    plain_ms = median_ms(torch, lambda: mv.pairwise_relmax_batched_plain(x),
                         reps=3, warm=1)
    b_ms, b_by = kernel_bound("pairwise_relmax_batched", B=1, R=R, d=d)
    report[f"pairwise_relmax_batched_{tag}"] = entry(
        f"pairwise_relmax_batched_{tag}", "majority_vote.cu",
        "src/repro/kernels/majority_vote.py:63", err, ms, plain_ms, b_ms,
        b_by, None)
    print(f"K3 relmax at the vote's shape (1, {R}, {d}): max|kernel-plain| "
          f"= {err:.3e} (tolerance rtol 1e-6); rerun bitwise equal; "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
          f"({b_by}); {b_ms / ms:.1%} of bound")
    del x, got, want
    return report, rows


def honest_replicas_equal(torch, cfg, params, rows: int, spec) -> dict:
    """Two honest workers on the same rows: bitwise equal gradients and
    sketches (the check's premise; the embedding's accumulating backward,
    the MoE dispatch's and cuBLAS's workspaces are where it could
    break).  Returns the rows' loss terms: the loss is ce + 0.01 moe_aux
    (moe_aux 0 without MoE layers)."""
    import numpy as np

    from repro_torch.core import detection, tree
    from repro_torch.models import model as M
    from repro_torch.train import steps

    rng = np.random.default_rng(2)
    dev = tree.leaves(params)[0].device
    V = min(4096, cfg.vocab_size)         # the data pipeline's alphabet
    tok = torch.as_tensor(rng.integers(0, V, (rows, spec["seq_len"])),
                          device=dev)
    lab = torch.as_tensor(rng.integers(0, V, (rows, spec["seq_len"])),
                          device=dev)
    none = steps.AttackConfig("none")
    g0 = steps.per_worker_grad(params, tok, lab, False, (0, 0), cfg, none)[1]
    g1 = steps.per_worker_grad(params, tok, lab, False, (0, 1), cfg, none)[1]
    same = [bool(torch.equal(a, b)) for a, b in zip(tree.leaves(g0),
                                                    tree.leaves(g1))]
    s0, s1 = (detection.sketch_tree(g, 0xC0FFEE) for g in (g0, g1))
    print(f"honest replicas ({rows} x {spec['seq_len']} tokens, full "
          f"width): gradients bitwise equal on {sum(same)} of {len(same)} "
          f"leaves; sketches bitwise equal: {bool(torch.equal(s0, s1))}")
    check(all(same) and bool(torch.equal(s0, s1)),
          "honest replicas' gradients or sketches differ on the card")
    with torch.no_grad():
        loss, m = M.train_loss(params, {"tokens": tok, "labels": lab}, cfg)
    terms = {k: float(v) for k, v in dict(m, loss=loss).items()}
    print(f"the rows' loss {terms['loss']:.6f} = ce {terms['ce']:.6f} + "
          f"{M.MOE_AUX_COEF} x moe_aux {terms['moe_aux']:.6f}")
    check(abs(terms["loss"] - terms["ce"] - M.MOE_AUX_COEF *
              terms["moe_aux"]) <= 1e-5 * terms["loss"] and
          (terms["moe_aux"] > 0) == (cfg.moe is not None),
          "the training loss is not ce + 0.01 moe_aux")
    return terms


def snapshot(torch, params, state):
    from repro_torch.core import tree

    return [t.clone() for t in tree.leaves(params) + tree.leaves(state)]


def same_as(torch, params, state, snap) -> bool:
    from repro_torch.core import tree

    return all(bool(torch.equal(a, b)) for a, b in
               zip(tree.leaves(params) + tree.leaves(state), snap))


def train_step_checks(torch, cfg, opt, trainer, attack, spec):
    """On the trained model (AdamW state nonzero): a check step that
    finds a fault leaves params and state bitwise unchanged (grad_norm,
    lr reported 0); an identify step's update equals the update from an
    honest replica's gradient, bitwise."""
    import numpy as np

    from repro_torch.core import tree
    from repro_torch.core.assignment import (check_assignment, group_members,
                                             identify_assignment)
    from repro_torch.data import global_batch_for_step, worker_batches
    from repro_torch.optim import opt_update
    from repro_torch.train import steps

    n, f, byz = spec["n"], spec["f"], list(spec["byz"])
    mask = np.isin(np.arange(n), byz)
    step = trainer.state.step
    batch = global_batch_for_step(cfg, global_batch=spec["global_batch"],
                                  seq_len=spec["seq_len"], step=step)
    sc = steps.StepConfig()
    rng = np.random.default_rng(0)
    while True:
        a = check_assignment(np.ones(n, bool), f, rng)
        if (a.group_of_worker[byz] >= 0).any():
            break
    fn = steps.make_check_step(cfg, opt, sc, attack, a.num_shards)
    snap = snapshot(torch, trainer.params, trainer.opt_state)
    p, s, m = fn(trainer.params, trainer.opt_state, worker_batches(batch, a),
                 a.weight, mask, a.group_of_worker, trainer.key, step)
    unchanged = same_as(torch, p, s, snap)
    print(f"check step with a Byzantine member: any_fault {m['any_fault']}, "
          f"group_fault {m['group_fault'].tolist()}, grad_norm "
          f"{float(m['grad_norm'])}, lr {float(m['lr'])}; params and AdamW "
          f"state bitwise unchanged: {unchanged}")
    check(m["any_fault"] and unchanged and float(m["grad_norm"]) == 0.0
          and float(m["lr"]) == 0.0, "a faulty check step changed the model")

    while True:
        ai = identify_assignment(np.ones(n, bool), f, rng)
        members = np.stack(group_members(ai))
        if np.isin(members, byz).any():
            break
    fn = steps.make_identify_step(cfg, opt, sc, attack, members)
    p, s, m = fn(p, s, worker_batches(batch, ai), ai.weight, mask,
                 trainer.key, step)
    found = np.flatnonzero(m["byz"]).tolist()
    want = sorted(set(members.ravel().tolist()) & set(byz))
    honest = int(next(w for w in members[0] if w not in byz))
    wb = worker_batches(batch, ai)
    ref_p = tree.unflatten(trainer.params, snap[:len(tree.leaves(p))])
    ref_s = tree.unflatten(trainer.opt_state, snap[len(tree.leaves(p)):])
    _, g, _ = steps.per_worker_grad(
        ref_p, torch.as_tensor(wb["tokens"][honest], device=trainer.device),
        torch.as_tensor(wb["labels"][honest], device=trainer.device), False,
        (0, 0), cfg, attack)
    opt_update(opt, g, ref_s, ref_p, step)
    equal = same_as(torch, p, s, tree.leaves(ref_p) + tree.leaves(ref_s))
    print(f"identify step (members {members.tolist()}): found {found} "
          f"(tampering members {want}); its update equals the update from "
          f"honest worker {honest}'s gradient, bitwise: {equal}")
    check(found == want and equal, "the identify step's verdict or update "
                                   "is not the honest replica's")
    del snap, ref_p, ref_s, g


def mode_walls(torch, cfg, opt, trainer, rows_k6_ms, spec):
    """Each step kind once for its wall and once under a PhaseClock for
    its split, on the trained model, honest workers."""
    import numpy as np

    from repro_torch.core.assignment import (check_assignment,
                                             fast_assignment, group_members,
                                             identify_assignment)
    from repro_torch.data import global_batch_for_step, worker_batches
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import attn_layer_indices
    from repro_torch.train import steps

    n, f = spec["n"], spec["f"]
    L = len(attn_layer_indices(cfg))
    none = steps.AttackConfig("none")
    sc = steps.StepConfig()
    batch = global_batch_for_step(cfg, global_batch=spec["global_batch"],
                                  seq_len=spec["seq_len"], step=0)
    act = np.ones(n, bool)
    rng = np.random.default_rng(1)
    cases = {
        "fast": fast_assignment(act),
        "check": check_assignment(act, f, rng),
        "identify": identify_assignment(act, f, rng),
    }
    out = {}
    tokens = spec["global_batch"] * spec["seq_len"]
    for mode, a in cases.items():
        members = int((a.group_of_worker >= 0).sum())
        rows = spec["global_batch"] // a.num_shards
        wb = worker_batches(batch, a)

        def run(clock=None):
            if mode == "fast":
                fn = steps.make_fast_step(cfg, opt, sc, none, clock=clock)
                args = (wb, a.weight, np.zeros(n, bool))
            elif mode == "check":
                fn = steps.make_check_step(cfg, opt, sc, none, a.num_shards,
                                           clock=clock)
                args = (wb, a.weight, np.zeros(n, bool), a.group_of_worker)
            else:
                fn = steps.make_identify_step(
                    cfg, opt, sc, none, np.stack(group_members(a)),
                    clock=clock)
                args = (wb, a.weight, np.zeros(n, bool))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(trainer.params, trainer.opt_state, *args, trainer.key, 1)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        ops.reset_launch_counts()
        wall = run()
        counts = ops.launch_counts()
        clock = steps.PhaseClock()
        clocked = run(clock)
        # the card's busy time in one step: every kernel's duration
        # from one torch.profiler window (one stream, no overlap)
        t_prof = time.perf_counter()
        times = kernel_times(torch, run)
        prof_s = time.perf_counter() - t_prof
        dev_ms = sum(ms for ms, _ in times.values()) or None
        busy = None if dev_ms is None else dev_ms / 1e3 / wall
        top = sorted(times.items(), key=lambda kv: -kv[1][0])[:6]
        k6 = L * members * rows_k6_ms.get(rows, 0.0) / 1e3
        out[mode] = dict(
            wall_s=wall, clocked_wall_s=clocked, phases_s=dict(clock.s),
            device_busy_s=None if dev_ms is None else dev_ms / 1e3,
            device_busy_share=busy,
            device_launches=sum(n for _, n in times.values()),
            top_kernels=[(name[:80], ms, n) for name, (ms, n) in top],
            workers=members, rows_per_worker=rows,
            batch_tokens_per_s=tokens / wall,
            computed_tokens_per_s=members * rows * spec["seq_len"] / wall,
            k6_s=k6, k6_share=k6 / wall, launches=counts,
            profile_window_s=prof_s)
        split = ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            clock.s.items(), key=lambda kv: -kv[1]))
        print(f"train {mode} step ({members} workers x {rows} rows x "
              f"{spec['seq_len']}): wall {wall:.4f} s, {tokens / wall:.1f} "
              f"batch tokens/s ({members * rows * spec['seq_len'] / wall:.1f}"
              f" computed); K6 {L * members} x "
              f"{rows_k6_ms.get(rows, 0.0):.4f} ms = "
              f"{k6 / wall:.1%} of the wall; card busy (profiler) "
              + ("not measured" if busy is None else
                 f"{dev_ms:.1f} ms = {busy:.1%} of the wall")
              + f"; clocked {clocked:.4f} s: {split}; launches {counts}; "
              f"profiler window {prof_s:.1f} s")
        print(f"  {mode}: {sum(n for _, n in times.values())} kernels on "
              f"the card; by device time: " + "; ".join(
                  f"{name[:60]} {ms:.1f} ms x{n}" for name, (ms, n) in top))
    return out


def phase_train(torch, spec, tag: str):
    """The model of ``spec`` (TRAIN: llama3.2-1b, MAMBA_TRAIN:
    mamba2-780m) trained at full width by 8 workers (2 Byzantine) on
    the card: the training kernels against their plain versions, honest
    replicas bitwise equal, the deterministic protocol's main path with
    launch counts, the skipped check and the identify update bitwise,
    each step kind's wall and split, the same run with the plain
    versions and a planted control it must catch, and a reduced f32 run
    on the card against the CPU."""
    import gc

    import numpy as np

    from repro_torch.core import tree
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.transformer import attn_layer_indices
    from repro_torch.train import StepConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    split, last = {}, [t_phase]

    def mark(name):
        now = time.perf_counter()
        split[name] = now - last[0]
        last[0] = now

    cfg, opt, tc, attack, BFTConfig = train_cfg_objects(spec)
    L_attn = len(attn_layer_indices(cfg))
    n, f, byz = spec["n"], spec["f"], spec["byz"]
    gb = spec["global_batch"]
    row_counts = (gb // n, gb // (n // (f + 1)), gb // (n // (2 * f + 1)))
    params = M.init_train(cfg, 0)
    leaves = tree.leaves(params)
    sizes = [t.numel() for t in leaves]
    print(f"training cell: {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}), {sum(sizes) / 1e9:.4f} B "
          f"parameters in {len(leaves)} leaves {sizes}; n={n}, f={f}, "
          f"Byzantine {list(byz)} (sign_flip x {spec['scale']}, every "
          f"step), seq {spec['seq_len']}, global batch {gb}, AdamW")
    del params, leaves
    report, k6_rows = train_kernels(torch, cfg, sizes, row_counts, spec,
                                    tag)
    mark("kernels")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    seed = train_seed(n, f, byz)
    mask = np.isin(np.arange(n), byz)

    def trainer(impl=None):
        return Trainer(cfg, opt, BFTConfig(n=n, f=f, mode="deterministic",
                                           seed=seed), tc, attack=attack,
                       sc=StepConfig(), true_byzantine=mask, impl=impl)

    tr = trainer()
    init = [x.detach().to("cpu", copy=True) for x in tree.leaves(tr.params)]
    loss_terms = honest_replicas_equal(torch, cfg, tr.params, row_counts[1],
                                       spec)
    mark("init_and_honest_replicas")

    def drive(t):
        """The main path: t.train_step() spec["steps"] times; returns
        the launches expected from the protocol state before each step
        and each step's wall."""
        want = dict.fromkeys(("flash_attention", "sketch",
                              "pairwise_relmax_batched"), 0)
        walls = []
        for _ in range(spec["steps"]):
            f_t, n_act = t.state.f_t, int(t.state.active.sum())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = t.train_step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            for k, v in expected_train_launches(
                    f_t, n_act, "identified" in rec, L_attn,
                    len(sizes), cfg.remat).items():
                want[k] += v
        return want, walls

    tape = RoutingTape()
    ops.reset_launch_counts()
    with tape.record():
        want, walls = drive(tr)
    launches = ops.launch_counts()
    hist = tr.history
    ident = sorted(np.flatnonzero(tr.state.identified).tolist())
    print(f"training main path ({spec['steps']} steps, deterministic, "
          f"protocol seed {seed}): records {hist}; step walls "
          f"{[round(w, 4) for w in walls]} s; launches {launches} (expected "
          f"{want})")
    check(all(launches[k] == v for k, v in want.items()) and
          (launches["flash_attention"] > 0) == (L_attn > 0) and
          launches["sketch"] > 0 and launches["pairwise_relmax_batched"] > 0,
          "training launches differ from the protocol's count")
    check(bool(ident) and set(ident) <= set(byz),
          f"identified {ident}, want a non-empty subset of {list(byz)}")
    check(all(np.isfinite(r["loss"]) for r in hist), "non-finite loss")
    final = [t.detach().to("cpu", copy=True) for t in tree.leaves(tr.params)]
    mark("main_path")

    train_step_checks(torch, cfg, opt, tr, attack, spec)
    mark("step_checks")
    modes = mode_walls(torch, cfg, opt, tr, {B: r["ms"] for B, r in
                                             k6_rows.items()}, spec)
    mark("mode_walls")
    peak = torch.cuda.max_memory_allocated()
    print(f"training: torch.cuda.max_memory_allocated = {peak / 2**30:.2f} "
          f"GiB")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # the same main path with the plain versions on the card, then the
    # planted control: the plain versions with no protocol (mode "none"),
    # so workers 2 and 5's sign-flipped gradients enter the mean
    def run_to_cpu(t):
        drive(t)
        return t.history, [x.detach().to("cpu", copy=True)
                           for x in tree.leaves(t.params)]

    # an MoE model's plain run takes the kernel run's routing (as the
    # serving phases' plain runs do)
    tp = trainer("torch")
    ops.reset_launch_counts()
    with tape.replay():
        plain_hist, plain_final = run_to_cpu(tp)
    plain_launches = ops.launch_counts()
    mark("plain_run")
    del tp
    gc.collect()
    torch.cuda.empty_cache()
    tn = Trainer(cfg, opt, BFTConfig(n=n, f=f, mode="none", seed=seed), tc,
                 attack=attack, sc=StepConfig(), true_byzantine=mask,
                 impl="torch")
    planted_hist, planted_final = run_to_cpu(tn)
    mark("planted_run")
    del tn
    gc.collect()
    torch.cuda.empty_cache()

    same_ctl = [{k: v for k, v in r.items() if k != "loss"}
                for r in plain_hist] == \
        [{k: v for k, v in r.items() if k != "loss"} for r in hist]
    sound = train_run_diffs(torch, init, final, hist, plain_final,
                            plain_hist)
    planted = train_run_diffs(torch, init, planted_final, planted_hist,
                              plain_final, plain_hist)
    print(f"kernels vs plain versions on the card" + (
        f" (the plain run given the kernel run's routing, whose own would "
        f"differ in {tape.flips} of {tape.choices} choices)" if tape.calls
        else "") + f": control equal {same_ctl}; "
          f"{train_diff_text(sound)}; plain run launched "
          f"{sum(plain_launches.values())} kernels")
    print(f"planted control (plain versions, mode none, workers "
          f"{list(byz)} sign-flipped into the mean) vs plain versions: "
          f"{train_diff_text(planted)}")
    check(same_ctl and sound["loss0_rel"] <= TRAIN_LOSS0_REL and
          sound["drop_rel"] <= TRAIN_DROP_REL and
          sound["update_rel_max"] <= TRAIN_UPDATE_REL and
          sound["still_equal"] and sum(plain_launches.values()) == 0,
          "training with the kernels differs from the plain versions")
    check(planted["drop_rel"] > TRAIN_DROP_REL and
          planted["update_rel_min"] > TRAIN_UPDATE_REL,
          "the comparison with the plain versions does not catch the "
          "planted wrong gradient")
    del final, plain_final, planted_final, init
    gc.collect()
    torch.cuda.empty_cache()

    small = train_small_vs_cpu(torch, spec["arch"])
    mark("small_vs_cpu")
    phase_s = time.perf_counter() - t_phase
    print(f"phase_train ({cfg.name}): {phase_s:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in split.items()) + ")")
    return launches, report, dict(
        seed=seed, history=hist, step_walls_s=walls, launches=launches,
        expected_launches=want, modes=modes, peak_memory_bytes=peak,
        k6_rows=k6_rows, vs_plain=sound, planted_vs_plain=planted,
        plain_routing_flips=tape.flips, plain_routing_choices=tape.choices,
        loss_terms=loss_terms,
        small_vs_cpu=small, phase_split_s=split,
        phase_s=phase_s)


# the training cell's workers as ranks (phase_train_ranks): TRAIN's run
# (a) as one NCCL rank at full depth, (b) as two gloo ranks sharing the
# card with the depth cut to RANKS_CUT layers, (c) as one NCCL rank a
# card where more than one is visible.  Until the first fast step the
# ranks' run is bitwise the one-process run (nothing is summed across
# ranks: the check's flags and the identify vote read gathered bits).
# A fast step's gradient sum differs only in order: each rank sums its
# workers' f32 gradients in worker order, then the ranks' partial sums
# are added, where one process adds all n in turn, (n - 1) f32 rounding
# errors (2^-24 relative each) of the summed magnitudes.  AdamW turns
# that into a weight's move of lr * u, |u| <= 1 in these first steps
# (|m^| <= sqrt(v^) by Cauchy-Schwarz over the bias-corrected
# averages), so a fast step can change a bf16 weight by one rounding,
# one ulp at its scale (its magnitude plus the updates' reach), plus,
# where its gradient is no larger than the sum's rounding, up to 2 lr:
# each weight is held to fast x (ulp + 2 lr).  Most weights' u moves by
# about 1e-6 of itself, so per leaf ||ranks - one|| is a small share of
# the fast steps' update, RANKS_UPDATE_REL (set from the readings of
# (b), 0.012, PERF.md section 6), which a run that lost the last fast
# step's update (the planted control) exceeds.  The losses, sums of n
# f32 terms in another order ((n - 1) 2^-24 = 4.2e-7 relative) on
# weights an ulp apart in places, within RANKS_LOSS_REL.
RANKS_CUT = 2
RANKS_UPDATE_REL = 0.1
RANKS_LOSS_REL = 1e-5


def ranks_job(torch, cfg, opt, tc, attack, spec, seed, mask, **kw):
    from repro_torch.launch.train import Job
    from repro_torch.train import StepConfig

    n, f = spec["n"], spec["f"]
    _, _, _, _, BFTConfig = train_cfg_objects(spec)
    kw.setdefault("actions", (("run", spec["steps"]),))
    return Job(cfg, opt, BFTConfig(n=n, f=f, mode="deterministic",
                                   seed=seed), tc, attack, StepConfig(),
               mask, **kw)


def one_process_run(torch, job, keep_steps: bool = False,
                    params=None) -> dict:
    """``job``'s run with every worker in this process (from ``params``
    where given): history, the per-step checksums of params and AdamW
    state, the expected launches, the step walls, the final leaves and,
    with ``keep_steps``, the params after each step (CPU copies)."""
    from repro_torch.core import tree
    from repro_torch.kernels import ops
    from repro_torch.train import Trainer
    from repro_torch.train.ranks import checksums

    t = Trainer(job.cfg, job.opt, job.bft, job.tc, attack=job.attack,
                sc=job.sc, true_byzantine=job.true_byzantine, params=params)
    sums, walls, steps = [], [], []
    ops.reset_launch_counts()
    for _ in range(job.actions[0][1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train_step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        sums.append(checksums(t.params, t.opt_state).cpu())
        if keep_steps:
            steps.append([x.detach().cpu() for x in tree.leaves(t.params)])
    out = dict(history=t.history, checksums=sums, steps=steps,
               want=want_from_history(job, t.history), walls=walls,
               launches=ops.launch_counts(),
               final=[x.detach().cpu() for x in tree.leaves(t.params)
                      + tree.leaves(t.opt_state)],
               n_params=len(tree.leaves(t.params)))
    del t
    return out


def ranks_vs_one(torch, results, one, label: str, lr: float) -> dict:
    """(b) and (c)'s checks of W ranks' results against the one-process
    run: decisions equal; after step 0 (a faulty check, then the
    identify update: nothing summed across ranks) params and AdamW state
    bitwise, by checksum; the final weights within the fast steps'
    ulps; losses within RANKS_LOSS_REL; a check step with a Byzantine
    member leaving every rank's state unchanged; every rank bitwise rank
    0's, and the planted ulp caught; K6 and K4s launches summing to the
    one-process run's, K3 the same on every rank."""
    def ctl(h):
        return [{k: v for k, v in r.items() if k != "loss"} for r in h]

    r0 = results[0]
    hist = r0["main"]["history"]
    same_ctl = all(ctl(r["main"]["history"]) == ctl(one["history"])
                   for r in results)
    step0 = all(torch.equal(r["checksums"][0], one["checksums"][0])
                for r in results)
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(hist, one["history"]))
    fast = sum("identified" not in r and r["f_t"] == 0 for r in hist[1:])
    n_p = one["n_params"]
    # the fast steps' updates, from the weights after step 0 (bitwise
    # the same in both runs); the planted control: the one-process
    # weights with the last fast step's update missing
    first = next(i for i, r in enumerate(hist) if i > 0 and
                 r["f_t"] == 0 and "identified" not in r)
    excess, worst, leaf_diffs = 0.0, 0.0, []
    planted_rel = []
    for i, (a, b, p0, p1) in enumerate(zip(
            r0["params"]["main"], one["final"][:n_p],
            one["steps"][first - 1], one["steps"][-2])):
        a, b, p0, p1 = (x.cuda().float() for x in (a, b, p0, p1))
        moved = float((b - p0).norm())
        if moved:
            worst = max(worst, float((a - b).norm()) / moved)
            planted_rel.append(float((p1 - b).norm()) / moved)
        bits = 7 if r0["params"]["main"][i].dtype == torch.bfloat16 else 23
        bound = fast * (torch.exp2(torch.floor(torch.log2(
            torch.maximum(a.abs(), b.abs()) + 2 * lr * fast)) - bits)
            + 2 * lr)
        d = (a - b).abs()
        excess = max(excess, float((d / bound).max()))
        if bool((d > 0).any()):
            j = int(d.reshape(-1).argmax())
            leaf_diffs.append((i, tuple(a.shape), int((d > 0).sum()),
                               float(d.reshape(-1)[j]),
                               float(a.reshape(-1)[j]),
                               float(b.reshape(-1)[j])))
        del a, b, p0, p1, d, bound
    print(f"{label}: leaves that differ after the fast steps (leaf, shape, "
          f"elements, max |d|, the ranks' and the one process's value "
          f"there): {leaf_diffs}")
    probes = [{k: v for k, v in p.items() if k != "launches"}
              for r in results for p in r["check_fault"]]
    agree = all(r["agree"] for r in results) and all(
        all(torch.equal(a, b) for a, b in zip(r["params"]["main"],
                                               r0["params"]["main"]))
        for r in results)
    planted = all(r["plant"]["caught"] and r["plant"]["restored"]
                  for r in results)
    k6 = sum(r["launches"]["flash_attention"] for r in results)
    k4 = sum(r["launches"]["sketch"] for r in results)
    k3 = [r["launches"]["pairwise_relmax_batched"] for r in results]
    launches_ok = (k6, k4) == (one["launches"]["flash_attention"],
                               one["launches"]["sketch"]) and \
        set(k3) == {one["launches"]["pairwise_relmax_batched"]} and k3[0] > 0
    print(f"{label}: decisions equal {same_ctl} ({ctl(hist)}); params and "
          f"AdamW state after step 0 (check with a fault, identify update) "
          f"bitwise the one-process run's on every rank: {step0}; after "
          f"{fast} fast steps each weight within {excess:.4f} of its bound "
          f"(limit 1), each leaf's ||ranks - one|| / ||the fast steps' "
          f"update|| at most {worst:.4e} (limit {RANKS_UPDATE_REL}; the "
          f"planted control, the last fast step's update missing, "
          f"{min(planted_rel):.4f}..{max(planted_rel):.4f}); losses rel diff "
          f"{loss_rel:.3e} (limit {RANKS_LOSS_REL}); a check with a "
          f"Byzantine member: {probes}; every rank bitwise rank 0's: "
          f"{agree}; one ulp planted on rank {len(results) - 1} caught: "
          f"{planted} (table {results[0]['plant']['table']}); launches "
          f"K6 {k6} K4s {k4} (one process {one['launches']}), K3 by rank "
          f"{k3}; staged through the host: {r0['staged']}, "
          f"{[r['counts'] for r in results]}; step walls by rank "
          f"{[[round(w, 3) for w in r['walls']] for r in results]} s "
          f"(one process {[round(w, 3) for w in one['walls']]} s); peak "
          f"memory by rank {[r['peak_bytes'] for r in results]} bytes")
    check(same_ctl and step0 and agree and planted and launches_ok,
          f"{label}: the ranks differ from the one-process run")
    check(fast > 0 and excess <= 1.0 and worst <= RANKS_UPDATE_REL and
          loss_rel <= RANKS_LOSS_REL,
          f"{label}: after the fast steps the ranks drift beyond the "
          f"summation order's bound")
    check(min(planted_rel) > RANKS_UPDATE_REL,
          f"{label}: the planted control (an update missing) is not caught")
    check(probes and all(p["any_fault"] and p["unchanged"] for p in probes),
          f"{label}: a faulty check changed a rank's state")
    return dict(control_equal=same_ctl, step0_bitwise=step0,
                fast_steps=fast, bound_excess=excess, update_rel_max=worst,
                planted_update_rel=planted_rel, leaf_diffs=leaf_diffs,
                loss_rel=loss_rel,
                check_fault=probes, ranks_agree=agree, planted=planted,
                launches=[r["launches"] for r in results],
                counts=[r["counts"] for r in results],
                walls=[r["walls"] for r in results],
                one_process_walls=one["walls"],
                peak_bytes=[r["peak_bytes"] for r in results])


def spawn_ranks(torch, job, world: int) -> list:
    import shutil
    import tempfile

    from repro_torch.launch import train as launch

    out = Path(tempfile.mkdtemp(prefix="ranks_", dir=ROOT / "build"))
    try:
        return launch.spawn(dataclasses.replace(job, out=str(out)), world)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def ranks_a(torch, spec, seed, mask, training: dict) -> tuple:
    """(a) one NCCL rank in this process at full width and depth,
    bitwise the one-process run."""
    import gc

    from repro_torch.core import tree
    from repro_torch.launch import train as launch

    cfg, opt, tc, attack, _ = train_cfg_objects(spec)
    job = ranks_job(torch, cfg, opt, tc, attack, spec, seed, mask,
                    device="cuda", backend="nccl")
    one = one_process_run(torch, job)
    gc.collect()
    torch.cuda.empty_cache()
    res, tr = launch.rank_main(0, 1, dataclasses.replace(
        job, init_method=f"tcp://localhost:{launch.free_port()}"))
    launches = res["launches"]
    got = tree.leaves(tr.params) + tree.leaves(tr.opt_state)
    bitwise = len(got) == len(one["final"]) and all(
        torch.equal(a.cpu(), b) for a, b in zip(got, one["final"]))
    same_hist = res["main"]["history"] == one["history"]
    print(f"ranks (a) one NCCL rank, {cfg.name} full width and depth: "
          f"history (decisions and losses) equal {same_hist}; params and "
          f"AdamW state bitwise the one-process run's: {bitwise} "
          f"({len(got)} leaves); launches {launches} (expected "
          f"{one['want']}); collectives {res['counts']}; step walls "
          f"{[round(w, 4) for w in res['walls']]} s, one process "
          f"{[round(w, 4) for w in one['walls']]} s, phase_train's "
          f"{[round(w, 4) for w in training.get('step_walls_s', [])]} s")
    check(same_hist and bitwise, "ranks (a): one NCCL rank differs from "
                                 "the one-process run")
    check(all(launches[k] == v for k, v in one["want"].items()) and
          launches["pairwise_relmax_batched"] > 0,
          "ranks (a): launches differ from the protocol's count")
    check(res["counts"]["all_reduce"] > 0 and res["counts"]["all_gather"] > 0,
          "ranks (a): the collectives were not reached")
    out = dict(history_equal=same_hist, bitwise=bitwise, launches=launches,
               expected=one["want"], counts=res["counts"],
               walls=res["walls"], one_process_walls=one["walls"])
    del tr, got, one
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def ranks_b(torch, spec, seed, mask) -> dict:
    """(b) two gloo ranks sharing the card, RANKS_CUT layers."""
    import gc

    cut = dict(spec, layers=RANKS_CUT)
    cfg, opt, tc, attack, _ = train_cfg_objects(cut)
    job = ranks_job(torch, cfg, opt, tc, attack, cut, seed, mask,
                    device="cuda", backend="gloo", keep_params=True,
                    plant=True, actions=(("run", spec["steps"]),
                                         ("check_fault", 3)))
    n = spec["n"]
    print(f"ranks (b): depth cut from {get_layers(spec)} to {RANKS_CUT} "
          f"layers, full width; two gloo ranks of {n // 2} workers on "
          f"cuda:0")
    one = one_process_run(torch, job, keep_steps=True)
    gc.collect()
    torch.cuda.empty_cache()
    results = spawn_ranks(torch, job, 2)
    out = ranks_vs_one(torch, results, one, "ranks (b) two gloo ranks on "
                                            "one card", opt.peak_lr)
    del results, one
    gc.collect()
    return out


def get_layers(spec) -> int:
    return cell_cfg(spec).num_layers


def ranks_c(torch, spec, seed, mask, training: dict, world: int) -> dict:
    """(c) one NCCL rank a card, full depth, with an all-reduce's bus
    bandwidth."""
    import gc

    RL = roofline()
    cfg, opt, tc, attack, _ = train_cfg_objects(spec)
    job = ranks_job(torch, cfg, opt, tc, attack, spec, seed, mask,
                    device="cuda", backend="nccl", keep_params=True,
                    plant=True, actions=(("run", spec["steps"]),
                                         ("check_fault", 3),
                                         ("all_reduce_bw", 1 << 30)))
    one = one_process_run(torch, job, keep_steps=True)
    gc.collect()
    torch.cuda.empty_cache()
    results = spawn_ranks(torch, job, world)
    out = ranks_vs_one(torch, results, one, f"ranks (c) {world} NCCL ranks",
                       opt.peak_lr)
    bw = results[0]["all_reduce_bw"]
    print(f"ranks (c): all-reduce of {bw['bytes']} bytes f32 over {world} "
          f"cards: {bw['seconds'] * 1e3:.3f} ms, bus bandwidth "
          f"{bw['busbw'] / 1e9:.1f} GB/s (NVLINK_BYTES_S "
          f"{RL.NVLINK_BYTES_S / 1e9:.0f} GB/s); phase_train's walls "
          f"{training.get('step_walls_s')} s")
    out["all_reduce_bw"] = bw
    del results, one
    gc.collect()
    return out


def phase_train_ranks(torch, spec, training: dict):
    """The training cell's workers as ranks of a ``torch.distributed``
    group over the ``data`` axis (``launch.train``): (a) one NCCL rank in
    this process at full width and depth, bitwise the one-process
    ``Trainer``'s run (params, AdamW state, losses, decisions) with the
    protocol's K6 / K4s / K3 launches; (b) two gloo ranks sharing the
    card (operands staged through host memory) at full width, RANKS_CUT
    layers, against the one-process run of the same cut model
    (``ranks_vs_one``); (c) one NCCL rank a card where more than one is
    visible, the same checks at full depth, with an all-reduce's bus
    bandwidth beside NVLink's rate."""
    import gc

    import numpy as np

    from repro_torch.launch import train as launch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    n, f, byz = spec["n"], spec["f"], spec["byz"]
    seed, mask = train_seed(n, f, byz), np.isin(np.arange(n), byz)
    split = {}
    t0 = time.perf_counter()
    launches, out = ranks_a(torch, spec, seed, mask, training)
    out = {"a": out}
    split["a"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        out["b"] = ranks_b(torch, spec, seed, mask)
        split["b"] = time.perf_counter() - t0
        world = launch.default_nproc(n, "cuda")
        if world < 2:
            print(f"ranks (c): not run, {torch.cuda.device_count()} card "
                  f"visible")
        else:
            t0 = time.perf_counter()
            out["c"] = ranks_c(torch, spec, seed, mask, training, world)
            split["c"] = time.perf_counter() - t0
    finally:
        launch.stop_rank_server()
    out["phase_s"] = time.perf_counter() - t_phase
    out["split_s"] = split
    print(f"phase_train_ranks: {out['phase_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in split.items()) + ")")
    return launches, out


# the training cell split over the model axis (phase_train_tp): each BFT
# worker is ``model`` ranks holding its shards of every leaf (tensor and
# expert parallel, ``models.parallel``).  (a) two gloo ranks share the
# card at model = 2, W = 1, TRAIN and MAMBA_TRAIN at full width cut to
# RANKS_CUT layers; (b) where more cards are visible, one NCCL rank a
# card: llama3.2-1b at full depth with model 2 x W 2 and model 4 x W 1,
# phi3.5-moe at one layer with model 4 (4 of its 16 experts a card),
# mamba2-780m (MAMBA_TRAIN) at model 2 x W 2 and 4 x W 1, jamba at 5
# layers with model 4 (JAMBA_TRAIN; against its plain versions' split
# run, ``tp_run``'s "plain" reference).  Each other against the
# one-process run of the same model: control equal, losses within
# TP_LOSS_REL (the row-parallel sums and the vocab-parallel CE add in
# another order, so a split run is not bitwise the one-process run, and
# its bf16 activations round apart), each leaf's update within
# RANKS_UPDATE_REL (``train_run_diffs``); every rank's gathered
# parameters bitwise rank 0's; launches per rank as the protocol gives
# them (K6 on the rank's heads for every worker, K4s's shard form once a
# split leaf and check member, the single form for the replicated leaves
# on model rank 0, K3 once a leaf and vote); and a fast step counted on
# the card equal to the dry-run's meta trace of that rank (FLOPs and
# bytes).  (a) runs two steps (a faulty check and its vote, then a fast
# step); (b) three, and a check with a Byzantine member that must leave
# every rank's state unchanged.
TP_LOSS_REL = 1e-4
TP_SPLIT = 2
# mamba2-780m's (b) cells hold each leaf's update to the same cell's
# one-process run in float32 instead (TP_F32_ANCHORED): one rounding
# more or less moves mamba's bf16 AdamW updates, most under an ulp, by
# about 0.15 of themselves, so the split lies 0.16-0.17 from the
# one-process bf16 run, and so does that run with one product rounded
# in two halves, nothing split (PERF.md section 6).  The f32 run
# starts from the bf16 run's initial parameters cast to f32 (exact) and
# takes the same batches, coins and Byzantine workers; per leaf
# rel(x) = ||x - f32|| / ||f32 - init||, and the split is held to
# rel(split) <= rel(one) + TP_F32_MARGIN, rel(one) the one-process bf16
# run's: no farther from the f32 run than one process, within the 0.03
# by which the split and one-process runs were read apart on every leaf
# (``scripts/chip_phases.py tp_dtype``).
# The planted control, the split run with its last fast step's update
# taken back, must fail it.
TP_F32_ANCHORED = ("MAMBA_TRAIN",)
TP_F32_MARGIN = 0.05
# (a)'s cells, each cut to RANKS_CUT layers: llama3.2-1b and mamba2-780m
# (the mamba mixer split by heads, its gated RMSNorm over the split
# d_inner)
TP_A = ("TRAIN", "MAMBA_TRAIN")
# the hybrid's training cell: jamba at full width (d_model 4096, 32 heads
# and 8 kv heads of 128, 16 experts of 14336 top-2, d_inner 8192 in 128
# ssm heads, vocab 65536 untied) cut to layers 0-4, the fewest that hold
# each of its three layer kinds (mamba + mlp at 0 and 2, mamba + moe at 1
# and 3, attn + mlp at 4): 7.15 B parameters, 14.3 GB in bf16, whose
# AdamW moments (57.2 GB in f32) one process cannot hold beside them.
# Split over model 4 (4 experts a card) the dry-run puts a rank's peak at
# 34.2 GiB (fast, check) and 56.2 GiB (identify) on meta, so (b) holds
# the split run against the same split run on the plain versions
JAMBA_TRAIN = dict(TRAIN, arch="jamba-v0.1-52b", layers=5)
# (b)'s runs: (label, the cell, data ranks W, model)
TP_CARDS = (("llama model 2 x W 2", "TRAIN", 2, 2),
            ("llama model 4 x W 1", "TRAIN", 1, 4),
            ("phi3.5-moe model 4 x W 1", "MOE_TRAIN", 1, 4),
            ("mamba2-780m model 2 x W 2", "MAMBA_TRAIN", 2, 2),
            ("mamba2-780m model 4 x W 1", "MAMBA_TRAIN", 1, 4),
            ("jamba 5 layers model 4 x W 1", "JAMBA_TRAIN", 1, 4))
# the cells that one process cannot hold: held against the plain versions'
# split run (``tp_run``'s "plain" reference)
TP_SPLIT_ONLY = ("JAMBA_TRAIN",)
# a split run's reference runs and the limits each is held to: the
# one-process run (the losses and updates of the note above; for a cell
# of TP_F32_ANCHORED its losses, the updates held to the f32 run,
# ``f32_anchored``), the plain versions' split run (the kernels-vs-plain
# limits of TRAIN_UPDATE_REL's note: the first loss, the loss drops, the
# updates)
REFERENCE_RUN = {"one": "one-process run",
                 "plain": "plain versions' split run"}
TP_LIMITS = {"one": {"loss_rel": TP_LOSS_REL,
                     "update_rel_max": RANKS_UPDATE_REL},
             "f32": {"loss_rel": TP_LOSS_REL},
             "plain": {"loss0_rel": TRAIN_LOSS0_REL,
                       "drop_rel": TRAIN_DROP_REL,
                       "update_rel_max": TRAIN_UPDATE_REL}}
# K6 at a ragged head count: starcoder2-7b (36 query heads, 4 kv heads of
# 128) at model 8, where wq's even split cuts a head; rank 1 computes the
# padded group's heads [5, 10) (``attention.head_group``), which read kv
# heads 0, 0, 0, 0, 1 (nine query heads a kv head), so
# ``attention._local_kv_heads`` gives its five query heads five kv heads
TP_RAGGED = dict(arch="starcoder2-7b", model=8, rank=1)
# the shard form's ragged blocks (rows, cols, row width, column offset):
# odd widths and offsets, whose 16-byte vectors do not line up with the
# buckets (scalar loads): a column shard, a dim-0 shard at an odd
# offset, rows of 2-4 slabs from an odd column
TP_RAGGED_BLOCKS = ((3, 1001, 4097, 3095), (1, 70001, 200000, 129999),
                    (1500, 600, 1800, 1197))


def tp_placements(cfg, W: int, model: int, m: int):
    from repro_torch.core import tree
    from repro_torch.models import convert
    from repro_torch.sharding import MeshShape

    return tree.leaves(convert.placements(
        cfg, MeshShape(("data", "model"), (W, model)),
        {"data": 0, "model": m}))


def tp_leaf_dtypes(cfg) -> list:
    """Each leaf's dtype, in ``tp_placements``' order: its gradient's,
    which the shard form reads (mamba's A_log, dt_bias and D are f32 in
    a bf16 model)."""
    from repro_torch.core import tree
    from repro_torch.models import model as M

    return [t.dtype for t in tree.leaves(M.abstract_params(cfg))]


def shard_launch_name(dtype) -> str:
    """The shard form's launch count for blocks of ``dtype``."""
    return "sketch_shard" if str(dtype) == "torch.bfloat16" else \
        "sketch_shard_f32"


def tp_want(one, cfg, W: int, model: int, m: int) -> dict:
    """The launches of model rank m's W data ranks together in the run:
    K6 as the one-process run's (every worker's forward on the rank's
    heads), K4s's shard form once a split leaf and check member, by the
    leaf's dtype (``sketch_shard`` bf16, ``sketch_shard_f32`` f32), the
    single form once a replicated leaf and member on model rank 0, K3
    once a leaf and vote on each data rank (each votes every leaf's
    shard)."""
    pls = tp_placements(cfg, W, model, m)
    split = [shard_launch_name(dt)
             for pl, dt in zip(pls, tp_leaf_dtypes(cfg), strict=True)
             if pl.sharded]
    members = one["want"]["sketch"] // len(pls)
    return {"flash_attention": one["want"]["flash_attention"],
            "sketch_shard": members * split.count("sketch_shard"),
            "sketch_shard_f32": members * split.count("sketch_shard_f32"),
            "sketch": members * (len(pls) - len(split)) if m == 0 else 0,
            "pairwise_relmax_batched":
                W * one["want"]["pairwise_relmax_batched"]}


def tp_dryrun(torch, job, W: int, model: int, counted: dict,
              peaks: bool = False) -> dict:
    """The dry-run's meta trace of rank 0's fast step at W x ``model``
    (``launch.dryrun.run_bft_cells(mesh="tp")``, the run's active
    workers) against the step counted on the card: FLOPs, bytes (the
    copies that stage gloo's operands through the host are no part of
    either count) and collectives equal.  With ``peaks`` also the
    dry-run's peak a rank for each step kind (``predicted_peak_bytes``)."""
    from repro_torch.launch import dryrun as D

    tc = job.tc
    meta = D.run_bft_cells(
        job.cfg.name, job.bft.n, job.bft.f, global_batch=tc.global_batch,
        seq_len=tc.seq_len, opt=job.opt, mesh="tp", model=model,
        cfg=job.cfg, data_ranks=W, active=counted["active"],
        modes=("fast",))["fast"]
    same = (meta["flops"] == counted["flops"] and
            meta["bytes"] == counted["bytes"] and
            meta["collective_result_bytes"] ==
            counted["collective_result_bytes"] and
            meta["collective_by_axis"] == counted["collective_by_axis"])
    print(f"tp dry-run (meta, rank 0 of {W} x {model}) vs the card's fast "
          f"step: flops {meta['flops']:.6e} / {counted['flops']:.6e}, bytes "
          f"{meta['bytes']:.6e} / {counted['bytes']:.6e} (the card's host "
          f"staging, {counted['staged_bytes']} bytes, left out), "
          f"collectives by axis {meta['collective_by_axis']} / "
          f"{counted['collective_by_axis']}; peak {meta['peak_bytes']} / "
          f"{counted['peak_bytes']} bytes: equal {same}")
    check(same, f"tp dry-run differs from the card's step at {W} x {model}")
    out = dict(meta=meta, card={k: v for k, v in counted.items()
                                if k != "active"}, equal=same)
    if peaks:
        modes = ("fast", "check", "identify")
        steps = D.run_bft_cells(
            job.cfg.name, job.bft.n, job.bft.f,
            global_batch=tc.global_batch, seq_len=tc.seq_len, opt=job.opt,
            mesh="tp", model=model, cfg=job.cfg, data_ranks=W, modes=modes)
        out["predicted_peak_bytes"] = {m: steps[m]["peak_bytes"]
                                       for m in modes}
    return out


def f32_run(torch, job) -> dict:
    """``job``'s one-process run with its config in float32, from the
    bf16 run's initial parameters cast to f32 (exact), on the same
    batches, coins and Byzantine workers: history, walls, the final
    parameter leaves (CPU)."""
    from repro_torch.core import tree
    from repro_torch.models import model as M

    params = tree.tree_map(lambda x: x.float(), M.init_train(
        job.cfg, job.tc.seed, "cuda"))
    run = one_process_run(torch, dataclasses.replace(
        job, cfg=dataclasses.replace(job.cfg, dtype="float32")),
        params=params)
    return dict(history=run["history"], walls=run["walls"],
                final=run["final"][:run["n_params"]])


def f32_anchored(torch, init, split, one, steps, f32, hist, cfg) -> dict:
    """TP_F32_ANCHORED's update gate (CPU leaves): over the leaves the
    f32 run moves, rel(x) = ||x - f32|| / ||f32 - init|| (f32 on the
    card) of the split run's final leaves ``split`` and of the
    one-process bf16 run's ``one``, held to rel(split) <= rel(one) +
    TP_F32_MARGIN; the planted control, ``split`` less the one-process
    run's last step's update (``steps``, its params after each step),
    must fail it.  Also whether the f32 run's decisions are ``hist``'s
    and the last step a fast one."""
    from repro_torch.core import tree
    from repro_torch.models import model as M

    def ctl(h):
        return [{k: v for k, v in r.items() if k != "loss"} for r in h]

    paths = [p for p, _ in tree.leaves_with_paths(M.abstract_params(cfg))]
    rel_split, rel_one, rel_plant, moving = [], [], [], []
    for i, xs in enumerate(zip(init, split, one, f32["final"], steps[-1],
                               steps[-2])):
        p0, a, b, c, b1, b0 = (t.to("cuda").float() for t in xs)
        moved = float((c - p0).norm())
        if moved:
            rel_split.append(float((a - c).norm()) / moved)
            rel_one.append(float((b - c).norm()) / moved)
            rel_plant.append(float((a - (b1 - b0) - c).norm()) / moved)
            moving.append(paths[i])
        del p0, a, b, c, b1, b0
    excess = [x - y for x, y in zip(rel_split, rel_one)]
    plant = [x - y for x, y in zip(rel_plant, rel_one)]
    w, wp = excess.index(max(excess)), plant.index(max(plant))
    return dict(leaves=moving, rel_split=rel_split, rel_one=rel_one,
                rel_planted=rel_plant, excess_max=max(excess),
                worst_leaf=moving[w],
                worst=(rel_split[w], rel_one[w]),
                planted_excess_max=max(plant), planted_leaf=moving[wp],
                f32_control_equal=ctl(f32["history"]) == ctl(hist),
                last_step_fast="identified" not in hist[-1]
                and hist[-1]["f_t"] == 0, f32_walls=f32["walls"],
                passed=max(excess) <= TP_F32_MARGIN,
                planted_caught=max(plant) > TP_F32_MARGIN)


def tp_run(torch, spec, seed, mask, W: int, model: int, backend: str,
           label: str, base: dict | None = None,
           ref: str = "one", anchor: bool = False) -> tuple:
    """One split run against a reference run of the same job (see the
    note above TP_LOSS_REL): ``ref`` "one", the one-process run (taken
    from ``base`` when it holds this cell's, and kept there), or
    "plain", for a cell that one process cannot hold (TP_SPLIT_ONLY),
    the same split run on the plain versions (``impl="torch"``) with the
    kernels' run's routing (``RoutingTape``, model rank 0's, replayed on
    every rank).  Held to: control equal and exactly the Byzantine
    workers identified; every rank's gathered parameters bitwise alike
    (their checksums, and the leaves where every rank brings them); the
    losses and each leaf's update within ``TP_LIMITS[ref]``; launches
    by model rank as the protocol gives them, none in the plain run; a
    faulty check leaving every rank's state unchanged; a planted ulp
    caught; the fast step counted on the card equal to the dry-run's
    meta trace (against the plain run also the dry-run's peaks beside
    the ranks' measured peak).  With ``anchor`` (a cell of
    TP_F32_ANCHORED, ``ref`` "one") the updates are held to the cell's
    f32 one-process run instead (``f32_anchored``, the f32 run kept in
    ``base``).  Returns (report, the ranks' launches summed)."""
    import gc

    import numpy as np

    from repro_torch.core import tree
    from repro_torch.models import model as M

    base = {} if base is None else base
    cfg, opt, tc, attack, _ = train_cfg_objects(spec)
    if backend == "gloo":           # (a): every model sum staged via host
        actions = (("run", 2), ("count_fast", None),
                   ("model_all_reduce_bw", 1 << 26))
    else:
        actions = (("run", spec["steps"]), ("check_fault", 3),
                   ("count_fast", None), ("model_all_reduce_bw", 1 << 30))
    job = ranks_job(torch, cfg, opt, tc, attack, spec, seed, mask,
                    device="cuda", backend=backend, keep_params=True,
                    leaves_on=0 if ref == "plain" else None, plant=W > 1,
                    model=model, actions=actions)
    flips, plain = None, []
    if ref == "one":
        tape = RoutingTape() if cfg.moe else None
        if base.get("cell") != cfg.name:
            base.clear()
            with tape.record() if tape else contextlib.nullcontext():
                one = one_process_run(torch, job, keep_steps=True)
            base.update(cell=cfg.name, one=one, tape=tape and [
                tuple(t.cpu() for t in e) for e in tape.calls],
                        init=[x.detach().cpu() for x in tree.leaves(
                            M.init_train(cfg, tc.seed, "cuda"))])
        if anchor and "f32" not in base:
            base["f32"] = f32_run(torch, job)
        one, init = base["one"], base["init"]
        reference = dict(history=one["history"], walls=one["walls"],
                         final=one["final"][:one["n_params"]])
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if base["tape"] is None:
            results = spawn_ranks(torch, job, W * model)
        else:
            check(W == 1, "the routing replay follows one rank's worker "
                          "order")
            results = spawn_routed(torch, job, W * model, base["tape"])[0]
            flips = [(r["flips"], r["choices"]) for r in results]
        spawn_s = time.perf_counter() - t0
    else:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        results, calls = spawn_routed(torch, job, W * model)
        spawn_s = time.perf_counter() - t0
        plain = spawn_routed(torch, dataclasses.replace(
            job, impl="torch", plant=False, actions=actions[:1]),
            W * model, calls)[0]
        flips = [(r["flips"], r["choices"]) for r in plain]
        init = [x.detach().cpu() for x in tree.leaves(
            M.init_train(cfg, tc.seed, "cuda"))]
        reference = dict(history=plain[0]["main"]["history"],
                         walls=plain[0]["walls"],
                         final=plain[0]["params"]["main"])
    gc.collect()
    torch.cuda.empty_cache()

    def ctl(h):
        return [{k: v for k, v in r.items() if k != "loss"} for r in h]

    r0, rhist = results[0], reference["history"]
    hist = r0["main"]["history"]
    same_ctl = all(ctl(r["main"]["history"]) == ctl(rhist)
                   for r in results + plain)
    byz = sorted(int(w) for w in np.flatnonzero(job.true_byzantine))
    caught = sorted(w for r in hist for w in r.get("identified", []))
    d = train_run_diffs(torch, init, r0["params"]["main"], hist,
                        reference["final"], rhist, cfg)
    d["loss_rel"] = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                        for a, b in zip(hist, rhist))
    limits = TP_LIMITS["f32" if anchor else ref]
    within = d["still_equal"] and all(d[k] <= v for k, v in limits.items())
    anchored = f32_anchored(
        torch, init, r0["params"]["main"], reference["final"], one["steps"],
        base["f32"], rhist, cfg) if anchor else None
    if anchored is not None:
        within = within and anchored["passed"]
        a = anchored
        print(f"{label}: each leaf's distance to the f32 one-process run "
              f"(from the bf16 init cast to f32), ||x - f32|| / ||f32 - "
              f"init|| over the {len(a['leaves'])} leaves it moves: the "
              f"split {[round(x, 4) for x in a['rel_split']]}, the "
              f"one-process bf16 run "
              f"{[round(x, 4) for x in a['rel_one']]}; rel(split) - "
              f"rel(one) at most {a['excess_max']:.4f} (limit "
              f"{TP_F32_MARGIN}) at {a['worst_leaf']} ({a['worst'][0]:.4f} "
              f"against {a['worst'][1]:.4f}); the planted control (the "
              f"last fast step's update taken back) "
              f"{a['planted_excess_max']:.4f} at {a['planted_leaf']}; the "
              f"f32 run's decisions equal {a['f32_control_equal']}, its "
              f"step walls {[round(x, 3) for x in a['f32_walls']]} s")
    agree = all(r["agree"] and torch.equal(r["params_sum"]["main"],
                                           g[0]["params_sum"]["main"])
                for g in (results, plain) for r in g) and all(
        all(torch.equal(a, b) for a, b in zip(r["params"]["main"],
                                               r0["params"]["main"]))
        for r in results if "params" in r)
    one_want = {"want": want_from_history(job, hist)}
    want = [tp_want(one_want, cfg, W, model, m) for m in range(model)]
    got = [{k: sum(r["launches"][k] for r in results if r["model_rank"] == m)
            for k in want[m]} for m in range(model)]
    plain_launches = sum(sum(r["launches"].values()) for r in plain)
    probes = [{k: v for k, v in p.items() if k != "launches"}
              for r in results for p in r["check_fault"]]
    planted = [r["plant"] for r in results if "plant" in r]
    bw = r0["model_all_reduce_bw"]
    print(f"{label}: a model all-reduce of {bw['bytes']} bytes f32 over "
          f"{model} ranks ({backend}): {bw['seconds'] * 1e3:.3f} ms, bus "
          f"bandwidth {bw['busbw'] / 1e9:.2f} GB/s; the ranks' run "
          f"{spawn_s:.1f} s with start-up")
    dry = tp_dryrun(torch, job, W, model, r0["count_fast"],
                    peaks=ref == "plain")
    print(f"{label}: against the {REFERENCE_RUN[ref]} (routing replayed "
          f"where it routes: its own would have flipped (flips, choices) "
          f"{flips}): decisions equal {same_ctl} ({ctl(hist)}); Byzantine "
          f"{byz} identified {caught}; losses rel diff {d['loss_rel']:.3e}; "
          f"{train_diff_text(d, limits.get('update_rel_max'))}; held to "
          f"{limits}; every rank's gathered params bitwise alike: {agree}; "
          f"launches by model rank over its data ranks {got} (want "
          f"{want}); the plain run's kernel launches {plain_launches}; a "
          f"check with a Byzantine member: {probes}; planted ulp "
          f"{planted}; step walls by rank "
          f"{[[round(w, 3) for w in r['walls']] for r in results]} s "
          f"(reference {[round(w, 3) for w in reference['walls']]} s); "
          f"peak memory by rank {[r['peak_bytes'] for r in results]} "
          f"bytes (the dry-run's a rank {dry.get('predicted_peak_bytes')}); "
          f"data collectives {[r['counts'] for r in results]}; model "
          f"collectives {[r['model_counts'] for r in results]}; seconds "
          f"by action "
          f"{[[(a, round(t, 1)) for a, t in r['action_s']] for r in results]}")
    check(same_ctl and caught == byz and agree,
          f"{label}: the split run's decisions or ranks differ")
    check(within, f"{label}: the split run drifts from the "
                  f"{REFERENCE_RUN[ref]}" + (
                      " or lies farther from the f32 run than it"
                      if anchor else ""))
    if anchored is not None:
        check(anchored["f32_control_equal"] and anchored["last_step_fast"],
              f"{label}: the f32 run's decisions differ, or the last step "
              f"is not a fast one")
        check(anchored["planted_caught"],
              f"{label}: the planted control (the last fast step's update "
              f"taken back) passes the f32-anchored gate")
    check(got == want and plain_launches == 0,
          f"{label}: launches differ from the protocol's")
    check(all(p["any_fault"] and p["unchanged"] for p in probes),
          f"{label}: a faulty check changed a rank's state")
    check(all(p["caught"] and p["restored"] for p in planted),
          f"{label}: a planted ulp was not caught")
    out = dict(reference=ref, control_equal=same_ctl, identified=caught,
               loss_rel=d["loss_rel"], diffs=d, ranks_agree=agree,
               launches=got, want=want, check_fault=probes, planted=planted,
               flips=flips, walls=[r["walls"] for r in results],
               reference_walls=reference["walls"],
               peak_bytes=[r["peak_bytes"] for r in results],
               data_counts=[r["counts"] for r in results],
               model_counts=[r["model_counts"] for r in results],
               model_all_reduce_bw=bw, spawn_s=spawn_s, dryrun=dry,
               f32_anchored=anchored)
    launches = {k: sum(r["launches"][k] for r in results)
                for k in r0["launches"]}
    del results, plain, init, reference
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def expandable_segments() -> None:
    """A rank of an MoE split run allocates from expandable segments:
    the plain versions' run of jamba's experts left 25 GiB of a card
    reserved and unallocated in blocks too small for the identify
    step's 14 GiB gather.  Set before the rank's first CUDA call; the
    peaks read (``max_memory_allocated``) are the same either way."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")


def tp_rank_routed(rank: int, world: int, job, tape_path: str,
                   replay: bool) -> None:
    """A split run's rank whose MoE layers record their routing
    (``RoutingTape``; model rank 0's is written to ``tape_path``: every
    rank of a worker routes alike, the router's logits are gathered), or
    with ``replay`` take the routing at ``tape_path`` (the rank's own
    after the recorded steps) and write the flips beside the result: a
    top-k choice flips where a router margin lies under the rounding
    that the split's sums move, and a flip moves every later slot of its
    expert, so a split run is held against its reference with one
    routing."""
    import torch

    from repro_torch.launch import train as launch

    expandable_segments()
    tape = RoutingTape()
    if replay:
        tape.calls = torch.load(tape_path)
    with tape.replay(then_own=True) if replay else tape.record():
        launch.rank_main(rank, world, job)
    if replay:
        Path(job.out, f"flips{rank}.json").write_text(json.dumps(
            {"flips": tape.flips, "choices": tape.choices}))
    elif rank == 0:
        torch.save([tuple(t.cpu() for t in e) for e in tape.calls],
                   tape_path)


def spawn_routed(torch, job, world: int, calls=None) -> tuple:
    """``spawn_ranks`` with the MoE routing recorded, or with ``calls``
    (a ``RoutingTape``'s, on the CPU) replayed on every rank
    (``tp_rank_routed``): (results, with the flips where replayed; the
    calls)."""
    import shutil
    import tempfile

    from repro_torch.launch import train as launch

    out = Path(tempfile.mkdtemp(prefix="ranks_", dir=ROOT / "build"))
    try:
        tape_path = out / "tape.pt"
        if calls is not None:
            torch.save(calls, tape_path)
        job = dataclasses.replace(
            job, out=str(out),
            init_method=f"tcp://localhost:{launch.free_port()}")
        launch.start_ranks(tp_rank_routed, (world, job, str(tape_path),
                                            calls is not None), world)
        results = [torch.load(out / f"rank{r}.pt") for r in range(world)]
        if calls is not None:
            for r, res in enumerate(results):
                res.update(json.loads((out / f"flips{r}.json").read_text()))
        return results, torch.load(tape_path)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def tp_shard_rows(torch, cfg, model: int, tag: str = "") -> dict:
    """K4s's shard form at every split leaf's shard on the last model
    rank (a nonzero offset) of the cut model, in the leaf's own dtype
    (its gradient's on the training path: bf16, f32 for mamba's A_log,
    dt_bias and D): against its plain version and reruns bitwise, a bf16
    shard also bitwise its sketch of its f32 cast; the ragged blocks of
    TP_RAGGED_BLOCKS in bf16 and f32; timed at the largest shard in bf16
    and in f32, beside its plain version and ``index_add_`` over the
    signed values, the bound at the bytes read.  Rows
    ``sketch_shard<tag>`` (bf16) and ``sketch_shard_f32<tag>``, each
    with the worst error of its dtype's checks and timed input."""
    from repro_torch.core.detection import shard_block
    from repro_torch.kernels import ref as _ref
    from repro_torch.kernels import sketch as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    kk, key = 256, 0x2545F491
    bf16, f32 = torch.bfloat16, torch.float32
    report, worst, big = {}, {bf16: 0.0, f32: 0.0}, None
    for pl, dt in zip(tp_placements(cfg, 1, model, model - 1),
                      tp_leaf_dtypes(cfg), strict=True):
        if not pl.sharded:
            continue
        x = torch.randn(pl.local_shape, generator=gen, device=dev).to(dt)
        block, cfull, c0 = shard_block(x, pl)
        got = sk.sketch_block_cuda(block, key, kk, cfull, c0)
        want = sk.sketch_block_plain(block, key, kk, cfull, c0)
        rel = rel_err(got, want)
        worst[dt] = max(worst[dt], max_err(got, want))
        check(rel <= 1e-5, f"K4s shard form disagrees at {pl.local_shape} "
                           f"{dt}")
        check(bool(torch.equal(got, sk.sketch_block_cuda(block, key, kk,
                                                         cfull, c0))),
              f"K4s shard form rerun differs at {pl.local_shape} {dt}")
        if dt == bf16:
            check(bool(torch.equal(got, sk.sketch_block_cuda(
                block.float(), key, kk, cfull, c0))),
                  f"K4s shard form: bf16 differs from its f32 cast at "
                  f"{pl.local_shape}")
        print(f"K4s shard form at the shard {pl.local_shape} of {pl.shape} "
              f"{str(dt).removeprefix('torch.')} (block "
              f"{tuple(block.shape)}, row {cfull}, column {c0}): "
              f"max|kernel-plain| / max(1, max|plain|) = {rel:.3e} "
              f"(tolerance 1e-5); rerun bitwise equal"
              + ("; the f32 cast bitwise equal" if dt == bf16 else ""))
        if big is None or block.numel() > big[0].numel():
            big = (block, cfull, c0)
        del x, want
    for rows, cols, cfull, c0 in TP_RAGGED_BLOCKS:
        for dt in (bf16, f32):
            flat = torch.randn(rows * cols + 1, generator=gen,
                               device=dev).to(dt)
            for off in (0, 1):      # the pointer aligned, one element off
                b = flat[off:off + rows * cols].view(rows, cols)
                got = sk.sketch_block_cuda(b, key, kk, cfull, c0)
                want = sk.sketch_block_plain(b, key, kk, cfull, c0)
                worst[dt] = max(worst[dt], max_err(got, want))
                check(rel_err(got, want) <= 1e-5 and bool(torch.equal(
                    got, sk.sketch_block_cuda(b, key, kk, cfull, c0))),
                      f"K4s shard form disagrees or reruns apart at "
                      f"({rows}, {cols}) from {c0}, {dt}, offset {off}")
    print(f"K4s shard form at the ragged blocks {TP_RAGGED_BLOCKS} in bf16 "
          f"and f32, from an aligned pointer and one element off: within "
          f"1e-5 of plain, reruns bitwise")
    block, cfull, c0 = big
    d = block.numel()
    r = torch.arange(block.shape[0], device=dev, dtype=torch.int64)
    pos = (r[:, None] * cfull + c0 + torch.arange(
        block.shape[1], device=dev, dtype=torch.int64)[None]).reshape(-1)
    signed = block.reshape(-1).float() * _ref.hash_signs_ref(pos, key)
    bucket = pos % kk
    out = torch.zeros(kk, device=dev)
    library_ms = median_ms(torch, lambda: out.zero_().index_add_(
        0, bucket, signed), launches=10)
    del pos, r
    for dt, suffix in ((bf16, ""), (f32, "_f32")):
        blk = block.to(dt)
        got = sk.sketch_block_cuda(blk, key, kk, cfull, c0)
        want = sk.sketch_block_plain(blk, key, kk, cfull, c0)
        check(rel_err(got, want) <= 1e-5,
              f"K4s shard form disagrees at the timed {dt} block")
        worst[dt] = max(worst[dt], max_err(got, want))
        ms = median_ms(torch, lambda: sk.sketch_block_cuda(
            blk, key, kk, cfull, c0), launches=10)
        plain_ms = median_ms(torch, lambda: sk.sketch_block_plain(
            blk, key, kk, cfull, c0), reps=3, warm=1)
        dtype = str(dt).removeprefix("torch.")
        b_ms, b_by = kernel_bound("sketch_shard", d=d, k=kk, dtype=dtype)
        name = "sketch_shard" + suffix + tag
        report[name] = entry(name, "sketch.cu",
                             "src/repro/kernels/sketch.py:25", worst[dt], ms,
                             plain_ms, b_ms, b_by, library_ms)
        print(f"K4s shard form at the largest shard of {cfg.name} ({d} "
              f"elements, {tuple(block.shape)}) {dtype}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} index_add_ms={library_ms:.4f} (over "
              f"the signed f32 values) bound_ms={b_ms:.4f} ({b_by}, "
              f"{dtype} read); {b_ms / ms:.1%} of bound; max|kernel-plain| "
              f"over the {dtype} checks {worst[dt]:.3e}")
        del blk, got, want
    del block, signed, bucket, big
    return report


def tp_attention_row(torch, cfg, spec, model: int, tag: str = "") -> dict:
    """K6 at a rank's head count of the cut model (H / model query
    heads, K / model kv heads) at the training rows, timed beside SDPA:
    the row ``flash_attention_tp<tag>``."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    S, H, K, hd = spec["seq_len"], cfg.num_heads // model, \
        max(1, cfg.num_kv_heads // model), cfg.head_dim
    B = spec["global_batch"] // max(1, spec["n"] // (spec["f"] + 1))
    q, k, v = [torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16) for s in ((B, S, H, hd), (B, S, K, hd),
                                  (B, S, K, hd))]
    return {"flash_attention_tp" + tag: split_attention_row(
        torch, q, k, v, "flash_attention_tp" + tag, "a rank's heads")}


def split_attention_row(torch, q, k, v, name: str, what: str) -> dict:
    """K6 on a rank's q (B, S, H, hd) and k, v (B, S, K, hd), bf16:
    against its plain version (2e-2, each 64-row block within 1e-2),
    reruns bitwise, timed beside the plain version and SDPA; the row
    ``name``."""
    from repro_torch.kernels import flash_attention as fa

    F = torch.nn.functional
    B, S, H, hd = q.shape
    K = k.shape[2]
    got, want = fa.flash_attention_cuda(q, k, v), fa.flash_attention_plain(
        q, k, v)
    err, tile = max_err(got.float(), want.float()), tile_rel_err(got, want)
    check(close(got.float(), want.float(), 2e-2, 2e-2) and tile <= 1e-2,
          f"K6 disagrees at the split shape ({B}, {S}, {H}, {K})")
    check(bool(torch.equal(got, fa.flash_attention_cuda(q, k, v))),
          "K6 rerun differs at the split shape")
    ms = median_ms(torch, lambda: fa.flash_attention_cuda(q, k, v),
                   launches=20)
    plain_ms = median_ms(torch, lambda: fa.flash_attention_plain(q, k, v),
                         reps=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), launches=20)
    b_ms, b_by = attn_bound(B, S, S, H, K, hd, True, None, 2)
    row = entry(name, "flash_attention.cu",
                "src/repro/kernels/flash_attention.py:33", err, ms, plain_ms,
                b_ms, b_by, library_ms)
    print(f"K6 at {what} (B={B}, S={S}, H={H}, K={K}, hd={hd}) bf16: "
          f"max|kernel-plain| = {err:.3e}, worst 64-row block {tile:.3e}; "
          f"rerun bitwise equal; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"sdpa_ms={library_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    del q, k, v, qt, kt, vt, got, want
    return row


def ragged_attention_row(torch, spec) -> dict:
    """K6 at a ragged head count (TP_RAGGED): the rank's q heads from its
    padded head group and its k, v from ``attention._local_kv_heads`` on
    all of starcoder2-7b's kv heads, at TRAIN's rows; the row
    ``flash_attention_ragged``."""
    from repro_torch.configs import get_config
    from repro_torch.models.attention import _local_kv_heads, head_group

    cfg = get_config(TP_RAGGED["arch"])
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    first, Hl = head_group(H, TP_RAGGED["model"], TP_RAGGED["rank"])
    S = spec["seq_len"]
    B = spec["global_batch"] // max(1, spec["n"] // (spec["f"] + 1))
    gen = torch.Generator(device="cuda").manual_seed(28)
    q, kf, vf = [torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16) for s in ((B, S, Hl, hd), (B, S, K, hd),
                                  (B, S, K, hd))]
    k, v = _local_kv_heads(kf, vf, first, Hl, H // K)
    check(tuple(k.shape) == (B, S, Hl, hd) and H % TP_RAGGED["model"] != 0,
          f"the ragged rank's kv heads are {tuple(k.shape)}")
    return split_attention_row(
        torch, q, k.contiguous(), v.contiguous(), "flash_attention_ragged",
        f"{cfg.name}'s rank {TP_RAGGED['rank']} of {TP_RAGGED['model']}, "
        f"heads [{first}, {first + Hl})")


def tp_cards(torch, seed, mask, cards: int, cells=None) -> dict:
    """(b): one NCCL rank a card, the runs of TP_CARDS that fit (of
    ``cells``, the cells' names, where given); a cell of TP_SPLIT_ONLY
    against its plain versions' split run, with the kernels' rows at
    its split shapes (the shard form at its leaves' shards, K6 at a
    rank's heads) on this process's card.  A run whose check fails is
    reported and the next runs go on; the failed checks are in the
    report's ``failed``, which ``tp_cards_passed`` holds to none."""
    out, base, failed = {}, {}, []
    for label, cell, W, model in TP_CARDS:
        if cells is not None and cell not in cells:
            continue
        if W * model > cards:
            print(f"tp (b) {label}: not run, {cards} cards visible")
            continue
        spec = globals()[cell]
        ref = "plain" if cell in TP_SPLIT_ONLY else "one"
        try:
            out[label] = tp_run(torch, spec, seed, mask, W, model, "nccl",
                                f"tp (b) {label}", base, ref,
                                anchor=cell in TP_F32_ANCHORED)[0]
            if ref == "plain":
                cfg = cell_cfg(spec)
                tag = "_" + cfg.name.split("-")[0]
                out[label]["kernels"] = tp_shard_rows(torch, cfg, model, tag)
                if cfg.num_heads:
                    out[label]["kernels"].update(
                        tp_attention_row(torch, cfg, spec, model, tag))
        except SystemExit as e:
            print(e, flush=True)
            out[label] = {"failed": str(e)}
            failed.append(str(e))
    out["failed"] = failed
    return out


def tp_cards_passed(report: dict) -> None:
    check(not report["failed"], "; ".join(report["failed"]))


def want_from_history(job, hist) -> dict:
    """The protocol's launches of a run from its records: a check or a
    fast step by the f_t before it (the last record's, the config's f
    first), an identify round where a step identified, the active
    workers less those identified before."""
    from repro_torch.core import tree
    from repro_torch.models import model as M
    from repro_torch.models.transformer import attn_layer_indices

    L = len(attn_layer_indices(job.cfg))
    leaves = len(tree.leaves(M.abstract_params(job.cfg)))
    want = dict.fromkeys(("flash_attention", "sketch",
                          "pairwise_relmax_batched"), 0)
    f_t, active = job.bft.f, job.bft.n
    for rec in hist:
        for k, v in expected_train_launches(
                f_t, active, "identified" in rec, L, leaves,
                job.cfg.remat).items():
            want[k] += v
        f_t = rec["f_t"]
        active -= len(rec.get("identified", []))
    return want


def phase_train_tp(torch, spec):
    """The training cells' workers split over the model axis (see the
    note above TP_LOSS_REL): (a) two gloo ranks sharing the card at
    model 2, RANKS_CUT layers, for each cell of TP_A (``spec``, then
    mamba2-780m), with the shard form's rows at each cell's leaves and
    at jamba's at model 4, the split K6's and K6's at a ragged head
    count (TP_RAGGED); (b) one NCCL
    rank a card where more than one is visible.  Returns ({the (a) runs'
    launches summed over their ranks, by path}, the kernels line's rows,
    the report)."""
    import gc

    import numpy as np

    from repro_torch.launch import train as launch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    n, f, byz = spec["n"], spec["f"], spec["byz"]
    seed, mask = train_seed(n, f, byz), np.isin(np.arange(n), byz)
    cells = {"": spec, "_mamba": MAMBA_TRAIN}
    rows, out, launches = {}, {}, {}
    for tag, cell in cells.items():
        cut = dict(cell, layers=RANKS_CUT)
        cfg = cell_cfg(cut)
        rows.update(tp_shard_rows(torch, cfg, TP_SPLIT, tag))
        if cfg.num_heads:
            rows.update(tp_attention_row(torch, cfg, cut, TP_SPLIT, tag))
    # jamba's leaves at (b)'s split, model 4: the shard form alone
    rows.update(tp_shard_rows(torch, cell_cfg(JAMBA_TRAIN), 4, "_jamba"))
    rows["flash_attention_ragged"] = ragged_attention_row(torch, spec)
    try:
        for tag, cell in cells.items():
            cut = dict(cell, layers=RANKS_CUT)
            out["a" + tag], launches["training_tp" + tag] = tp_run(
                torch, cut, seed, mask, 1, TP_SPLIT, "gloo",
                f"tp (a) {cell['arch']}, two gloo ranks on one card, model "
                f"{TP_SPLIT}, {RANKS_CUT} layers")
        cards = torch.cuda.device_count()
        if cards > 1:
            out["b"] = tp_cards(torch, seed, mask, cards)
            tp_cards_passed(out["b"])
        else:
            print("tp (b): not run, 1 card visible")
    finally:
        launch.stop_rank_server()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase_train_tp: {out['phase_s']:.1f} s")
    return launches, rows, out


# ---------------------------------------------------------------------------
# the plain steps with FSDP + TP (``train.pjit_step`` on a mesh's ranks)
# ---------------------------------------------------------------------------

# phase_train_fsdp's cell: llama3.2-1b at full width, bf16, cut to
# RANKS_CUT layers, as two gloo ranks sharing the card at data 2 x model 1
# (every collective staged through host memory): two AdamW train steps on
# the global batch of 16 x 256 (each rank its 8 rows), a prefill of the
# same tokens and four decode steps, against the same steps in one
# process from the same initial parameters (``M.init_train`` drawn on the
# card from ``seed``, on every rank alike)
FSDP = dict(arch="llama3.2-1b", layers=RANKS_CUT, global_batch=16,
            seq_len=256, steps=2, decode=4, data=2, model=1, seed=11)
# ``scripts/chip_phases.py fsdp``: one NCCL rank a card, four cards;
# (label, cell, reference): the one-process run, or for starcoder2-7b,
# whose AdamW state (56 GB in f32 beside 14 GB of bf16 weights) one card
# cannot hold with its activations, the plain versions' split run.  The
# float32 cells (``fsdp_f32``) are llama3.2-1b's and phi3.5-moe's 2 x 2
# cells with the config in float32 on both sides, under the same gates
FSDP_CARDS = (
    ("llama3.2-1b data 2 x model 2",
     dict(FSDP, layers=None, steps=3, decode=8, model=2), "one"),
    ("llama3.2-1b data 4 x model 1",
     dict(FSDP, layers=None, steps=3, decode=8, data=4), "one"),
    ("phi3.5-moe 1 layer data 2 x model 2",
     dict(FSDP, arch="phi3.5-moe-42b-a6.6b", layers=1, steps=3, decode=8,
          model=2), "one"),
    ("starcoder2-7b data 2 x model 2",
     dict(FSDP, arch="starcoder2-7b", layers=None, steps=3, decode=0,
          model=2), "plain"),
    ("llama3.2-1b data 2 x model 2, float32",
     dict(FSDP, layers=None, steps=3, decode=8, model=2, dtype="float32"),
     "one"),
    ("phi3.5-moe 1 layer data 2 x model 2, float32",
     dict(FSDP, arch="phi3.5-moe-42b-a6.6b", layers=1, steps=3, decode=8,
          model=2, dtype="float32"), "one"))
FSDP_F32_CELLS = tuple(c[0] for c in FSDP_CARDS if c[1].get("dtype"))
# FSDP_ANCHORED: the two bf16 cells whose split lies a rounding's width
# from the one-process run (llama's wk update 0.1065 of it, limit
# RANKS_UPDATE_REL; phi's losses 2.5e-4, limit TP_LOSS_REL, logits 3.0x
# the limit), while their float32 cells meet those gates by orders of
# magnitude.  The one-process run with the split's rounding emulated and
# nothing split (``scripts/chip_phases.py fsdp_round``: each weight
# gradient formed from the data parts' partials, each rounded to bf16,
# summed in f32, rounded again; the model axis's partial products and
# input gradients rounded likewise, ``model_halves``) reads llama's
# updates at 0.095-0.106 on every matrix (its split 0.095-0.107) and
# phi's logits at 2.98x (its split 3.0x), its losses 5.2e-4; at data 4
# (data only, each part's forward at a rank's shapes) 0.0667 against
# the split's 0.0663: the misses are bf16 rounding (PERF.md section 6).
# These cells are held to their one-process run in float32 instead
# (``fsdp_one(..., f32=True)``: from the bf16 initial parameters cast to
# f32, the routing replayed, the decode fed the same tokens), each
# measure no farther from it than the one-process bf16 run's by a
# margin, and each with a planted control that must fail it:
#   updates  per leaf ||x - f32|| / ||f32 - init||, margin TP_F32_MARGIN
#            (TP_F32_ANCHORED's); plant: the split less the one-process
#            run's last update (``anchored_updates``);
#   losses   per step |x - f32| / |f32|, margin FSDP_F32_LOSS_MARGIN;
#            plant: the split run whose reduce-scatter drops a data
#            rank's partial (``dropped_partial``, ``anchored_losses``);
#   logits   per prefill / decode step the largest error over
#            FSDP_LOGITS_REL * (1 + max|f32 logits|), margin
#            FSDP_F32_LOGITS_MARGIN; the same plant (``anchored_logits``).
# The emulated split's excess read <= 0.0026 (updates), 5.5e-6
# (losses) and 0.26 (logits), its plants' >= 0.19, 0.023 and 17: the
# margins lie between, a factor >= 3.8 from each side.  The tokens are
# held to the one-process run's as in every cell.
FSDP_ANCHORED = ("llama3.2-1b data 2 x model 2",
                 "phi3.5-moe 1 layer data 2 x model 2")
FSDP_F32_LOSS_MARGIN = 1e-3
FSDP_F32_LOGITS_MARGIN = 1.0
# the limits: against the one-process run TP_LIMITS["one"] (the losses
# within TP_LOSS_REL, each leaf's update within RANKS_UPDATE_REL of the
# one-process update); against the plain versions' split run
# TP_LIMITS["plain"]; the prefill's and each teacher-forced decode
# step's logits within FSDP_LOGITS_REL * (1 + max|logits|) of the
# reference run's (serving's kernels-vs-plain limit: bf16 weights a few
# rounded updates apart), the greedy tokens equal where the reference's
# top-2 margin exceeds twice the difference; a rank's measured peak of
# its first train step within FSDP_PEAK_REL of the dry-run's meta trace
# of the same rank's step
FSDP_LOGITS_REL = 3e-2
FSDP_PEAK_REL = 0.01


def fsdp_opt():
    """The training cells' AdamW (TRAIN's learning rate, warm-up 1)."""
    from repro_torch.optim import OptConfig

    return OptConfig(kind="adamw", peak_lr=TRAIN["lr"], warmup_steps=1,
                     total_steps=100)


def warm_blas(torch, dev) -> None:
    """A product and its backward in bf16 and f32 on ``dev``: the cuBLAS
    handles of this thread and of autograd's device thread take their
    workspaces from the caching allocator at their first product, which
    a step's measured peak should not count (the dry-run does not)."""
    for dt in (torch.bfloat16, torch.float32):
        w = torch.ones(64, 64, device=dev, dtype=dt, requires_grad=True)
        (w @ w).sum().backward()
    torch.cuda.synchronize(dev)


def fsdp_batch(torch, cfg, spec, dev):
    """The cell's global tokens and labels (int32), seeded on the card."""
    g = torch.Generator(device=dev).manual_seed(spec["seed"] + 1)
    B, S = spec["global_batch"], spec["seq_len"]
    return tuple(torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                               device=dev, dtype=torch.int32)
                 for _ in range(2))


def fsdp_serve(torch, cfg, spec, params, tokens, prefill, decode,
               full_logits, rows, forced=None, mesh=None):
    """The prefill of ``tokens`` (this run's rows ``rows``; a rank's
    cache under ``mesh``) and ``spec["decode"]`` decode steps; greedy,
    or fed ``forced`` (the reference's input tokens, teacher-forced).
    Returns (prefill logits (B, V), [each step's logits (B, V)], [each
    step's input tokens]) on the CPU."""
    from repro_torch.models import model as M
    from repro_torch.sharding import set_mesh

    S, n = spec["seq_len"], spec["decode"]
    logits, cache = prefill(params, {"tokens": rows(tokens)})
    first = full_logits(logits)
    with set_mesh(mesh):
        padded = M.allocate_cache(cfg, rows(tokens).shape[0], S + n,
                                  logits.device)
    for k in ("k", "v"):
        if k in padded:
            padded[k][:, :, :S] = cache[k]
    del cache
    tok = first.argmax(-1).to(torch.int32)
    steps, inputs = [], []
    for t in range(n):
        if forced is not None:
            tok = forced[t].to(logits.device)
        inputs.append(tok.cpu())
        lg, padded = decode(params, rows(tok), S + t, padded)
        lg = full_logits(lg)
        steps.append(lg.cpu())
        tok = lg.argmax(-1).to(torch.int32)
    return first.cpu(), steps, inputs


def fsdp_one(torch, spec, tape=None, *, replay: bool = False,
             make_step=None, f32: bool = False, forced=None,
             keep_last: bool = False) -> dict:
    """The cell's steps in one process on the card (``pjit_step`` with no
    mesh): history, walls, K6 launches, initial and final parameters
    (CPU), the prefill's and the decode's logits and input tokens
    (greedy, or fed ``forced``).  The MoE routing is recorded on
    ``tape``, or replayed from it (``replay``).  ``make_step`` replaces
    ``pjit_step.make_train_step``; ``f32`` runs the config in float32
    from the bf16 run's initial parameters cast to f32 (exact);
    ``keep_last`` also returns the parameters before the last step
    (``prev``, CPU)."""
    import gc

    from repro_torch.core import tree
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.optim import init_opt_state
    from repro_torch.train import pjit_step

    dev = torch.device("cuda")
    cfg, opt = cell_cfg(spec), fsdp_opt()
    params = M.init_train(cfg, spec["seed"], dev)
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32")
        params = tree.tree_map(lambda x: x.float(), params)
    init = [t.to("cpu", copy=True) for t in tree.leaves(params)]
    state = init_opt_state(opt, params)
    tokens, labels = fsdp_batch(torch, cfg, spec, dev)
    step = (make_step or pjit_step.make_train_step)(cfg, opt)
    hist, walls, prev = [], [], None
    routed = contextlib.nullcontext() if tape is None else (
        tape.replay() if replay else tape.record())
    with routed:
        ops.reset_launch_counts()
        for i in range(spec["steps"]):
            if keep_last and i == spec["steps"] - 1:
                prev = [t.to("cpu", copy=True) for t in tree.leaves(params)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, {"tokens": tokens,
                                                    "labels": labels}, i)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            hist.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"])})
        del state
        gc.collect()
        serve = None
        if spec["decode"]:
            serve = fsdp_serve(torch, cfg, spec, params, tokens,
                               pjit_step.make_prefill_step(cfg),
                               pjit_step.make_decode_step(cfg),
                               lambda x: x, lambda x: x, forced)
        launches = ops.launch_counts()
    out = dict(history=hist, walls=walls, launches=launches, init=init,
               final=[t.cpu() for t in tree.leaves(params)], serve=serve,
               prev=prev)
    del params, tokens, labels
    gc.collect()
    torch.cuda.empty_cache()
    return out


def anchored_updates(sums) -> dict:
    """FSDP_ANCHORED's update measure from per-leaf squared norms, each
    summed over the ranks' blocks (``fsdp_anchor_sums``): [||split -
    f32||^2, ||one - f32||^2, ||plant - f32||^2, ||f32 - init||^2], with
    ``plant`` the split's leaves less the one-process run's last update.
    Over the leaves the f32 run moves, rel(x) = ||x - f32|| / ||f32 -
    init||; the split passes where rel(split) <= rel(one) +
    TP_F32_MARGIN on every leaf, and the plant must not."""
    excess, planted = [], []
    for a, b, c, m in sums:
        if m:
            excess.append(math.sqrt(a / m) - math.sqrt(b / m))
            planted.append(math.sqrt(c / m) - math.sqrt(b / m))
    return dict(excess=excess, excess_max=max(excess),
                planted_excess_max=max(planted),
                passed=max(excess) <= TP_F32_MARGIN,
                planted_caught=max(planted) > TP_F32_MARGIN)


def anchored_losses(split, one, f32, plant) -> dict:
    """FSDP_ANCHORED's loss measure over the train steps' losses (lists
    of floats): per step d(x) = |x - f32| / |f32|; the split passes where
    d(split) <= d(one) + FSDP_F32_LOSS_MARGIN at every step, and the
    plant (the split run whose reduce-scatter drops a data rank's
    partial, ``dropped_partial``) must not."""
    def ex(xs):
        return max((abs(x - c) - abs(o - c)) / abs(c)
                   for x, o, c in zip(xs, one, f32))

    e, pe = ex(split), ex(plant)
    return dict(excess_max=e, planted_excess_max=pe,
                passed=e <= FSDP_F32_LOSS_MARGIN,
                planted_caught=pe > FSDP_F32_LOSS_MARGIN)


def anchored_logits(split, one, f32, plant) -> dict:
    """FSDP_ANCHORED's logits measure over ``fsdp_serve``'s prefill and
    decode logits: per step the largest error from the f32 run's logits
    over FSDP_LOGITS_REL * (1 + max|f32 logits|) (``serve_measure``);
    the split passes where its error exceeds the one-process bf16 run's
    by at most FSDP_F32_LOGITS_MARGIN at every step, and the plant must
    not."""
    def errs(serve):
        return [logits_err(a, b) for a, b in zip(
            [serve[0]] + list(serve[1]), [f32[0]] + list(f32[1]))]

    base = errs(one)
    e = max(x - y for x, y in zip(errs(split), base))
    pe = max(x - y for x, y in zip(errs(plant), base))
    return dict(excess_max=e, planted_excess_max=pe,
                passed=e <= FSDP_F32_LOGITS_MARGIN,
                planted_caught=pe > FSDP_F32_LOGITS_MARGIN)


@contextlib.contextmanager
def dropped_partial():
    """The planted fault of FSDP_ANCHORED's losses and logits: the
    reduce-scatter of every FSDP leaf's gradient leaves out the last
    data rank's partial (that rank sends zeros), as a split that lost
    one rank's share of the batch would."""
    import torch

    from repro_torch.models import parallel

    real = parallel._FsdpGather.backward

    def backward(ctx, g):
        if ctx.ax.rank == ctx.ax.world - 1:
            g = torch.zeros_like(g)
        return real(ctx, g)

    parallel._FsdpGather.backward = staticmethod(backward)
    try:
        yield
    finally:
        parallel._FsdpGather.backward = staticmethod(real)


def logits_err(got, ref) -> float:
    """The largest error of logits ``got`` from ``ref`` over
    FSDP_LOGITS_REL * (1 + max|ref|)."""
    return float((got - ref).abs().max()) / (
        FSDP_LOGITS_REL * (1 + float(ref.abs().max())))


def serve_measure(serve, ref_serve) -> dict:
    """``fsdp_serve``'s prefill and decode logits against a reference
    run's: the largest error over FSDP_LOGITS_REL * (1 + max|ref|)
    (``logits_err_over_tol``), and the tokens held, equal wherever the
    reference's top-2 margin exceeds twice the error, of all."""
    (first, steps, _), (rfirst, rsteps, _) = serve, ref_serve
    errs, held, total = [], 0, 0
    for got, ref_lg in zip([first] + list(steps), [rfirst] + list(rsteps)):
        err = float((got - ref_lg).abs().max())
        errs.append(logits_err(got, ref_lg))
        top = ref_lg.topk(2, dim=-1).values
        clear = (top[:, 0] - top[:, 1]) > 2 * err
        same = got.argmax(-1) == ref_lg.argmax(-1)
        held += int((same | ~clear).sum())
        total += same.numel()
    return dict(logits_err_over_tol=max(errs), tokens_held=held,
                tokens=total)


def fsdp_anchor_sums(torch, mesh, init, final, one, prev, f32) -> list:
    """Per leaf [||split - f32||^2, ||one - f32||^2, ||plant - f32||^2,
    ||f32 - init||^2] over the mesh from each rank's blocks (CPU
    tensors; ``anchored_updates``): ``plant`` the split's leaves less the
    one-process run's last update (one - prev); the squares summed over
    every rank, as ``fsdp_leaf_diffs`` sums them."""
    import torch.distributed as dist

    rows = []
    for xs in zip(init, final, one, prev, f32):
        p0, a, b, b0, c = (t.to(mesh.device).float() for t in xs)
        rows.append([float((a - c).square().sum()),
                     float((b - c).square().sum()),
                     float((a - (b - b0) - c).square().sum()),
                     float((c - p0).square().sum())])
    t = torch.tensor(rows, dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t)
    return t.cpu().tolist()


def fsdp_leaf_diffs(torch, mesh, init, final, ref) -> list:
    """Per leaf (||final - ref||, ||ref - init||, unmoved and equal) over
    the mesh from each rank's blocks (CPU tensors): the squares summed
    over every rank, so a replicated block counts once a rank on both
    sides of the ratio."""
    import torch.distributed as dist

    rows = []
    for p0, a, b in zip(init, final, ref):
        p0, a, b = (t.to(mesh.device).float() for t in (p0, a, b))
        moved = float((b - p0).square().sum())
        rows.append([float((a - b).square().sum()), moved,
                     float(moved == 0.0 and bool((a == p0).all()))])
    t = torch.tensor(rows, dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t)
    return t.cpu().tolist()


def fsdp_bandwidth(torch, ax, nbytes: int) -> dict:
    """One all-reduce of ``nbytes`` f32 over axis ``ax``
    (``all_reduce_ordered`` on a data-like axis, ``all_reduce_sum`` on
    ``model``), timed once warm: its bus bandwidth,
    2 (n - 1) / n x bytes / s."""
    t = torch.ones(nbytes // 4, dtype=torch.float32, device=ax.device)
    run = getattr(ax, "all_reduce_ordered", None) or ax.all_reduce_sum
    run(t[:1024])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(t)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    n = ax.world
    return {"bytes": nbytes, "s": s,
            "bus_GBps": 2 * (n - 1) / n * nbytes / s / 1e9}


def fsdp_rank(rank: int, world: int, port: int, out: str, spec: dict,
              backend: str, ref_path: str, ref: str) -> None:
    """One rank of a FSDP + TP cell (``spec``: data x model ranks,
    ``backend``): the train steps on its blocks and rows (the first
    under ``memprobe.measure_peak``), their walls, the prefill and the
    decode teacher-forced by the reference's tokens, its launches and
    collectives, the per-leaf differences from the reference run at
    ``ref_path`` ("one": the one-process run's final parameters, sharded
    here; "plain": this rank's own run of the plain versions after the
    kernels' run, from the same initial parameters), the gathered
    parameters' checksums, each axis's bus bandwidth; the result to
    ``out/rank<r>.pt``.  The first train step is also counted on the
    card as the dry-run counts it on meta (``count_step``): in the run
    itself, or, where the run replays the one-process routing
    (``RoutingTape``, whose replay is no operator of the model), in a
    step of its own before the run, from the same initial parameters
    and batch, routed as the rank's own routing says."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.core import tree
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import memprobe
    from repro_torch.launch.mesh import make_step_mesh
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.optim import init_opt_state
    from repro_torch.train import pjit_step
    from repro_torch.train import ranks as R

    dev = R.rank_device(backend, "cuda", rank)
    R.init(backend, rank, world, init_method=f"tcp://localhost:{port}",
           device=dev)
    mesh = R.StepMesh(make_step_mesh(spec["data"], spec["model"],
                                     device_type="cuda"), dev)
    cfg, opt = cell_cfg(spec), fsdp_opt()
    pls = convert.placements(cfg, mesh.mesh, rules=sharding.PARAM_RULES)
    reference = torch.load(ref_path, mmap=True) if ref == "one" else {}
    tape = None
    if reference.get("tape") is not None:
        tape = RoutingTape()
        n = mesh.batch_parts
        tape.calls = [tuple(t.chunk(n)[mesh.batch_index] for t in e)
                      for e in reference["tape"]]

    def rows(x):
        return mesh.local_rows(x).clone()

    def setup(impl):
        full = M.init_train(cfg, spec["seed"], dev)
        params = convert.shard_params(full, pls)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        state = init_opt_state(opt, params)
        tokens, labels = fsdp_batch(torch, cfg, spec, dev)
        batch = {"tokens": rows(tokens), "labels": rows(labels)}
        step = pjit_step.make_train_step(cfg, opt, impl=impl, mesh=mesh)
        return params, state, tokens, batch, step

    def counted_step():
        params, state, _, batch, step = setup(None)
        counted = D.count_step(step, (params, state, batch, 0), "cuda",
                               group=world)[1]
        del params, state, batch
        gc.collect()
        torch.cuda.empty_cache()
        return counted

    def run(impl, counted=None, probe=True):
        params, state, tokens, batch, step = setup(impl)
        init = [t.to("cpu", copy=True) for t in tree.leaves(params)]
        warm_blas(torch, dev)
        hist, walls, mem = [], [], None
        ops.reset_launch_counts()
        for i in range(spec["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0 and impl is None and probe:
                # step 0's allocator peak read, and the step counted on
                # the card unless it was counted on its own
                if counted is None:
                    (res, counted), mem = memprobe.measure_peak(
                        lambda *a: D.count_step(step, a, "cuda",
                                                group=world),
                        (params, state, batch, 0), dev)
                else:
                    res, mem = memprobe.measure_peak(
                        step, (params, state, batch, 0), dev)
            else:
                res = step(params, state, batch, i)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            params, state, m = res
            hist.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"])})
            del res, m
        del state
        gc.collect()
        torch.cuda.empty_cache()
        serve = None
        if spec["decode"] and impl is None:
            forced = reference["serve"][2] if reference else None
            serve = fsdp_serve(
                torch, cfg, spec, params, tokens,
                pjit_step.make_prefill_step(cfg, mesh=mesh),
                pjit_step.make_decode_step(cfg, mesh=mesh),
                lambda lg: mesh.full_logits(lg, cfg.vocab_size), rows,
                forced, mesh)
        launches = ops.launch_counts()
        return dict(history=hist, walls=walls, peak=mem, launches=launches,
                    init=init, params=params, serve=serve, counted=counted)

    counted = counted_step() if tape else None
    base = mesh.counts()
    with tape.replay(then_own=True) if tape else contextlib.nullcontext():
        kern = run(None, counted)
    counts = {a: {k: n - base[a][k] for k, n in c.items()}
              for a, c in mesh.counts().items()}
    final = [t.cpu() for t in tree.leaves(kern["params"])]
    full = convert.gather_params(kern["params"], pls, mesh)
    sums = R.checksums(full).cpu()
    del full, kern["params"]
    gc.collect()
    torch.cuda.empty_cache()
    if ref == "one":
        ref_final = convert.shard_params(tree.unflatten(
            M.abstract_params(cfg), reference["final"]), pls)
        ref_final, ref_hist = tree.leaves(ref_final), reference["history"]
    else:
        plain = run("torch")
        ref_final = [t.cpu() for t in tree.leaves(plain["params"])]
        ref_hist = plain["history"]
        del plain
    diffs = fsdp_leaf_diffs(torch, mesh, kern["init"], final, ref_final)
    anchored = {}
    if reference.get("f32") is not None:
        def shard(leaves):
            return tree.leaves(convert.shard_params(tree.unflatten(
                M.abstract_params(cfg), leaves), pls))

        anchored["anchor"] = fsdp_anchor_sums(
            torch, mesh, kern["init"], final, ref_final,
            shard(reference["prev"]), shard(reference["f32"]["final"]))
        with dropped_partial(), tape.replay(then_own=True) if tape else \
                contextlib.nullcontext():
            plant = run(None, probe=False)
        anchored.update(plant_history=plant["history"],
                        plant_serve=plant["serve"])
        del plant
    bw = {a: fsdp_bandwidth(torch, ax, 64 << 20 if ax.staged else 1 << 30)
          for a, ax in mesh.axes.items()}
    result = dict(history=kern["history"], ref_history=ref_hist,
                  walls=kern["walls"], peak=kern["peak"],
                  counted=kern["counted"],
                  launches=kern["launches"], counts=counts, sums=sums,
                  diffs=diffs, bandwidth=bw,
                  serve=kern["serve"],
                  coords=mesh.coords, batch_index=mesh.batch_index,
                  **anchored)
    if tape is not None:
        result.update(flips=tape.flips, choices=tape.choices)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def fsdp_run(torch, label: str, spec: dict, backend: str, ref: str,
             strict: bool = True) -> tuple:
    """One FSDP + TP cell: its reference run (``fsdp_one`` for "one"),
    its ranks (``fsdp_rank``, data x model of them, ``backend``), the
    dry-run's meta trace of rank 0's first train step, held to rank 0's
    step counted on the card (FLOPs, bytes, collectives); every gate of
    the note above FSDP_LOGITS_REL held (``strict``: failed at once;
    else listed in the report's ``fails``).  Returns (the report, K6's
    launches summed over the ranks)."""
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import train as launch
    from repro_torch.models import model as M
    from repro_torch.sharding import MeshShape

    t_run = time.perf_counter()
    cfg = cell_cfg(spec)
    anchored = label in FSDP_ANCHORED and ref == "one"
    f32 = None
    world = spec["data"] * spec["model"]
    B, S, L = spec["global_batch"], spec["seq_len"], cfg.num_layers
    shape = ShapeConfig("fsdp", S, B, "train")
    meta = D.lower_compile(cfg, shape, fsdp_opt(), mesh=MeshShape(
        ("data", "model"), (spec["data"], spec["model"])))
    out_dir = Path(tempfile.mkdtemp(prefix="fsdp_", dir=ROOT / "build"))
    try:
        one = None
        ref_path = out_dir / "ref.pt"
        if ref == "one":
            tape = RoutingTape() if cfg.moe is not None else None
            one = fsdp_one(torch, spec, tape, keep_last=anchored)
            if anchored:
                # the f32 anchor: routed and fed the tokens as the split is
                f32 = fsdp_one(torch, spec, tape, replay=True, f32=True,
                               forced=one["serve"][2])
                f32.pop("init")
            torch.save({"final": one["final"], "history": one["history"],
                        "serve": one["serve"], "prev": one.pop("prev"),
                        "f32": f32,
                        "tape": None if tape is None else [
                            tuple(t.cpu() for t in e) for e in tape.calls]},
                       ref_path)
        gc.collect()
        torch.cuda.empty_cache()
        launch.start_ranks(fsdp_rank, (world, launch.free_port(),
                                       str(out_dir), spec, backend,
                                       str(ref_path), ref), world)
        results = [torch.load(out_dir / f"rank{r}.pt")
                   for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    r0 = results[0]
    paths = [p for p, _ in tree.leaves_with_paths(M.abstract_params(cfg))]
    rel = [math.sqrt(d / m) if m else 0.0 for d, m, _ in r0["diffs"]]
    still = all(s == world for d, m, s in r0["diffs"] if m == 0.0)
    worst = paths[rel.index(max(rel))]
    hist, ref_hist = r0["history"], r0["ref_history"]
    limits = TP_LIMITS[ref]
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(hist, ref_hist))
    report = dict(label=label, backend=backend, world=world, ref=ref,
                  history=hist, ref_history=ref_hist, update_rel=rel,
                  update_rel_max=max(rel), worst_leaf=worst,
                  unmoved_equal=still, loss_rel=loss_rel,
                  walls=[r["walls"] for r in results],
                  one_process_walls=one and one["walls"],
                  peaks=[r["peak"]["peak_bytes"] for r in results],
                  meta_peak=meta["peak_bytes"],
                  meta_collective_by_axis=meta["collective_by_axis"],
                  counts=[r["counts"] for r in results],
                  bandwidth=[r["bandwidth"] for r in results],
                  launches=[r["launches"] for r in results])
    fails = []

    def holds(cond: bool, msg: str) -> None:
        if not cond:
            fails.append(msg)

    for r in results:
        holds(torch.equal(r["sums"], r0["sums"]),
              f"fsdp {label}: rank {r['coords']} holds other bits than "
              f"rank 0 (a replicated leaf or a gathered block)")
        holds(r["history"] == hist, f"fsdp {label}: ranks disagree on the "
                                    f"losses")
    if anchored:
        losses = [[h["loss"] for h in x] for x in (
            hist, ref_hist, f32["history"], r0["plant_history"])]
        report["anchored"] = dict(
            updates=anchored_updates(r0["anchor"]),
            losses=anchored_losses(*losses),
            logits=anchored_logits(r0["serve"], one["serve"], f32["serve"],
                                   r0["plant_serve"]),
            f32_losses=losses[2], plant_losses=losses[3])
        for what in ("updates", "losses", "logits"):
            m = report["anchored"][what]
            holds(m["passed"], f"fsdp {label}: the split's {what} lie "
                  f"{m['excess_max']:.4g} farther from the f32 run than "
                  f"the one-process bf16 run's (FSDP_ANCHORED)")
            holds(m["planted_caught"], f"fsdp {label}: the {what} measure "
                  f"passes its planted control (excess "
                  f"{m['planted_excess_max']:.4g}): it cannot tell a fault")
    elif ref == "one":
        holds(loss_rel <= limits["loss_rel"],
              f"fsdp {label}: losses {loss_rel:.3e} from the one-process "
              f"run's (limit {limits['loss_rel']})")
    else:
        d = train_run_diffs_from(hist, ref_hist)
        report.update(d)
        holds(d["loss0_rel"] <= limits["loss0_rel"] and
              d["drop_rel"] <= limits["drop_rel"],
              f"fsdp {label}: losses off the plain versions' split run "
              f"({d})")
    holds((anchored or max(rel) <= limits["update_rel_max"]) and still,
          f"fsdp {label}: a leaf's update lies {max(rel):.4f} from the "
          f"reference's (limit {limits['update_rel_max']}, at {worst}); "
          f"unmoved leaves equal {still}")
    want_k6 = (2 * spec["steps"] + (1 if spec["decode"] else 0)) * L \
        if cfg.num_heads else 0
    k6 = [r["launches"]["flash_attention"] for r in results]
    holds(all(n == want_k6 for n in k6),
          f"fsdp {label}: K6 launched {k6} a rank, {want_k6} expected "
          f"(twice a layer a train step under the checkpoint, once in the "
          f"prefill)")
    card = r0["counted"]
    equal = {k: card[k] == meta[k] for k in ("flops", "bytes",
                                             "collective_by_axis")}
    report.update(counted_peak=card["peak_bytes"], counted_equal=equal)
    holds(all(equal.values()), f"fsdp {label}: rank 0's first step counted "
          f"on the card differs from the dry-run's meta trace ({equal}: "
          f"flops {card['flops']} / {meta['flops']}, bytes {card['bytes']} "
          f"/ {meta['bytes']})")
    peak_rel = [p / meta["peak_bytes"] - 1 for p in report["peaks"]]
    report["peak_rel"] = peak_rel
    holds(all(abs(x) <= FSDP_PEAK_REL for x in peak_rel),
          f"fsdp {label}: a rank's peak lies {peak_rel} off the dry-run's "
          f"{meta['peak_bytes']} bytes (limit {FSDP_PEAK_REL})")
    if spec["decode"] and ref == "one":
        report.update(serve_measure(r0["serve"], one["serve"]))
        holds((anchored or report["logits_err_over_tol"] <= 1.0) and
              report["tokens_held"] == report["tokens"],
              f"fsdp {label}: prefill / decode logits "
              f"{report['logits_err_over_tol']:.3f} of the limit, tokens "
              f"held {report['tokens_held']} of {report['tokens']}")
    if cfg.moe is not None:
        report["flips"] = sum(r.get("flips", 0) for r in results)
        report["choices"] = sum(r.get("choices", 0) for r in results)
    report["run_s"] = time.perf_counter() - t_run
    mib = [round(p / 2**30, 4) for p in report["peaks"]]
    coll = {a: sum(c[a]["bytes"] for c in report["counts"]) / world
            for a in report["counts"][0]}
    bus = {a: round(b[a]["bus_GBps"], 2) for b in report["bandwidth"][:1]
           for a in b}
    losses = [round(h["loss"], 6) for h in hist]
    ref_losses = [round(h["loss"], 6) for h in ref_hist]
    print(f"fsdp {label} ({backend}, {world} ranks): losses {losses} "
          f"vs {ref} {ref_losses} (rel "
          f"{loss_rel:.2e}); leaf updates within {max(rel):.4f} of the "
          f"reference's (at {worst}); ranks bitwise; walls a rank "
          f"{[[round(w, 3) for w in ws] for ws in report['walls']]} s"
          + (f", one process {[round(w, 3) for w in one['walls']]} s"
             if one else "")
          + f"; peaks {mib} GiB vs the dry-run's "
          f"{meta['peak_bytes'] / 2**30:.4f} "
          f"({[f'{x:+.3%}' for x in peak_rel]}; "
          f"the counter on the card {card['peak_bytes'] / 2**30:.4f}, FLOPs, "
          f"bytes and collectives equal to meta's {equal}); "
          f"collective result bytes a rank by axis {coll} (meta wire bytes "
          f"{meta['collective_by_axis']}); bus {bus} GB/s; K6 {k6} a rank"
          + (f"; logits {report['logits_err_over_tol']:.3f} of the limit, "
             f"tokens held {report['tokens_held']}/{report['tokens']}"
             if "tokens" in report else "")
          + (f"; routing replayed, {report['flips']} of "
             f"{report['choices']} choices flip" if "flips" in report
             else "")
          + ("; anchored to the f32 run (split's excess over one "
             "process's distance, its plant's): " + ", ".join(
                 f"{k} {m['excess_max']:.4g} / {m['planted_excess_max']:.4g}"
                 for k, m in report["anchored"].items() if k in (
                     "updates", "losses", "logits")) if anchored else "")
          + f"; {report['run_s']:.1f} s")
    report["fails"] = fails
    for msg in fails if strict else ():
        check(False, msg)
    return report, sum(k6)


def train_run_diffs_from(hist, ref_hist) -> dict:
    """The loss terms of two runs' histories: the first loss's relative
    difference, and the largest difference of a later loss's drop from
    the first over the reference's drop."""
    loss0_rel = abs(hist[0]["loss"] - ref_hist[0]["loss"]) / abs(
        ref_hist[0]["loss"])
    drop_rel = max(
        abs((a["loss"] - hist[0]["loss"]) - (b["loss"] - ref_hist[0]["loss"]))
        / abs(b["loss"] - ref_hist[0]["loss"])
        for a, b in zip(hist[1:], ref_hist[1:]))
    return dict(loss0_rel=loss0_rel, drop_rel=drop_rel)


def fsdp_attention_row(torch, spec, tag: str = "") -> dict:
    """K6 at a FSDP + TP rank's shape: its rows of the batch (global /
    (data)), its heads (H / model, K / model), the row
    ``flash_attention_fsdp<tag>``."""
    cfg = cell_cfg(spec)
    gen = torch.Generator(device="cuda").manual_seed(30)
    B = spec["global_batch"] // spec["data"]
    S, H, K, hd = spec["seq_len"], cfg.num_heads // spec["model"], \
        max(1, cfg.num_kv_heads // spec["model"]), cfg.head_dim
    q, k, v = [torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16) for s in ((B, S, H, hd), (B, S, K, hd),
                                  (B, S, K, hd))]
    return {"flash_attention_fsdp" + tag: split_attention_row(
        torch, q, k, v, "flash_attention_fsdp" + tag,
        f"a FSDP rank's rows and heads ({spec['arch']}, data "
        f"{spec['data']} x model {spec['model']})")}


def phase_train_fsdp(torch, spec=FSDP):
    """The plain steps with FSDP + TP (see FSDP's note): two gloo ranks
    sharing the card against the one-process run, K6 at a rank's shape.
    Returns ({"training_fsdp": K6's launches over the ranks}, the
    kernels line's row, the report)."""
    from repro_torch.launch import train as launch

    t_phase = time.perf_counter()
    row = fsdp_attention_row(torch, spec)
    try:
        report, k6 = fsdp_run(
            torch, f"{spec['arch']} {cell_cfg(spec).num_layers} layers, data "
            f"{spec['data']} x model {spec['model']}, two gloo ranks on one "
            f"card", spec, "gloo", "one")
    finally:
        launch.stop_rank_server()
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"phase_train_fsdp: {report['phase_s']:.1f} s")
    return {"training_fsdp": {"flash_attention": k6}}, row, report


def fsdp_cards(torch, cells=None) -> dict:
    """FSDP_CARDS (``cells`` by label, all by default) with one NCCL rank
    a card, and K6 at each cell's rank shape."""
    from repro_torch.launch import train as launch

    out = {}
    try:
        for label, spec, ref in FSDP_CARDS:
            if cells is not None and label not in cells:
                continue
            out[label], _ = fsdp_run(torch, label, spec, "nccl", ref,
                                     strict=False)
            tag = "_" + spec["arch"].split("-")[0].replace(".", "") + \
                f"_{spec['data']}x{spec['model']}"
            out[label]["kernel_row"] = fsdp_attention_row(torch, spec, tag)
    finally:
        launch.stop_rank_server()
    return out


def fsdp_cards_passed(report: dict) -> None:
    """Fail on the first gate any cell of ``fsdp_cards`` missed."""
    for cell in report.values():
        for msg in cell["fails"]:
            check(False, msg)


# ``long_500k``'s decode (ROADMAP item 7b.1): batch 1 on every rank
# (``StepMesh.for_batch``), the KV cache's 524,288 positions split over
# ``data`` (``make_decode_step(..., long_context=True)``), the decode
# attention combining the ranks' blocks (the logits' max all-reduced, the
# f32 sums and P.V partials summed in rank order).  The cache is filled
# from the seed below the block boundary S / 2 (LONG_CHUNK positions a
# seeded draw, so each rank draws its block alone, with the bits of the
# one-process run's; the keys times LONG_KEY_SCALE), then ``steps``
# greedy steps from S / 2 - 1 cross
# it; every run is fed the one-process run's tokens.  Held against the
# one-process decode on the same cache on the same card: the logits
# within FSDP_LOGITS_REL * (1 + max|logits|), the tokens equal where the
# one-process run's top-2 margin exceeds twice the error, every rank's
# logits bitwise alike; rank 0's first step counted on the card equal to
# the dry-run's meta trace of that rank at the same position (FLOPs,
# bytes, collectives), and each rank's peak in its first step within
# FSDP_PEAK_REL of the meta trace of that rank (whose block of the cache
# the step reads).  A decode step before the run, its outputs dropped,
# takes the libraries' lazy workspaces, which no trace holds (it writes
# the first step's k, v, the same values again; the mamba state is
# functional).  The planted control, a combine over ``data`` that leaves
# out one rank's share (in the global layers, rank 0's P.V partial: the
# values of a block that at data 4 only they read; for a model without a
# KV cache, a rank's slice of each gathered weight: ``left_out_block``),
# must fail the logits gate.  The
# script's phase: gemma3-1b at full width (26 layers,
# one kv head of 256, window 512 on the local layers) as two gloo ranks
# on one card at data 2; ``scripts/chip_phases.py long``: LONG_CARDS with
# one NCCL rank a card
LONG_DECODE = dict(arch="gemma3-1b", seq_len=524288, data=2, model=1,
                   steps=3, seed=41)
LONG_CARDS = (
    ("gemma3-1b data 4", dict(LONG_DECODE, data=4)),
    ("gemma3-1b data 2 x model 2", dict(LONG_DECODE, model=2)),
    ("mamba2-780m data 4", dict(LONG_DECODE, arch="mamba2-780m", data=4)),
    # jamba at full width cut to layers 0-7, one attention layer among
    # seven mamba layers and four MoE layers (26.6 GB in bf16): what one
    # card's one-process run holds beside the cache
    ("jamba 8 layers data 2 x model 2",
     dict(LONG_DECODE, arch="jamba-v0.1-52b", layers=8, model=2)))
LONG_CHUNK = 4096
# the seeded keys' scale: a query of unit RMS a head dim (gemma3's
# qk-norm) reads a logit of about this standard deviation from each, so
# over S / 2 keys the softmax weight lies on some tens of them, in every
# block alike (at 1 it spreads over all, and a global layer's output is
# about the mean of S / 2 random values, nearly 0: a gate would not see
# a block of them go missing)
LONG_KEY_SCALE = 3.0


def long_first(spec) -> int:
    """The first decode position: one before the block boundary S / 2."""
    return spec["seq_len"] // 2 - 1


def long_cache(torch, cfg, spec, dev):
    """The cell's decode cache on ``dev``, this rank's part under the
    ambient mesh (``models.model.allocate_cache(..., long_context=True)``):
    k (times LONG_KEY_SCALE), v drawn from the seed LONG_CHUNK positions a
    draw below ``long_first``, zero from there; each mamba tensor a draw a
    layer.
    A rank draws only the chunks of its block and takes its columns, so
    its bits are the one-process cache's."""
    from repro_torch.models import model as M

    S, filled = spec["seq_len"], long_first(spec)
    cache = M.allocate_cache(cfg, 1, S, dev, long_context=True)
    pls = M.cache_placements(cfg, 1, S, long_context=True)
    full = M.cache_layout(cfg, 1, S)
    leaves = [(k, None) for k in ("k", "v") if k in full] + [
        ("mamba", n) for n in full.get("mamba", {})]
    for i, (k, n) in enumerate(leaves):
        t = cache[k] if n is None else cache[k][n]
        shape = full[k][0] if n is None else full[k][n][0]
        pl = None if pls is None else (pls[k] if n is None else pls[k][n])
        sl = pl.slices if pl is not None and pl.sharded else tuple(
            slice(0, d) for d in shape)

        def draw(dims, layer, chunk=0):
            g = torch.Generator(device=dev).manual_seed(
                ((spec["seed"] * 131 + i) * 1009 + layer) * 100003 + chunk)
            x = torch.randn(dims, generator=g, device=dev,
                            dtype=torch.float32)
            return (x * LONG_KEY_SCALE if k == "k" else x).to(t.dtype)

        for layer in range(shape[0]):
            if n is not None:
                t[layer] = draw(shape[1:], layer)[sl[1:]]
                continue
            lo, hi = sl[2].start, sl[2].stop
            for c in range(lo // LONG_CHUNK, min(hi, filled) // LONG_CHUNK
                           + 1):
                a = max(c * LONG_CHUNK, lo)
                b = min((c + 1) * LONG_CHUNK, filled, hi)
                if b > a:
                    x = draw((shape[1], LONG_CHUNK, shape[3]), layer, c)
                    t[layer, :, a - lo:b - lo] = x[
                        :, a - c * LONG_CHUNK:b - c * LONG_CHUNK, sl[3]]
    return cache


def long_tokens(torch, cfg, spec):
    """The cell's first input token (one row, int32), from the seed."""
    g = torch.Generator().manual_seed(spec["seed"])
    return torch.randint(0, cfg.vocab_size, (1,), generator=g,
                         dtype=torch.int32)


def long_one(torch, spec) -> dict:
    """The cell's greedy decode in one process on the card: each step's
    logits and input token (CPU), walls."""
    import gc

    from repro_torch.models import model as M
    from repro_torch.train import pjit_step

    dev = torch.device("cuda")
    cfg = cell_cfg(spec)
    params = M.init_train(cfg, spec["seed"], dev)
    cache = long_cache(torch, cfg, spec, dev)
    decode = pjit_step.make_decode_step(cfg)
    tok = long_tokens(torch, cfg, spec).to(dev)
    logits, inputs, walls = [], [], []
    for t in range(spec["steps"]):
        inputs.append(tok.cpu())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = decode(params, tok, long_first(spec) + t, cache)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        logits.append(lg.cpu())
        tok = lg.argmax(-1).to(torch.int32)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return dict(logits=logits, inputs=inputs, walls=walls)


@contextlib.contextmanager
def left_out_block(has_cache: bool, rank: int = 0):
    """The long decode's planted control: the combine over ``data``
    leaves out data rank ``rank``'s share.  With a KV cache, the global
    layers' combine (``decode_attention`` without a window) sums every
    rank's P.V partial but that rank's, whose block's values then count
    for nothing in those layers while its softmax weights still divide
    the others' (at data 4 with the steps from LONG_DECODE's first
    position, rank 0's block is one that only the global layers read);
    without one (mamba2), the gathers of the weights' d_model slices
    take zeros for that rank's slice."""
    import torch

    from repro_torch.models import attention as A
    from repro_torch.train import ranks as R

    class Left:
        """A data axis whose ordered sum of P.V partials (the (B, K, G,
        hd) operand) takes zeros from rank ``rank``."""

        def __init__(self, ax):
            self.ax = ax

        def __getattr__(self, name):
            return getattr(self.ax, name)

        def all_reduce_ordered(self, t):
            if t.dim() == 4 and self.ax.rank == rank:
                t = torch.zeros_like(t)
            return self.ax.all_reduce_ordered(t)

    def attention(*a, window=None, seq=None, **kw):
        if seq is not None and window is None:
            seq = (Left(seq[0]), seq[1])
        return real(*a, window=window, seq=seq, **kw)

    def gathered(self, rows):
        out = real(self, rows)
        if self.axis == "data":
            n = rows.shape[0]
            out[rank * n:(rank + 1) * n] = 0
        return out

    owner, name = (A, "decode_attention") if has_cache else (
        R.DataAxis, "all_gather_rows")
    real = getattr(owner, name)
    setattr(owner, name, attention if has_cache else gathered)
    try:
        yield
    finally:
        setattr(owner, name, real)


def long_rank(rank: int, world: int, port: int, out: str, spec: dict,
              backend: str, ref_path: str) -> None:
    """One rank of a long-decode cell (data x model ranks, ``backend``):
    its blocks of the parameters (``PARAM_RULES``) and of the seeded
    cache, the decode steps fed the one-process run's tokens (the first
    under ``memprobe.measure_peak`` and counted as the dry-run counts it),
    their walls, logits, collectives, each axis's bus bandwidth; then the
    planted control's steps on a fresh cache (``left_out_block``); to
    ``out/rank<r>.pt``."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import memprobe
    from repro_torch.launch.mesh import make_step_mesh
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.train import pjit_step
    from repro_torch.train import ranks as R

    dev = R.rank_device(backend, "cuda", rank)
    R.init(backend, rank, world, init_method=f"tcp://localhost:{port}",
           device=dev)
    mesh = R.StepMesh(make_step_mesh(spec["data"], spec["model"],
                                     device_type="cuda"), dev).for_batch(1)
    cfg = cell_cfg(spec)
    full = M.init_train(cfg, spec["seed"], dev)
    params = convert.shard_params(full, convert.placements(
        cfg, mesh.mesh, rules=sharding.PARAM_RULES))
    del full
    gc.collect()
    torch.cuda.empty_cache()
    forced = torch.load(ref_path)["inputs"]
    decode = pjit_step.make_decode_step(cfg, mesh=mesh, long_context=True)
    warm_blas(torch, dev)

    def steps(probe: bool):
        with sharding.set_mesh(mesh):
            cache = long_cache(torch, cfg, spec, dev)
        if probe:
            decode(params, mesh.local_rows(forced[0].to(dev)),
                   long_first(spec), cache)
            torch.cuda.synchronize()
        logits, walls, mem, counted = [], [], None, None
        for t in range(spec["steps"]):
            args = (params, mesh.local_rows(forced[t].to(dev)),
                    long_first(spec) + t, cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if t == 0 and probe:
                (res, counted), mem = memprobe.measure_peak(
                    lambda *a: D.count_step(decode, a, "cuda", group=world),
                    args, dev)
            else:
                res = decode(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            lg, cache = res
            logits.append(mesh.full_logits(lg, cfg.vocab_size).cpu())
            del res, lg
        del cache
        gc.collect()
        torch.cuda.empty_cache()
        return logits, walls, mem, counted

    base = mesh.counts()
    ops.reset_launch_counts()
    logits, walls, mem, counted = steps(True)
    launches = ops.launch_counts()
    counts = {a: {k: n - base[a][k] for k, n in c.items()}
              for a, c in mesh.counts().items()}
    has_cache = "k" in M.cache_layout(cfg, 1, 1)
    with left_out_block(has_cache, 0 if has_cache else long_first(spec)
                        // (spec["seq_len"] // spec["data"])):
        planted = steps(False)[0]
    bw = {a: fsdp_bandwidth(torch, ax, 64 << 20 if ax.staged else 1 << 30)
          for a, ax in mesh.axes.items()}
    torch.save(dict(logits=logits, walls=walls, peak=mem, counted=counted,
                    launches=launches, counts=counts, planted=planted,
                    bandwidth=bw, coords=mesh.coords),
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def long_run(torch, label: str, spec: dict, backend: str,
             strict: bool = True) -> dict:
    """One long-decode cell (see LONG_DECODE's note): the dry-run's meta
    trace of rank 0's first step, the one-process run, the ranks
    (``long_rank``), the gates (``strict``: failed at once; else listed
    in the report's ``fails``)."""
    import shutil
    import tempfile

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import train as launch
    from repro_torch.sharding import MeshShape

    t_run = time.perf_counter()
    cfg = cell_cfg(spec)
    world = spec["data"] * spec["model"]
    shape = ShapeConfig("long", spec["seq_len"], 1, "decode")
    pm = MeshShape(("data", "model"), (spec["data"], spec["model"]))
    metas = [D.lower_compile(cfg, shape, mesh=pm, pos=long_first(spec),
                             rank=r) for r in range(world)]
    meta = metas[0]
    one = long_one(torch, spec)
    out_dir = Path(tempfile.mkdtemp(prefix="long_", dir=ROOT / "build"))
    try:
        torch.save({"inputs": one["inputs"]}, out_dir / "ref.pt")
        launch.start_ranks(long_rank, (world, launch.free_port(),
                                       str(out_dir), spec, backend,
                                       str(out_dir / "ref.pt")), world)
        results = [torch.load(out_dir / f"rank{r}.pt")
                   for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    r0 = results[0]
    ref = (one["logits"][0], one["logits"][1:], None)
    measure = serve_measure((r0["logits"][0], r0["logits"][1:], None), ref)
    planted = serve_measure((r0["planted"][0], r0["planted"][1:], None),
                            ref)
    card = r0["counted"]
    equal = {k: card[k] == meta[k] for k in ("flops", "bytes",
                                             "collective_by_axis")}
    peaks = [r["peak"]["peak_bytes"] for r in results]
    meta_peaks = [m["peak_bytes"] for m in metas]
    peak_rel = [p / m - 1 for p, m in zip(peaks, meta_peaks)]
    report = dict(label=label, backend=backend, world=world,
                  walls_ms=[[w * 1e3 for w in r["walls"]] for r in results],
                  one_process_walls_ms=[w * 1e3 for w in one["walls"]],
                  peaks=peaks, meta_peaks=meta_peaks,
                  peak_rel=peak_rel, counted_equal=equal,
                  meta_collective_by_axis=meta["collective_by_axis"],
                  counts=[r["counts"] for r in results],
                  bandwidth=[r["bandwidth"] for r in results],
                  launches=r0["launches"], planted=planted, **measure)
    fails = []

    def holds(cond: bool, msg: str) -> None:
        if not cond:
            fails.append(msg)

    for r in results:
        holds(all(torch.equal(a, b) for a, b in zip(r["logits"],
                                                    r0["logits"])),
              f"long {label}: rank {r['coords']}'s logits are not rank 0's")
    holds(measure["logits_err_over_tol"] <= 1.0 and
          measure["tokens_held"] == measure["tokens"],
          f"long {label}: logits {measure['logits_err_over_tol']:.3f} of the "
          f"limit, tokens held {measure['tokens_held']} of "
          f"{measure['tokens']}")
    holds(not planted["logits_err_over_tol"] <= 1.0,
          f"long {label}: the planted control (a combine that leaves out a "
          f"rank's block) passes the logits gate "
          f"({planted['logits_err_over_tol']:.3f} of the limit)")
    holds(all(equal.values()), f"long {label}: rank 0's first step counted "
          f"on the card differs from the dry-run's meta trace ({equal}: "
          f"flops {card['flops']} / {meta['flops']}, bytes {card['bytes']} "
          f"/ {meta['bytes']})")
    holds(all(abs(x) <= FSDP_PEAK_REL for x in peak_rel),
          f"long {label}: a rank's peak lies {peak_rel} off the dry-run's "
          f"trace of that rank, {meta_peaks} bytes (limit {FSDP_PEAK_REL})")
    report["run_s"] = time.perf_counter() - t_run
    coll = {a: sum(c[a]["bytes"] for c in report["counts"]) / world
            for a in report["counts"][0]}
    bus = {a: round(b[a]["bus_GBps"], 2) for b in report["bandwidth"][:1]
           for a in b}
    print(f"long {label} ({backend}, {world} ranks, {spec['seq_len']} "
          f"positions, steps from {long_first(spec)}): logits "
          f"{measure['logits_err_over_tol']:.4f} of the limit, tokens held "
          f"{measure['tokens_held']}/{measure['tokens']}, ranks bitwise; "
          f"plant {planted['logits_err_over_tol']:.2f} of the limit; step "
          f"ms a rank {[[round(w, 2) for w in ws] for ws in report['walls_ms']]}"
          f" (one process {[round(w, 2) for w in report['one_process_walls_ms']]}"
          f"); peaks {[round(p / 2**30, 4) for p in peaks]} GiB vs the "
          f"dry-run's {[round(p / 2**30, 4) for p in meta_peaks]} "
          f"({[f'{x:+.3%}' for x in peak_rel]}); FLOPs, bytes, collectives "
          f"equal to meta's {equal}; collective result bytes a rank by axis "
          f"{coll} (meta wire bytes {meta['collective_by_axis']}); bus {bus} "
          f"GB/s; {report['run_s']:.1f} s", flush=True)
    report["fails"] = fails
    for msg in fails if strict else ():
        check(False, msg)
    return report


def phase_long_decode(torch, spec=LONG_DECODE):
    """The long decode (see LONG_DECODE's note) as two gloo ranks sharing
    the card.  Returns ({"serving_long": its kernels' launches}, the
    report)."""
    from repro_torch.launch import train as launch

    t_phase = time.perf_counter()
    try:
        report = long_run(torch, f"{spec['arch']}, data {spec['data']}, two "
                          f"gloo ranks on one card", spec, "gloo")
    finally:
        launch.stop_rank_server()
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"phase_long_decode: {report['phase_s']:.1f} s")
    return {"serving_long": report["launches"]}, report


def long_cards(torch, cells=None) -> dict:
    """LONG_CARDS (``cells`` by label, all by default) with one NCCL rank
    a card."""
    from repro_torch.launch import train as launch

    out = {}
    try:
        for label, spec in LONG_CARDS:
            if cells is None or label in cells:
                out[label] = long_run(torch, label, spec, "nccl",
                                      strict=False)
    finally:
        launch.stop_rank_server()
    return out


def train_run_diffs(torch, init, final, hist, ref_final, ref_hist,
                    cfg=None) -> dict:
    """How far a training run lies from a reference run from the same
    initial leaves (CPU tensors): the first loss's relative difference,
    the largest difference of a later loss's drop from the first over
    the reference's drop, and per leaf ||final - ref|| / ||ref - init||
    (f32 on the card) over the leaves the reference moves; with ``cfg``
    the path of the leaf where it is largest."""
    losses = train_run_diffs_from(hist, ref_hist)
    rel, moving, still = [], [], True
    for i, (p0, a, b) in enumerate(zip(init, final, ref_final)):
        p0, a, b = (t.to("cuda").float() for t in (p0, a, b))
        moved = float((b - p0).norm())
        if moved == 0.0:
            still = still and bool((a == p0).all())
        else:
            rel.append(float((a - b).norm()) / moved)
            moving.append(i)
        del p0, a, b
    worst = None
    if cfg is not None:
        from repro_torch.core import tree
        from repro_torch.models import model as M

        paths = [p for p, _ in tree.leaves_with_paths(M.abstract_params(cfg))]
        worst = paths[moving[rel.index(max(rel))]]
    return dict(losses, update_rel=rel, update_rel_max=max(rel),
                update_rel_min=min(rel), moving_leaves=len(rel),
                still_equal=still, worst_leaf=worst)


def train_diff_text(d: dict, update_limit: float | None = TRAIN_UPDATE_REL
                    ) -> str:
    limit = "not held: the f32 run's gate" if update_limit is None \
        else f"limit {update_limit}"
    return (f"first loss rel diff {d['loss0_rel']:.3e} (limit "
            f"{TRAIN_LOSS0_REL}), loss drops rel diff {d['drop_rel']:.3e} "
            f"(limit {TRAIN_DROP_REL}), leaf updates rel diff "
            f"{d['update_rel_min']:.4f}..{d['update_rel_max']:.4f} over "
            f"{d['moving_leaves']} moving leaves ({limit}; "
            f"the largest at {d['worst_leaf']}), unmoved leaves equal "
            f"{d['still_equal']}")


def train_small_vs_cpu(torch, arch: str, steps: int = 5) -> dict:
    """The reduced ``arch`` in f32 trained on the card against the CPU
    (randomized, q 0.5, sign_flip on [2, 5], momentum, ``steps`` steps):
    control exact, losses within 1e-4 relative, parameters within 1e-4
    (1 + max|p|)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.core.randomized import BFTConfig
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig
    from repro_torch.train import (AttackConfig, StepConfig, Trainer,
                                   TrainerConfig)
    import numpy as np

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    init = M.init_train(cfg, 0, device="cpu")
    mask = np.isin(np.arange(8), [2, 5])
    runs = {}
    for dev in ("cpu", "cuda"):
        t = Trainer(cfg, OptConfig(kind="momentum", peak_lr=0.05,
                                   warmup_steps=2, total_steps=40),
                    BFTConfig(n=8, f=2, mode="randomized", q=0.5,
                              p_assumed=0.6, seed=17),
                    TrainerConfig(seq_len=16, global_batch=16, log_every=0),
                    attack=AttackConfig("sign_flip", 0.6, 5.0),
                    sc=StepConfig(), true_byzantine=mask, device=dev,
                    params=M.map_params(lambda x: x.to(dev).clone(), init))
        t.run(steps)
        runs[dev] = t
    c, g = runs["cpu"], runs["cuda"]
    ctl = [{k: v for k, v in r.items() if k != "loss"} for r in g.history] \
        == [{k: v for k, v in r.items() if k != "loss"} for r in c.history]
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(g.history, c.history))
    p_err = max(float((a.cpu() - b).abs().max()) / (1 + float(b.abs().max()))
                for a, b in zip(tree.leaves(g.params), tree.leaves(c.params)))
    ident = sorted(np.flatnonzero(g.state.identified).tolist())
    print(f"small {cfg.name} f32 training card vs CPU: control equal {ctl} "
          f"(identified {ident}); losses max rel diff {loss_err:.3e} "
          f"(tolerance 1e-4); params max|d|/(1+max|p|) {p_err:.3e} "
          f"(tolerance 1e-4)")
    check(ctl and loss_err <= 1e-4 and p_err <= 1e-4,
          "small training run: card vs CPU differ")
    return dict(control_equal=ctl, loss_rel_err=loss_err,
                param_rel_err=p_err, identified=ident)


# the launch tools (launch.dryrun, roofline, memprobe) held against
# llama3.2-1b's plain steps at full width, bf16, random init: the
# training cell's tokens (global batch 16 x 256, AdamW), SERVE's prefill
# (4 x 4096) and one decode step against SERVE's whole cache (4 x
# (4096 + 32), the token at the last position)
DRYRUN = dict(arch="llama3.2-1b", train=(16, 256), prefill=(4, 4096),
              decode=(4, 4096 + 32), reps=3)
# the measured peak against the dry-run's prediction: a gap outside this
# band is a fault of the counter
DRYRUN_PEAK_REL = 0.10


def dryrun_inputs(torch, cfg, kind: str, B: int, S: int, params, dev):
    """The step's inputs on the card: ``params``, AdamW's zero state,
    seeded tokens and labels (int32, as ``launch.specs``), a zero cache
    with the token at its last position."""
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, init_opt_state

    g = torch.Generator(device=dev).manual_seed(7)

    def toks(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=g,
                             device=dev, dtype=torch.int32)

    if kind == "train":
        return (params, init_opt_state(OptConfig(), params),
                {"tokens": toks(B, S), "labels": toks(B, S)}, 0)
    if kind == "prefill":
        return (params, {"tokens": toks(B, S)})
    return (params, toks(B), S - 1, M.allocate_cache(cfg, B, S, dev))


def phase_dryrun(torch, training: dict | None):
    """(a) llama3.2-1b's plain train, prefill and decode steps
    (``train.pjit_step``) at full width: each traced by the dry-run on
    meta tensors (``launch.dryrun.lower_compile``), then run on the card
    under the same ``StepCounter``: FLOPs, bytes accessed and the
    arguments' bytes equal exactly, K6's launches equal to the counter's
    calls, the peak (``max_memory_allocated`` after a reset, the inputs
    resident and nothing else counted) within ``DRYRUN_PEAK_REL`` of the
    predicted ``peak_bytes``; the warm wall (median of 3, CUDA events,
    outside the counter) beside compute_s, memory_s, the roofline
    fraction and the MFU (model FLOPs / (wall x 989e12)).  (b)
    ``run_bft_cells`` at the training cell's 16 x 256: each step kind's
    bound beside ``phase_train``'s measured wall.  (c) ``memprobe`` at
    one layer: predicted and measured peaks in bf16 and f32."""
    import gc

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import memprobe
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig

    RL = roofline()
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"dry-run: the card's memory {total} bytes "
          f"(roofline.HBM_PER_CARD {RL.HBM_PER_CARD})")
    cfg = get_config(DRYRUN["arch"])
    params = M.init_train(cfg, 0, dev)
    out = {"total_memory": total, "steps": {}}
    for kind in ("train", "prefill", "decode"):
        B, S = DRYRUN[kind]
        shape = ShapeConfig(kind, S, B, kind)
        t0 = time.perf_counter()
        pred = D.lower_compile(cfg, shape)
        trace_s = time.perf_counter() - t0
        step = D.step_for(cfg, kind, OptConfig())
        args = dryrun_inputs(torch, cfg, kind, B, S, params, dev)
        ops.reset_launch_counts()
        res, mem = memprobe.measure_peak(
            lambda *a: D.count_step(step, a, "cuda"), args, dev)
        launched = ops.launch_counts()
        got = res[1]
        del res
        wall_ms = median_ms(torch, lambda: step(*args), reps=DRYRUN["reps"],
                            warm=1)
        rl = D.roofline_of(cfg, shape, pred)
        mfu = rl.model_flops_total / (wall_ms / 1e3 * RL.BF16_OPS_S)
        peak_rel = mem["peak_bytes"] / pred["peak_bytes"] - 1
        row = dict(
            global_batch=B, seq_len=S, trace_s=trace_s,
            predicted=pred, card=got, measured_peak_bytes=mem["peak_bytes"],
            other_resident_bytes=mem["other_resident_bytes"],
            peak_rel=peak_rel, launches=launched, wall_ms=wall_ms,
            roofline=rl.as_dict(), bound_ms=rl.bound_s * 1e3,
            bound_share=rl.bound_s * 1e3 / wall_ms, mfu=mfu)
        out["steps"][kind] = row
        print(f"dry-run {kind} ({B} x {S}): trace {trace_s:.2f} s; FLOPs "
              f"meta {pred['flops']:.6g} card {got['flops']:.6g} (by dtype "
              f"{pred['flops_by_dtype']}); bytes meta {pred['bytes']:.6g} "
              f"card {got['bytes']:.6g}; arg_bytes meta {pred['arg_bytes']}"
              f" card {got['arg_bytes']}; peak predicted "
              f"{pred['peak_bytes'] / 2**30:.4f} GiB, measured "
              f"{mem['peak_bytes'] / 2**30:.4f} GiB ({peak_rel:+.2%}; other "
              f"resident {mem['other_resident_bytes'] / 2**20:.1f} MiB; the "
              f"counter on the card {got['peak_bytes'] / 2**30:.4f} GiB); "
              f"kernels meta {pred['kernels']} card {got['kernels']}, "
              f"launched {launched}")
        print(f"  {kind}: warm wall {wall_ms:.3f} ms (median of "
              f"{DRYRUN['reps']}); compute_s {rl.compute_s * 1e3:.3f} ms, "
              f"memory_s {rl.memory_s * 1e3:.3f} ms ({rl.dominant}); bound "
              f"{rl.bound_s * 1e3:.3f} ms = {row['bound_share']:.2%} of the "
              f"wall; roofline fraction (compute / bound) "
              f"{rl.roofline_fraction:.3f}; model FLOPs "
              f"{rl.model_flops_total:.6g}, MFU {mfu:.2%}")
        for key in ("flops", "bytes", "arg_bytes"):
            check(got[key] == pred[key], f"dry-run {kind}: {key} on the card "
                  f"{got[key]} != meta {pred[key]}")
        check(got["flops_by_dtype"] == pred["flops_by_dtype"],
              f"dry-run {kind}: FLOPs by dtype differ")
        k6 = got["kernels"].get("flash_attention", {}).get("calls", 0)
        check(launched["flash_attention"] == k6 == pred["kernels"].get(
            "flash_attention", {}).get("calls", 0),
              f"dry-run {kind}: K6 launched {launched['flash_attention']}, "
              f"counted {k6}")
        check(abs(peak_rel) <= DRYRUN_PEAK_REL,
              f"dry-run {kind}: measured peak {mem['peak_bytes']} is "
              f"{peak_rel:+.2%} off the predicted {pred['peak_bytes']}")
        del args
        gc.collect()
    del params
    gc.collect()
    torch.cuda.empty_cache()

    B, S = DRYRUN["train"]
    t0 = time.perf_counter()
    bft = D.run_bft_cells(cfg.name, n=8, f=2, global_batch=B, seq_len=S)
    out["bft"] = bft
    walls = (training or {}).get("modes", {})
    for mode in ("fast", "check", "check_full", "identify"):
        m = bft[mode]
        w = walls.get(mode, {}).get("wall_s")
        print(f"dry-run BFT {mode} (r {m['replication']}, {m['num_shards']} "
              f"shards, 16 x 256): bound {m['bound_s'] * 1e3:.3f} ms "
              f"({m['roofline']['dominant']}; compute "
              f"{m['roofline']['compute_s'] * 1e3:.3f}, memory "
              f"{m['roofline']['memory_s'] * 1e3:.3f}), predicted peak "
              f"{m['peak_bytes'] / 2**30:.3f} GiB; phase_train's wall "
              + ("not measured" if w is None else
                 f"{w * 1e3:.3f} ms ({m['bound_s'] / w:.2%} of it)"))
    out["bft_s"] = time.perf_counter() - t0

    probes = {dt: memprobe.probe(cfg.name, dt, global_batch=B, seq_len=S)
              for dt in ("bfloat16", "float32")}
    out["memprobe"] = probes
    for dt, r in probes.items():
        print(f"memprobe {dt} (one layer, {B} x {S}): predicted "
              f"{r['predicted_peak_bytes'] / 2**30:.4f} GiB, measured "
              f"{r['measured_peak_bytes'] / 2**30:.4f} GiB ("
              f"{r['measured_peak_bytes'] / r['predicted_peak_bytes'] - 1:+.2%}"
              f"), inputs {r['arg_bytes'] / 2**30:.4f} GiB")
        check(r["measured_peak_bytes"] > 0, f"memprobe {dt}: no peak")
    pb, pf = (probes[d]["predicted_peak_bytes"] for d in ("bfloat16",
                                                          "float32"))
    mb, mf = (probes[d]["measured_peak_bytes"] for d in ("bfloat16",
                                                         "float32"))
    out["memprobe_ratio"] = {"predicted": pb / pf, "measured": mb / mf}
    print(f"memprobe bf16/f32 peak ratio: predicted {pb / pf:.4f}, "
          f"measured {mb / mf:.4f}")
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase_dryrun: {out['phase_s']:.1f} s")
    return out


def child_processes() -> list[tuple[int, str]]:
    """(pid, command line) of every live process whose parent is this
    one, read from /proc."""
    found = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            cmd = (entry / "cmdline").read_bytes()
        except OSError:  # it ended while we read
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == os.getpid():
            found.append((int(entry.name),
                          cmd.replace(b"\0", b" ").decode(errors="replace")))
    return found


def stop_children() -> None:
    """End and reap every process this one started that is still alive
    (the phases stop their own; this names and stops what one missed),
    so that the script leaves no process behind, on failure too: the
    fork server of the ranks and its resource tracker through their own
    stop, which reaps them, and anything else by a signal."""
    import signal
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    left = child_processes()
    for pid, cmd in left:
        print(f"chip_smoke: stopping left-over process {pid}: {cmd[:200]}",
              file=sys.stderr)
        os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + 10
    for pid, _ in left:
        try:
            while os.waitpid(pid, os.WNOHANG) == (0, 0):
                if time.monotonic() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                    break
                time.sleep(0.05)
        except ChildProcessError:  # reaped by its owner meanwhile
            pass


def main() -> int:
    try:
        return run()
    finally:
        stop_children()


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    t0 = time.perf_counter()
    card_line, name, build_s = phase_card(torch)
    kernels = phase_kernels(torch)
    kernels.update(phase_stream_kernels(torch))
    k6_report, attention = phase_attention_kernel(torch)
    kernels.update(k6_report)
    launches = {}
    launches["gram_sweep"], gram = phase_gram(torch)
    stream_launches, stream = phase_stream(torch)
    launches.update(stream_launches)
    device_launches, device_ctl = phase_device_control(torch)
    launches.update(device_launches)
    oracle_launches, oracle = phase_oracle(
        torch, device_ctl["adaptive_sweep"]["wall_s"])
    launches.update(oracle_launches)
    launches["engine_split"], engine_split = phase_engine_split(torch)
    launches["single_vector_ops"] = phase_single_path(torch)
    small = phase_small_vs_cpu(torch)
    launches["serving"], _, serving = phase_serving(torch, attention, SERVE)
    launches["training"], train_report, training = phase_train(
        torch, TRAIN, "train")
    launches["training_ranks"], training_ranks = phase_train_ranks(
        torch, TRAIN, training)
    tp_launches, tp_report, training_tp = phase_train_tp(torch, TRAIN)
    launches.update(tp_launches)
    fsdp_launches, fsdp_row, training_fsdp = phase_train_fsdp(torch)
    launches.update(fsdp_launches)
    long_launches, serving_long = phase_long_decode(torch)
    launches.update(long_launches)
    dryrun = phase_dryrun(torch, training)
    launches["serving_mamba"], mserve_report, serving_mamba = \
        phase_serving_replayed(torch, attention, MAMBA_SERVE)
    launches["training_mamba"], mtrain_report, training_mamba = phase_train(
        torch, MAMBA_TRAIN, "mamba_train")
    launches["serving_moe"], moe_serve_report, serving_moe = phase_serving(
        torch, attention, MOE_SERVE)
    launches["training_moe"], moe_train_report, training_moe = phase_train(
        torch, MOE_TRAIN, "moe_train")
    launches["serving_hybrid"], hybrid_report, serving_hybrid = \
        phase_serving_replayed(torch, attention, HYBRID_SERVE)
    launches["serving_whisper"], whisper_rows, serving_whisper = \
        phase_serving_ctx(torch, WHISPER_SERVE)
    launches["serving_vision"], vision_rows, serving_vision = \
        phase_serving_ctx(torch, VISION_SERVE)
    # rows whose launches their phase counted by shape
    by_shape = {"serving_whisper": whisper_rows,
                "serving_vision": vision_rows}
    # each kernel's launches summed over the counted path runs but those
    # with rows of their own, which count them there
    own = {"training": ("_train", train_report),
           "serving_mamba": ("_mamba_audit", mserve_report),
           "training_mamba": ("_mamba_train", mtrain_report),
           "serving_moe": ("_moe_serving", moe_serve_report),
           "training_moe": ("_moe_train", moe_train_report),
           "serving_hybrid": ("_jamba_serving", hybrid_report)}
    # the split paths' rows: the shard form's launches are summed with
    # the other paths' below (only the split paths launch it), and its
    # mamba row counts the mamba split's; K6 at a rank's heads counts the
    # llama split's K6 launches (also in K6's row)
    kernels.update(tp_report)
    kernels.update(fsdp_row)
    for key, kv in kernels.items():
        kv["launches"] = sum(run.get(key, 0) for path, run in launches.items()
                             if path not in own and path not in by_shape)
    kernels["flash_attention_tp"]["launches"] = \
        launches["training_tp"]["flash_attention"]
    kernels["flash_attention_fsdp"]["launches"] = \
        launches["training_fsdp"]["flash_attention"]
    for key in ("sketch_shard", "sketch_shard_f32"):
        kernels[key + "_mamba"]["launches"] = \
            launches["training_tp_mamba"][key]
    # jamba's rows (its split runs only in (b), on four cards) are checked
    # and timed and count no launch
    for key in ("sketch_shard_jamba", "sketch_shard_f32_jamba"):
        kernels[key]["launches"] = 0
    # no path of this script splits a head: the ragged shape is checked
    # and timed, and its row counts no launch
    kernels["flash_attention_ragged"]["launches"] = 0
    for path, (suffix, report) in own.items():
        for key, kv in report.items():
            kv["launches"] = launches[path][key.removesuffix(suffix)]
        kernels.update(report)
    for rows in by_shape.values():
        kernels.update(rows)
    main_path = dict(gram_sweep=gram, **stream, device_control=device_ctl,
                     oracle=oracle, engine_split=engine_split,
                     launches=launches,
                     small_vs_cpu_w_err=small, serving=serving,
                     attention=attention, training=training,
                     training_ranks=training_ranks, training_tp=training_tp,
                     training_fsdp=training_fsdp,
                     serving_long=serving_long,
                     serving_mamba=serving_mamba,
                     training_mamba=training_mamba, serving_moe=serving_moe,
                     training_moe=training_moe,
                     serving_hybrid=serving_hybrid,
                     serving_whisper=serving_whisper,
                     serving_vision=serving_vision, dryrun=dryrun)
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    line = {"kernels": [{k: kv[k] for k in order} for kv in kernels.values()]}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=card_line, device=name, build_s=build_s, main_path=main_path,
        total_s=time.perf_counter() - t0, **line), indent=1))
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
