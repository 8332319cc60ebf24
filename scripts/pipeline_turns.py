#!/usr/bin/env python3
"""Time the chunk pipeline's drain, and the engine paths' walls against
another checkout's, in turns on one card.

    python3 scripts/pipeline_turns.py [--rounds 5] [--other DIR]

1. **Drains.**  fused_sweep (``chip_smoke.FUSED_SWEEP``: B = 256, T = 3,
   d = 2^20, chunks of 64) runs once through ``repro_torch.run_batch``;
   its W_T goes back to the card as four (64, 2^20) f32 chunks.  Each
   drain variant then writes them into a fresh (256, 2^20) f64 ``W``, as
   the pipeline's drain does after a chunk's scan, timed per chunk with
   the host's clock from the start of the copy to the last f64 row
   written:

   - ``parent``: ``np.asarray(Wc.cpu(), np.float64)`` into ``W[sl]``
     (pageable copy, f64 temporary, assignment: PR 16's drain);
   - ``device_f64``: widened on the card, then one copy straight into
     ``torch.from_numpy(W[sl])``;
   - ``pinned_copyto``: one copy of f32 into a reused pinned buffer,
     waited on by its event, then ``np.copyto`` widening;
   - ``pinned_torch``: the same, widened by PyTorch's CPU copy (split
     over its threads);
   - ``tree``: what ``engineplan.pipeline`` ships (pinned buffer, its
     ``widen_into``).

   Variants take turns, the order reversed every round.  Every
   variant's ``W`` must be bitwise the parent's.
2. **Walls** (with ``--other DIR``, the root of another checkout, for
   example the parent commit unpacked with ``git archive`` into a
   git-ignored directory): gram_sweep, fused_sweep fused / unfused /
   bf16 rows and the per-trial-problem run, each a warm-up and three
   timed ``run_batch`` calls (median wall and phases), in a fresh
   process per tree, in turns: other, this, this, other, per round.

Prints the card's name and power limit, one line per measurement and
a summary; the result goes to ``chiprun_out/pipeline_turns.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


# -- 1. drains ----------------------------------------------------------------


def drains(rounds: int) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from chip_smoke import FUSED_CHUNK, FUSED_SWEEP, fused_sweep_specs
    from repro_torch.core.engineplan import pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    specs = fused_sweep_specs(repro_torch.TrialSpec, **FUSED_SWEEP)
    res = repro_torch.run_batch(specs, fused=True)
    B, d = FUSED_SWEEP["B"], FUSED_SWEEP["d"]
    bounds = [(lo, min(lo + FUSED_CHUNK, B)) for lo in range(0, B, FUSED_CHUNK)]
    chunks = [torch.from_numpy(np.stack([res[b].w for b in range(lo, hi)])
                               .astype(np.float32)).cuda()
              for lo, hi in bounds]
    del res
    pinned = torch.empty((FUSED_CHUNK, d), dtype=torch.float32,
                         pin_memory=True)
    torch.cuda.synchronize()

    def to_pinned(Wc):
        host = pinned[:Wc.shape[0]]
        host.copy_(Wc, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        return host

    variants = {
        "parent": lambda dst, Wc: dst.__setitem__(
            slice(None), np.asarray(Wc.cpu(), np.float64)),
        "device_f64": lambda dst, Wc: torch.from_numpy(dst).copy_(
            Wc.to(torch.float64)),
        "pinned_copyto": lambda dst, Wc: np.copyto(
            dst, to_pinned(Wc).numpy()),
        "pinned_torch": lambda dst, Wc: torch.from_numpy(dst).copy_(
            to_pinned(Wc)),
        "tree": lambda dst, Wc: pipeline.widen_into(dst, to_pinned(Wc)),
    }
    names = list(variants)
    times = {n: [] for n in names}            # per turn: per-chunk seconds
    ref = None
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            W = np.empty((B, d), np.float64)
            per_chunk = []
            for (lo, hi), Wc in zip(bounds, chunks):
                t0 = time.perf_counter()
                variants[name](W[lo:hi], Wc)
                per_chunk.append(time.perf_counter() - t0)
            times[name].append(per_chunk)
            if ref is None:
                ref = W
            elif not (W.view(np.uint64) == ref.view(np.uint64)).all():
                raise SystemExit(f"pipeline_turns: FAILED: the {name} drain "
                                 f"wrote another W than the parent's")
            del W
            print(f"round {r} {name}: post_scan per chunk (s) "
                  + ", ".join(f"{t:.4f}" for t in per_chunk)
                  + f"; sum {sum(per_chunk):.4f}", flush=True)
    summary = {}
    for name in names:
        sums = [sum(t) for t in times[name]]
        summary[name] = dict(
            sum_median_s=statistics.median(sums), sum_min_s=min(sums),
            sum_max_s=max(sums),
            per_chunk_median_s=[statistics.median(t[i] for t in times[name])
                                for i in range(len(bounds))])
        print(f"drain {name}: fused_sweep post_scan of the drains, median "
              f"{summary[name]['sum_median_s']:.4f} s (range "
              f"{min(sums):.4f}-{max(sums):.4f}) over {rounds} turns; per "
              f"chunk " + ", ".join(f"{t:.4f}" for t in
                                    summary[name]["per_chunk_median_s"]))
    print(f"every drain's W bitwise the parent's; torch threads "
          f"{torch.get_num_threads()}")
    return dict(turns=times, summary=summary,
                torch_threads=torch.get_num_threads())


# -- 2. walls -----------------------------------------------------------------


def walls_child() -> None:
    """Runs in a fresh process whose ``sys.path`` starts with a tree's
    ``src``: each engine path's median warm wall and phases, as JSON."""
    import repro_torch
    from chip_smoke import (FUSED_SWEEP, GRAM_SWEEP, PER_PROBLEM,
                            fused_sweep_specs, gram_sweep_specs)

    TS = repro_torch.TrialSpec
    gram = gram_sweep_specs(TS, **GRAM_SWEEP)
    fused = fused_sweep_specs(TS, **FUSED_SWEEP)
    pp = fused_sweep_specs(TS, **PER_PROBLEM)
    paths = {
        "gram_sweep": lambda: repro_torch.run_batch(gram),
        "fused": lambda: repro_torch.run_batch(fused, fused=True),
        "unfused": lambda: repro_torch.run_batch(fused, fused=False),
        "bf16": lambda: repro_torch.run_batch(fused, fused=True,
                                              stream_dtype="bf16"),
        "per_problem": lambda: repro_torch.run_batch(pp),
    }
    out = {"tree": str(Path(repro_torch.__file__).parents[2])}
    for name, run in paths.items():
        run()                                          # warm-up
        runs = []
        for _ in range(3):
            res = run()
            runs.append((res.elapsed_s, res.phase_s))
            del res
        out[name] = dict(
            wall_s=statistics.median(w for w, _ in runs),
            walls_s=[w for w, _ in runs],
            phases_s={k: statistics.median(p[k] for _, p in runs)
                      for k in runs[0][1]})
    print("WALLS " + json.dumps(out), flush=True)


def walls(other: Path, rounds: int) -> dict:
    trees = {"other": other.resolve(), "this": ROOT}
    order = []
    for _ in range(rounds):
        order += ["other", "this", "this", "other"]
    results = {"other": [], "this": []}
    for who in order:
        env = dict(os.environ, PYTHONPATH=str(trees[who] / "src"))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--walls-child"], cwd=trees[who], env=env,
                              capture_output=True, text=True, timeout=1800)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("WALLS ")), None)
        if proc.returncode != 0 or line is None:
            raise SystemExit(f"pipeline_turns: FAILED: {who} walls run "
                             f"(rc {proc.returncode}): {proc.stderr[-2000:]}")
        got = json.loads(line[len("WALLS "):])
        results[who].append(got)
        print(f"{who} ({got['tree']}): " + "; ".join(
            f"{k} wall {v['wall_s']:.4f} s, post_scan "
            f"{v['phases_s']['post_scan']:.4f}, scan "
            f"{v['phases_s']['scan']:.4f}"
            for k, v in got.items() if k != "tree"), flush=True)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--walls-rounds", type=int, default=1)
    ap.add_argument("--walls-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.walls_child:
        walls_child()
        return 0
    import torch

    if not torch.cuda.is_available():
        print("pipeline_turns: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    report = dict(card=card, drains=drains(args.rounds))
    if args.other is not None:
        report["walls"] = walls(args.other, args.walls_rounds)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "pipeline_turns.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
