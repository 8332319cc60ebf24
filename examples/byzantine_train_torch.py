"""End-to-end BFT training on the PyTorch port, its workers as
ranks (the torch version of ``examples/byzantine_train.py``).

n = 8 workers run as W ranks of a ``torch.distributed`` group over the
``data`` axis, n/W workers a rank (``repro_torch.launch.train``: one
NCCL rank a card by default, gloo on the CPU).  Byzantine workers 2 and
5 sign-flip their gradients with probability 0.6 per iteration; the
master checks with adaptive q* (paper §4.3), reactively identifies and
eliminates them, and training proceeds with computation efficiency ~1.

    PYTHONPATH=src python examples/byzantine_train_torch.py --reduced \\
        --device cpu --nproc 2                                  # smoke, CPU
    PYTHONPATH=src python examples/byzantine_train_torch.py --preset 100m \\
        --steps 300                                      # every card's rank
    PYTHONPATH=src python examples/byzantine_train_torch.py ... --restore
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.randomized import BFTConfig  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train import (AttackConfig, StepConfig,  # noqa: E402
                               TrainerConfig)


def build_cfg(preset: str):
    base = get_config("paper-smalllm")
    if preset == "smoke":
        return base.reduced()
    if preset == "100m":
        # ~110M params: 12L x 768d x 12H, 32k vocab (GPT-2-small scale)
        return dataclasses.replace(
            base, name="bft-100m", num_layers=12, d_model=768, num_heads=12,
            num_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=32768,
        )
    raise ValueError(preset)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke preset (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--f", type=int, default=2)
    ap.add_argument("--attack", default="sign_flip")
    ap.add_argument("--detection", default="sketch", choices=["sketch", "full"])
    ap.add_argument("--nproc", type=int, default=0,
                    help="ranks (0: one a visible card that divides the "
                         "workers; 1 on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--restore", action="store_true")
    args = ap.parse_args(argv)

    n = args.workers
    assert n >= 2 * args.f + 1, f"need >= {2*args.f+1} workers, have {n}"
    preset = "smoke" if args.reduced else args.preset
    cfg = build_cfg(preset)
    seq = args.seq_len or (64 if preset == "smoke" else 512)
    nproc = args.nproc or launch.default_nproc(n, args.device)
    backend = "gloo" if args.device == "cpu" else "nccl"
    out = tempfile.mkdtemp(prefix="bft_ranks_")
    ckpt = args.ckpt_dir or os.path.join(out, "ckpt")
    job = launch.Job(
        cfg,
        OptConfig(kind="adamw", peak_lr=3e-4, warmup_steps=20,
                  total_steps=max(args.steps, 100)),
        BFTConfig(n=n, f=args.f, mode="randomized", q=None,  # adaptive §4.3
                  p_assumed=0.6, seed=0),
        TrainerConfig(seq_len=seq, global_batch=4 * n, log_every=5,
                      checkpoint_dir=ckpt, checkpoint_every=10),
        AttackConfig(kind=args.attack, p_tamper=0.6, scale=5.0),
        StepConfig(detection=args.detection),
        np.isin(np.arange(n), [2, 5]),
        actions=(("restart", args.steps),) if args.restore else
        (("run", args.steps),),
        device=args.device, backend=backend, out=out,
        threads=max(1, (os.cpu_count() or 1) // nproc)
        if args.device == "cpu" else 0)
    print(f"[ranks] {cfg.name}: {n} workers as {nproc} {backend} ranks of "
          f"{n // nproc} on {args.device}")
    results = launch.spawn(job, nproc)
    launch.stop_rank_server()
    r0 = results[0]
    run = r0["restarted"] or r0["main"]
    hist, meter = run["history"], run["meter"]
    identified = sorted(np.flatnonzero(run["identified"]).tolist())
    print("\n=== summary ===")
    if r0["resumed"] is not None:
        print(f"resumed from step     : {r0['resumed']}")
    print(f"ranks agree bitwise   : {all(r['agree'] for r in results)}")
    print(f"loss                  : {hist[0]['loss']:.3f} -> "
          f"{hist[-1]['loss']:.3f}")
    print(f"identified Byzantine  : {identified} (truth: [2, 5])")
    print(f"computation efficiency: {run['overall']:.3f}")
    print(f"checks / identifies   : {meter['check_iterations']} / "
          f"{meter['identify_iterations']}")
    assert set(identified) <= {2, 5}, "false positive!"
    assert all(r["agree"] for r in results), "the ranks' parameters differ"


if __name__ == "__main__":
    main()
