"""Training launcher of the port.

Instantiates the BFT trainer for a registered dense, MoE, Mamba2 or
hybrid architecture (``--arch llama3.2-1b``, ``--arch
phi3.5-moe-42b-a6.6b``, ``--arch mamba2-780m``, ``--arch
jamba-v0.1-52b``) and runs it with checkpointing, restart and the randomized
reactive-redundancy protocol live; the n workers run one after another
on one device (the card by default).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama3.2-1b --steps 50 --mode randomized --f 2 \\
        --byz 2,5 --ckpt-dir runs/run1
    # restart after an interruption:
    PYTHONPATH=src python -m repro_torch.launch.train ... --restore
    # the plain PyTorch versions on the CPU, a reduced model:
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 20

The flags are the reference's (``repro.launch.train``) without its
mesh; ``--workers`` is the worker count n, ``--device`` the device.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, list_configs
from repro_torch.core.randomized import BFTConfig
from repro_torch.optim import OptConfig
from repro_torch.train import AttackConfig, StepConfig, Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="paper-smalllm", choices=list_configs())
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--mode", default="randomized",
                    choices=["randomized", "deterministic", "draco",
                             "filter", "none"])
    ap.add_argument("--filter", dest="filter_name", default="median")
    ap.add_argument("--f", type=int, default=1)
    ap.add_argument("--q", type=float, default=-1.0,
                    help="fault-check probability; <0 -> adaptive (§4.3)")
    ap.add_argument("--detection", default="sketch", choices=["sketch", "full"])
    ap.add_argument("--selective", action="store_true")
    ap.add_argument("--workers", type=int, default=8,
                    help="BFT workers n (run in turn on the device)")
    ap.add_argument("--byz", default="",
                    help="comma list of Byzantine ranks (simulation)")
    ap.add_argument("--attack", default="sign_flip")
    ap.add_argument("--p-tamper", type=float, default=0.6)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help='"cuda" (the default) or "cpu"')
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    workers = args.workers
    print(f"[launch] {cfg.name}: {workers} workers on "
          f"{args.device or 'cuda'}")

    byz = [int(x) for x in args.byz.split(",") if x]
    trainer = Trainer(
        cfg,
        OptConfig(kind="adamw", peak_lr=args.lr, warmup_steps=20,
                  total_steps=max(100, args.steps)),
        BFTConfig(n=workers, f=args.f, mode=args.mode,
                  q=None if args.q < 0 else args.q,
                  p_assumed=args.p_tamper, selective=args.selective,
                  seed=args.seed),
        TrainerConfig(
            seq_len=args.seq_len,
            global_batch=args.global_batch or 4 * workers,
            seed=args.seed,
            checkpoint_dir=args.ckpt_dir or None,
            checkpoint_every=args.ckpt_every if args.ckpt_dir else 0,
            filter_name=args.filter_name,
            log_every=10,
        ),
        attack=AttackConfig(kind=args.attack if byz else "none",
                            p_tamper=args.p_tamper),
        sc=StepConfig(detection=args.detection),
        true_byzantine=np.isin(np.arange(workers), byz),
        device=args.device,
    )
    if args.restore:
        step = trainer.restore_latest()
        print(f"[launch] restored step {step}")
    trainer.run(max(0, args.steps - trainer.state.step))
    st = trainer.state
    print(
        f"[launch] done: loss={trainer.history[-1]['loss']:.4f} "
        f"eff={st.meter.overall:.3f} κ={st.kappa} "
        f"identified={sorted(np.flatnonzero(st.identified).tolist())}"
    )


if __name__ == "__main__":
    main()
