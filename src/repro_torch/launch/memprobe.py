"""Peak memory of a one-layer train step in bf16 and in f32 on the card,
beside the dry-run's prediction.

Port of ``repro.launch.memprobe``.  The reference compiled the step for
XLA's CPU backend, which emulates bf16 through f32, to calibrate its
memory-fit marks.  On the H100 bf16 is native, so the question is
measured: the same step (``train.pjit_step.make_train_step``, AdamW)
runs in each dtype at a shape one card holds, and for each this prints
the dry-run's predicted peak (``launch.dryrun.lower_compile`` on
``meta`` tensors), the measured ``torch.cuda.max_memory_allocated()``
of the step above what was resident besides its inputs, and the
bf16/f32 ratio of both.

    PYTHONPATH=src python -m repro_torch.launch.memprobe --arch llama3.2-1b
"""
from __future__ import annotations

import argparse
import dataclasses
import gc

import torch

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.core import tree
from repro_torch.launch.dryrun import lower_compile, step_for
from repro_torch.launch.specs import batch_specs
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, init_opt_state


def one_layer(cfg, dtype: str):
    return dataclasses.replace(cfg, num_layers=1, encoder_layers=0,
                               dtype=dtype)


def measure_peak(run, args, device):
    """``run(*args)`` once on the card: (its result, {"peak_bytes": the
    peak of allocated bytes, the inputs (``args``) included and nothing
    else resident counted, "other_resident_bytes": what else was})."""
    gc.collect()
    torch.cuda.synchronize(device)
    inputs = {id(t.untyped_storage()): t.untyped_storage().nbytes()
              for t in tree.leaves(list(args))
              if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    other = torch.cuda.memory_allocated(device) - sum(inputs.values())
    torch.cuda.reset_peak_memory_stats(device)
    out = run(*args)
    torch.cuda.synchronize(device)
    return out, {"peak_bytes": torch.cuda.max_memory_allocated(device)
                 - other, "other_resident_bytes": other}


def probe(arch: str, dtype: str, *, global_batch: int = 16,
          seq_len: int = 256) -> dict:
    """Predicted and measured peak of the one-layer train step, on the
    card (random init, seeded tokens, labels and context)."""
    dev = M.resolve_device(None)
    cfg = one_layer(get_config(arch), dtype)
    shape = ShapeConfig("memprobe", seq_len, global_batch, "train")
    opt = OptConfig()
    pred = lower_compile(cfg, shape, opt)
    params = M.init_train(cfg, 0, dev)
    state = init_opt_state(opt, params)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {n: torch.randint(0, cfg.vocab_size, t.shape, generator=g,
                              device=dev, dtype=t.dtype)
             if t.dtype == torch.int32 else
             torch.randn(t.shape, generator=g, device=dev).to(t.dtype)
             for n, t in batch_specs(cfg, global_batch=global_batch,
                                     seq_len=seq_len).items()}
    out, got = measure_peak(step_for(cfg, "train", opt),
                            (params, state, batch, 0), dev)
    del out, params, state, batch
    return {"arch": arch, "dtype": dtype, "global_batch": global_batch,
            "seq_len": seq_len, "predicted_peak_bytes": pred["peak_bytes"],
            "arg_bytes": pred["arg_bytes"],
            "measured_peak_bytes": got["peak_bytes"],
            "other_resident_bytes": got["other_resident_bytes"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    args = ap.parse_args(argv)
    rows = {}
    for dt in ("bfloat16", "float32"):
        r = rows[dt] = probe(args.arch, dt, global_batch=args.global_batch,
                             seq_len=args.seq_len)
        print(f"{dt:9s} predicted={r['predicted_peak_bytes'] / 2**30:.3f}GiB"
              f" measured={r['measured_peak_bytes'] / 2**30:.3f}GiB "
              f"(inputs {r['arg_bytes'] / 2**30:.3f}GiB)")
    pb, pf = (rows[d]["predicted_peak_bytes"] for d in ("bfloat16",
                                                        "float32"))
    mb, mf = (rows[d]["measured_peak_bytes"] for d in ("bfloat16",
                                                       "float32"))
    print(f"bf16/f32 peak ratio: predicted {pb / pf:.3f}, measured "
          f"{mb / mf:.3f}")


if __name__ == "__main__":
    main()
