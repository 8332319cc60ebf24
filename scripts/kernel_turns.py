#!/usr/bin/env python3
"""Time this checkout's K2 (fused step), K3 and K3s (pairwise relmax)
kernels against the same kernels built from another source directory,
in turns on one card.

    python3 scripts/kernel_turns.py --other DIR [--pairs 5]

DIR holds the other version's ``fused_step.cu`` and ``majority_vote.cu``
with the headers they include, for example a parent commit's
``src/repro_torch/kernels/csrc`` unpacked with ``git archive``.  Both
versions must have this checkout's C interface.  The other version's
relmax output is zero-filled before its launch, as its wrapper did when
the kernel merged every chunk with atomicMax; this checkout's kernel
needs no fill.  Both versions are called through the same Python code
here, so the call times differ by the kernels and their launches alone.

Shapes: K2 at the fused_sweep chunk (64 trials, 66 rows, d = 2^20), f32
and bf16 rows; K3 at the engine's vote (32, 8, 256); K3s at the single
vote (7, 1e5).  Each pair runs the two versions in turns (other, this;
then this, other; ...), each measurement the median of CUDA-event
timings (K2: one call an event pair; K3, K3s: 50 back-to-back calls an
event pair) and the profiler's device time of the kernel by name.  The
result goes to ``chiprun_out/kernel_turns.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build_other(src: Path, out: Path) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)

    def one(name):
        lib = out / f"{name}.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(lib), str(src / f"{name}.cu")], check=True,
                       capture_output=True)
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(2) as ex:
        return dict(ex.map(one, ("fused_step", "majority_vote")))


def typed(libs: dict[str, ctypes.CDLL]) -> dict[str, ctypes.CDLL]:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fs, mv = libs["fused_step"], libs["majority_vote"]
    fs.fused_step_num_spans.argtypes = [i, i, ll, i]
    fs.fused_step_num_spans.restype = i
    for fn in (fs.fused_step_f32, fs.fused_step_bf16):
        fn.argtypes = [vp, i, ll, vp, vp, i, i, ctypes.c_uint32, vp, vp, vp,
                       vp, vp]
        fn.restype = i
    mv.relmax_batched.argtypes = [vp, i, i, ll, vp, vp]
    mv.relmax_batched.restype = i
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(card)
    _build.build_all()
    libs = {"this": typed({n: _build.load(n) for n in ("fused_step",
                                                        "majority_vote")}),
            "other": typed(build_other(args.other.resolve(),
                                       ROOT / "build" / "other_kernels"))}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def k2_call(lib, rows, W, cw):
        fs = lib["fused_step"]
        Ie, d = rows.shape
        B, k = W.shape[0], 256
        nspan = fs.fused_step_num_spans(B, Ie, d, k)
        part_r = torch.empty((nspan, B, Ie), device=dev)
        part_sk = torch.empty((nspan, Ie, k), device=dev)
        resid = torch.empty((B, Ie), device=dev)
        sk = torch.empty((Ie, k), device=dev)
        fn = fs.fused_step_bf16 if rows.dtype == torch.bfloat16 \
            else fs.fused_step_f32
        st = fn(rows.data_ptr(), Ie, d, W.data_ptr(), cw.data_ptr(), B, k,
                0x9E3779B9, part_r.data_ptr(), part_sk.data_ptr(),
                resid.data_ptr(), sk.data_ptr(), stream)
        if st:
            raise RuntimeError(f"fused_step: CUDA error {st}")
        return W, resid, sk

    def k3_call(lib, x, fill):
        B, R, d = x.shape
        out = (torch.zeros if fill else torch.empty)((B, R, R), device=dev)
        st = lib["majority_vote"].relmax_batched(x.data_ptr(), B, R, d,
                                                 out.data_ptr(), stream)
        if st:
            raise RuntimeError(f"relmax_batched: CUDA error {st}")
        return out

    rows = torch.randn(66, 1 << 20, generator=gen, device=dev)
    rows_bf = rows.to(torch.bfloat16)
    W = torch.randn(64, 1 << 20, generator=gen, device=dev)
    cw = torch.randn(64, 66, generator=gen, device=dev) * 0.01
    x3 = torch.randn(32, 8, 256, generator=gen, device=dev)
    x3s = torch.randn(1, 7, 100_000, generator=gen, device=dev)

    # agreement of the two versions before any timing
    for label, x in (("K3", x3), ("K3s", x3s)):
        a, b = k3_call(libs["this"], x, False), k3_call(libs["other"], x, True)
        torch.cuda.synchronize()
        print(f"{label}: this vs other bitwise equal: {torch.equal(a, b)}")
    for label, r in (("K2 f32", rows), ("K2 bf16", rows_bf)):
        a = k2_call(libs["this"], r, W.clone(), cw)
        b = k2_call(libs["other"], r, W.clone(), cw)
        torch.cuda.synchronize()
        print(f"{label}: this vs other max|dW'| {cs.max_err(a[0], b[0]):.3e} "
              f"max|dresid| {cs.max_err(a[1], b[1]):.3e} max|dsk| "
              f"{cs.max_err(a[2], b[2]):.3e}")

    cases = {
        "K2 f32": (lambda v: lambda: k2_call(libs[v], rows, W, cw),
                   "fused_step_kernel", 1),
        "K2 bf16": (lambda v: lambda: k2_call(libs[v], rows_bf, W, cw),
                    "fused_step_kernel", 1),
        "K3": (lambda v: lambda: k3_call(libs[v], x3, v == "other"),
               "relmax_kernel", 50),
        "K3s": (lambda v: lambda: k3_call(libs[v], x3s, v == "other"),
                "relmax_kernel", 50),
    }
    res = {c: {"other": {"call_ms": [], "device_ms": []},
               "this": {"call_ms": [], "device_ms": []}} for c in cases}
    for p in range(args.pairs):
        order = ("other", "this") if p % 2 == 0 else ("this", "other")
        for c, (make, kname, launches) in cases.items():
            for v in order:
                fn = make(v)
                res[c][v]["call_ms"].append(cs.median_ms(
                    torch, fn, reps=10 if launches == 1 else 20,
                    launches=launches))
                res[c][v]["device_ms"].append(cs.device_ms(
                    torch, fn, kname, calls=10 if launches == 1 else 50))
    summary = {}
    for c, rv in res.items():
        summary[c] = {}
        for v, m in rv.items():
            s = {k: dict(values=vals, median=statistics.median(vals),
                         min=min(vals), max=max(vals))
                 for k, vals in m.items() if None not in vals}
            summary[c][v] = s
            print(f"{c} {v}: " + "; ".join(
                f"{k} median {x['median']:.4f} (min {x['min']:.4f}, max "
                f"{x['max']:.4f}; {', '.join(f'{t:.4f}' for t in x['values'])})"
                for k, x in s.items()))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_turns.json").write_text(json.dumps(dict(
        card=card, pairs=args.pairs, order="other,this then this,other",
        cases=summary), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
