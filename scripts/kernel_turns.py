#!/usr/bin/env python3
"""Time this checkout's kernels against the same kernels built from
another source directory, in turns on one card.

    python3 scripts/kernel_turns.py --other DIR [--pairs 5] [--cases ...]

DIR holds the other version's ``fused_step.cu``, ``majority_vote.cu``,
``gram.cu`` and ``sketch.cu`` with the headers they include, for example
a parent commit's ``src/repro_torch/kernels/csrc`` unpacked with ``git
archive``.  Both versions must have this checkout's C interfaces for
K1, K2, K3 and K4 (``gram_sketch_tables``, ``fused_step_*``,
``relmax_batched``, ``sketch_batched``).  The other version's relmax
output is zero-filled before its launch, as its wrapper did when the
kernel merged every chunk with atomicMax.  K4s (the single CountSketch)
is this checkout's wrapper ``sketch.sketch_cuda`` against the other
version's ``sketch_batched`` at B = 1 with its span scratch, called as
that version's wrapper did (a size query, two allocations, the current
stream).  The other cases call both versions through the same Python
code, so their call times differ by the kernels and their launches.

Cases and shapes: K1 (the gram sketch tables) at gram_sweep's (66 rows,
d = 2^20, T = 120, k = 256); K2 at the fused_sweep chunk (64 trials, 66
rows, d = 2^20), f32 and bf16 rows; K3 at the engine's vote (32, 8,
256); K3s at the single vote (7, 1e5); K4 at the unfused plane's (66,
2^20); K4s at the bench's d = 1e6 and the serving audit's 4 x 128256;
K4s's shard form (``sketch_block``) at the split leaves' shards of
the training cells (llama3.2-1b's embedding at model 2, one row of
131,334,144; mamba2-780m's, 38,615,040; jamba's expert leaf at model 4,
two rows of 234,881,024; llama's wq and w1 at model 2, 32,768 rows of
1024 and 4096 of 2048 and 8192; one row of 2^20, whose 2 MB take a
call's fixed cost), f32 through both versions'
``sketch_block`` and bf16 through this version's ``sketch_block_bf16``
against the other's bf16 path where it has none (an f32 copy, then its
``sketch_block``, as its ``ops.sketch_shard`` did).  Each pair runs the two versions in turns (other, this; then this,
other; ...), each measurement the median of CUDA-event timings (K1, K2,
K4: one call an event pair; K3, K3s, K4s: 50 back-to-back calls an
event pair) and the profiler's device time (K1, K2, K3, K3s: the kernel
by name; K4, K4s: every kernel of the call, and once each kernel by
name).  The result goes to
``chiprun_out/kernel_turns.json``.
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


SOURCES = ("fused_step", "majority_vote", "gram", "sketch")


def build_other(src: Path, out: Path) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)

    def one(name):
        lib = out / f"{name}.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(lib), str(src / f"{name}.cu")], check=True,
                       capture_output=True)
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(SOURCES)) as ex:
        return dict(ex.map(one, SOURCES))


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
    gm, sk = libs["gram"], libs["sketch"]
    gm.gram_sketch_tables.argtypes = [vp, i, ll, vp, i, i, vp, vp]
    gm.gram_sketch_tables.restype = i
    sk.sketch_num_spans.argtypes = [i, ll, i]
    sk.sketch_num_spans.restype = i
    sk.sketch_batched.argtypes = [vp, i, ll, i, ctypes.c_uint32, vp, vp, vp]
    sk.sketch_batched.restype = i
    for name in ("sketch_block", "sketch_block_bf16"):
        if hasattr(sk, name):
            getattr(sk, name).argtypes = [vp, ll, ll, ll, ll, i,
                                          ctypes.c_uint32, vp, vp, vp, vp]
            getattr(sk, name).restype = i
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--cases", nargs="*", default=None,
                    help="case names to run (default: all)")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import sketch as sketch_mod

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(card)
    _build.build_all()
    libs = {"this": typed({n: _build.load(n) for n in SOURCES}),
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

    def k1_call(lib, rows, keys, sk_out):
        Ie, d = rows.shape
        st = lib["gram"].gram_sketch_tables(
            rows.data_ptr(), Ie, d, keys.data_ptr(), keys.numel(), 256,
            sk_out.data_ptr(), stream)
        if st:
            raise RuntimeError(f"gram_sketch_tables: CUDA error {st}")
        return sk_out

    def k4_call(lib, g):
        """sketch_batched as the wrappers call it: size query, partials
        and output allocated per call, the current stream."""
        sk = lib["sketch"]
        B, d = g.shape
        out = torch.empty((B, 256), device=dev)
        part = torch.empty((sk.sketch_num_spans(B, d, 256), B, 256),
                           device=dev)
        st = sk.sketch_batched(g.data_ptr(), B, d, 256, 0x9E3779B9,
                               part.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
        if st:
            raise RuntimeError(f"sketch_batched: CUDA error {st}")
        return out

    def k4s_call(v, x):
        if v == "this":
            return sketch_mod.sketch_cuda(x, 7)
        # the other version's wrapper: its batched kernel at B = 1
        _build.require_cuda_tensor(x[None], "flat_g", 2, (torch.float32,))
        sk = libs["other"]["sketch"]
        d = x.shape[0]
        out = torch.empty((1, 256), device=x.device)
        part = torch.empty((sk.sketch_num_spans(1, d, 256), 1, 256),
                           device=x.device)
        st = sk.sketch_batched(x.data_ptr(), 1, d, 256, 7, part.data_ptr(),
                               out.data_ptr(),
                               torch.cuda.current_stream(x.device).cuda_stream)
        if st:
            raise RuntimeError(f"sketch_batched: CUDA error {st}")
        return out[0]

    # tickets enough for either version's shard form
    shard_ws = {v: (torch.empty((1024, 256), device=dev),
                    torch.zeros(64, dtype=torch.int32, device=dev))
                for v in libs}

    def shard_call(v, g, cfull, c0):
        """The shard form as each version's ``ops.sketch_shard`` called
        it: a bf16 block read as it is where the version has
        ``sketch_block_bf16``, else copied to f32 first."""
        sk = libs[v]["sketch"]
        fn = sk.sketch_block
        if g.dtype == torch.bfloat16:
            if hasattr(sk, "sketch_block_bf16"):
                fn = sk.sketch_block_bf16
            else:
                g = g.to(torch.float32)
        part, ticket = shard_ws[v]
        out = torch.empty(256, device=dev)
        st = fn(g.data_ptr(), g.shape[0], g.shape[1], cfull, c0, 256, 7,
                part.data_ptr(), ticket.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if st:
            raise RuntimeError(f"sketch_block: CUDA error {st}")
        return out

    # (label, rows, cols, cfull, c0): a rank's shard of a split leaf
    shard_shapes = [("llama embed", 1, 131_334_144, 262_668_288, 131_334_144),
                    ("mamba embed", 1, 38_615_040, 77_230_080, 38_615_040),
                    ("jamba expert", 2, 234_881_024, 939_524_096,
                     704_643_072),
                    ("llama wq", 32768, 1024, 2048, 1024),
                    ("llama w1", 32768, 4096, 8192, 4096),
                    ("row 2^20", 1, 1 << 20, 1 << 21, 1 << 20)]
    if args.cases:
        shard_shapes = [sh for sh in shard_shapes if any(
            c.startswith(f"K4s shard {sh[0]}") for c in args.cases)]
    shard_blocks = {}
    for label, r, c, cfull, c0 in shard_shapes:
        x = torch.randn(r, c, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            name = f"K4s shard {label} {str(dt).removeprefix('torch.')}"
            shard_blocks[name] = (x.to(dt), cfull, c0)
        del x
    rows = torch.randn(66, 1 << 20, generator=gen, device=dev)
    rows_bf = rows.to(torch.bfloat16)
    W = torch.randn(64, 1 << 20, generator=gen, device=dev)
    cw = torch.randn(64, 66, generator=gen, device=dev) * 0.01
    x3 = torch.randn(32, 8, 256, generator=gen, device=dev)
    x3s = torch.randn(1, 7, 100_000, generator=gen, device=dev)
    keys1 = torch.from_numpy((np.uint32(0x9E3779B9) * (np.arange(
        120, dtype=np.uint32) + 1)).view(np.int32)).to(dev)
    sk1 = {v: torch.empty((120, 66, 256), device=dev) for v in libs}
    x4s = {"K4s d=1e6": torch.randn(1_000_000, generator=gen, device=dev),
           "K4s d=513024": torch.randn(513_024, generator=gen, device=dev)}

    a = k1_call(libs["this"], rows, keys1, sk1["this"])
    b = k1_call(libs["other"], rows, keys1, sk1["other"])
    torch.cuda.synchronize()
    print(f"K1: this vs other max|dSK| {cs.max_err(a, b):.3e}")
    a, b = k4_call(libs["this"], rows), k4_call(libs["other"], rows)
    torch.cuda.synchronize()
    print(f"K4: this vs other bitwise equal: {torch.equal(a, b)}")
    for label, x in x4s.items():
        a, b = k4s_call("this", x), k4s_call("other", x)
        torch.cuda.synchronize()
        print(f"{label}: this vs other max|d| {cs.max_err(a, b):.3e}")

    for label, (g, cfull, c0) in shard_blocks.items():
        a, b = shard_call("this", g, cfull, c0), shard_call("other", g, cfull,
                                                            c0)
        torch.cuda.synchronize()
        print(f"{label}: this vs other max|d| / max(1, max|other|) "
              f"{cs.rel_err(a, b):.3e}")
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
        "K1": (lambda v: lambda: k1_call(libs[v], rows, keys1, sk1[v]),
               "sketch_tables_kernel", 1),
        "K4": (lambda v: lambda: k4_call(libs[v], rows), None, 1),
        **{label: ((lambda x: lambda v: lambda: k4s_call(v, x))(x), None, 50)
           for label, x in x4s.items()},
        "K2 f32": (lambda v: lambda: k2_call(libs[v], rows, W, cw),
                   "fused_step_kernel", 1),
        "K2 bf16": (lambda v: lambda: k2_call(libs[v], rows_bf, W, cw),
                    "fused_step_kernel", 1),
        "K3": (lambda v: lambda: k3_call(libs[v], x3, v == "other"),
               "relmax_kernel", 50),
        "K3s": (lambda v: lambda: k3_call(libs[v], x3s, v == "other"),
                "relmax_kernel", 50),
        # f32: the kernel by name; bf16: the call's kernels (the other's
        # copy to f32 with its kernel)
        **{label: ((lambda b: lambda v: lambda: shard_call(v, *b))(blk),
                   "sketch_block_kernel" if blk[0].dtype == torch.float32
                   else None, 1 if blk[0].numel() > 1 << 26 else 10)
           for label, blk in shard_blocks.items()},
    }
    if args.cases:
        cases = {c: v for c, v in cases.items() if c in args.cases}
    def by_name(fn, calls):
        """{kernel: ms per call} of every kernel ``calls`` calls of
        ``fn`` launch, from one profiler window."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us: dict = {}
        for e in prof.events():
            if getattr(e, "device_type", None) == DeviceType.CUDA and \
                    e.name != "Activity Buffer Request":
                us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
        return {k: v / 1e3 / calls for k, v in us.items()}

    res = {c: {"other": {"call_ms": [], "device_ms": []},
               "this": {"call_ms": [], "device_ms": []}} for c in cases}
    # where the device time of a call is every kernel's, each kernel's
    kernels = {c: {v: by_name(make(v), 50 if n > 1 else 10)
                   for v in ("other", "this")}
               for c, (make, kname, n) in cases.items() if kname is None}
    for c, kv in kernels.items():
        for v, named in kv.items():
            print(f"{c} {v}: device ms by kernel: " + "; ".join(
                f"{k} {t:.4f}" for k, t in named.items()))
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
        cases=summary, device_ms_by_kernel=kernels), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
