#!/usr/bin/env python3
"""Where K1's time goes: time the sketch-table kernel of a given
``gram.cu`` with parts of its work taken out, on one card.

    python3 scripts/gram_ablation.py --source DIR

DIR holds the ``gram.cu`` to take apart (with the headers it includes):
this checkout's ``src/repro_torch/kernels/csrc`` (the tensor-core
kernel), or the csrc of a commit before K1 moved to the tensor cores
(d1583fc, the f32 CUDA-core kernel), unpacked with ``git archive``.
Each variant is that source with parts of its ``sketch_tables_kernel``
replaced by a text substitution, built with the port's flags into
``build/gram_ablation/``.  For the CUDA-core kernel: the hash (a sign
from the column's low bit in its place), the loads of R from device
memory (the tile filled from the column index), the FMAs and the
shared-memory reads that feed them (one add of the sign per slab in
their place).  For the tensor-core kernel: the copies of R into the
ring, the hash (a constant sign pattern), the split into bf16 pieces
(the f32 bits passed on), the wgmma instructions (one add in their
place), the flushes of the accumulators, the epilogue.  A variant
computes wrong tables: the times are the point.  Every variant runs at
gram_sweep's shape (66 rows, d = 2^20, T = 120, k = 256), timed with
CUDA events over 5 back-to-back calls, median of 10, in two rounds.
Results go to ``chiprun_out/gram_ablation_<kind>.json`` (kind ``tensor``
or ``core``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (name, substitutions); each substitution must match the source once.
# The CUDA-core kernel (d1583fc):
HASH = [("for (int j = 0; j < TPT; ++j) sg[j] = hash_sign(pos, key[j]);",
         "for (int j = 0; j < TPT; ++j) sg[j] = ((pos ^ key[j]) & 1u) "
         "? 1.0f : -1.0f;")]
LOADS = [("(ok && i < Ie) ? rows[(long long)i * d + p] : 0.0f;",
          "(ok && i < Ie) ? (float)(p & 7) : 0.0f;")]
FMAS = [("for (int r = 0; r < IT; ++r) {\n        const float v = "
         "tile[s][r][lane];\n#pragma unroll\n        for (int j = 0; j < TPT;"
         " ++j) acc[j][r] = fmaf(sg[j], v, acc[j][r]);\n      }",
         "for (int j = 0; j < TPT; ++j) acc[j][0] += sg[j];")]
CORE_VARIANTS = {
    "full kernel": [],
    "cheap sign": HASH,
    "no loads": LOADS,
    "no FMAs": FMAS,
    "no loads, cheap sign": LOADS + HASH,
    "loads only": HASH + FMAS,
    "neither loads nor FMAs": LOADS + FMAS,
}
# The tensor-core kernel:
TC_COPY = [("        sk_cp16(dst + cidx * 4,\n                ok ? rows + "
            "(long long)(r0 + r) * d + m * k + c0 : rows, ok);", "")]
TC_HASH = [(f"      a[j][{i}] = sk_signs(p[{x}], p[{y}], key[j & 1][{h}]);",
            f"      a[j][{i}] = 0x3F80BF80u ^ key[j & 1][{h}];")
           for i, x, y, h in ((0, 0, 1, 0), (1, 0, 1, 1), (2, 2, 3, 0),
                              (3, 2, 3, 1))]
TC_SPLIT = [("        sk_split(lo4[cb], hi4[cb], p3[0], p3[1], p3[2]);",
             "        p3[0] = p3[1] = p3[2] = __float_as_uint(lo4[cb]) ^ "
             "__float_as_uint(hi4[cb]);")]
TC_MMA = [("        sk_wgmma(acc[j], a[j],\n                 sk_desc(pieces + "
           "((2 * wg + (j >> 1)) * 3 + pc) * SK_ROWS *\n"
           "                                      32));",
           "        acc[j][pc] += __uint_as_float(a[j][pc]);")]
TC_FLUSH = [("if ((st + 1) % SK_FLUSH == 0 || st + 1 == nstage) {",
             "if (st + 1 == nstage) {")]
TC_EPILOGUE = [("for (int e = half * (TILE / 2) + tid;",
                "for (int e = TILE + tid;")]
TC_VARIANTS = {
    "full kernel": [],
    "no copies": TC_COPY,
    "constant signs": TC_HASH,
    "no split": TC_SPLIT,
    "no mma": TC_MMA,
    "one flush": TC_FLUSH,
    "no epilogue": TC_EPILOGUE,
    "no mma, no split": TC_MMA + TC_SPLIT,
    "mma only": TC_COPY + TC_HASH + TC_SPLIT,
}


def build(src_dir: Path, name: str, subs) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    src = src_dir / "gram.cu"
    text = src.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} matches {text.count(old)} "
                             f"times in {src}")
        text = text.replace(old, new)
    out = ROOT / "build" / "gram_ablation" / src_dir.name / name.replace(
        " ", "_").replace(",", "")
    out.mkdir(parents=True, exist_ok=True)
    for h in src_dir.glob("*.cuh"):
        (out / h.name).write_text(h.read_text())
    (out / "gram.cu").write_text(text)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(out / "gram.so"), str(out / "gram.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "gram.so"))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gram_sketch_tables.argtypes = [vp, i, ll, vp, i, i, vp, vp]
    lib.gram_sketch_tables.restype = i
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True, type=Path)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("gram_ablation: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    src = args.source.resolve()
    variants = (TC_VARIANTS if "sk_wgmma" in (src / "gram.cu").read_text()
                else CORE_VARIANTS)
    with ThreadPoolExecutor(len(variants)) as ex:
        libs = dict(zip(variants, ex.map(lambda kv: build(src, *kv),
                                         variants.items())))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    Ie, d, T, k = 66, 1 << 20, 120, 256
    rows = torch.randn(Ie, d, generator=gen, device=dev)
    keys = torch.from_numpy((np.uint32(0x9E3779B9) * (np.arange(
        T, dtype=np.uint32) + 1)).view(np.int32)).to(dev)
    sk = torch.empty((T, Ie, k), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def time_one(lib) -> float:
        def call():
            st = lib.gram_sketch_tables(rows.data_ptr(), Ie, d,
                                        keys.data_ptr(), T, k, sk.data_ptr(),
                                        stream)
            if st:
                raise RuntimeError(f"gram_sketch_tables: CUDA error {st}")

        return cs.median_ms(torch, call, reps=10, warm=2, launches=5)

    res = {name: [] for name in variants}
    for _ in range(2):
        for name, lib in libs.items():
            res[name].append(time_one(lib))
    for name, ts in res.items():
        print(f"{name}: " + ", ".join(f"{t:.4f}" for t in ts) + " ms")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    kind = "tensor" if variants is TC_VARIANTS else "core"
    (out / f"gram_ablation_{kind}.json").write_text(json.dumps(
        dict(card=card, source=str(args.source), shape=[Ie, d, T, k],
             ms=res), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
