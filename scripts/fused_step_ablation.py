#!/usr/bin/env python3
"""Where K2's time goes: time the fused-step kernel with parts of its
work taken out, on one card.

    python3 scripts/fused_step_ablation.py

Each variant is ``src/repro_torch/kernels/csrc/fused_step.cu`` with one
or more of its parts removed by a text substitution, built with the
port's flags into ``build/ablation/``: the tile loads (cp.async), the
W' stores to device memory, the sketch, the update product (a), the
residual product (b).  A variant without loads computes on whatever the ring
holds, so its outputs are wrong: the times are the point.  Every
variant is timed at the fused_sweep chunk (64 trials, 66 rows,
d = 2^20, f32 rows) with CUDA events over 5 back-to-back calls (kernel
and span sum), median of 10, in two rounds.  Results go to
``chiprun_out/fused_step_ablation.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "fused_step.cu"
# (name, substitutions); each substitution must match the source once
LOADS = [("if (m < nitems) issue(", "if (m < 0) issue("),
         ("if (s < nitems) issue(", "if (s < 0) issue(")]
STORES = [("if (t < nb) {\n              float* g", "if (t < -1) {\n"
           "              float* g")]
SKETCH = [("if (do_sk) {\n          const float sg",
           "if (false) {\n          const float sg")]
PROD_A = [("for (int i = 0; i < nrow; ++i) {", "for (int i = 0; i < 0; ++i) {")]
PROD_B = [("for (int s = 0; s < TC / (4 * KS); ++s) {",
           "for (int s = 0; s < 0; ++s) {")]
VARIANTS = {
    "full kernel": [],
    "no sketch": SKETCH,
    "no tile loads": LOADS,
    "no W' stores": STORES,
    "no loads or stores": LOADS + STORES,
    "no loads or stores, (a) only": LOADS + STORES + PROD_B,
    "no loads or stores, (b) only": LOADS + STORES + PROD_A,
    "no loads or stores, neither product": LOADS + STORES + PROD_A + PROD_B,
}


def build(name: str, subs) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    text = SRC.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} matches {text.count(old)} "
                             f"times in {SRC.name}")
        text = text.replace(old, new)
    out = ROOT / "build" / "ablation" / name.replace(" ", "_").replace(
        "'", "").replace(",", "").replace("(", "").replace(")", "")
    out.mkdir(parents=True, exist_ok=True)
    for h in SRC.parent.glob("*.cuh"):
        (out / h.name).write_text(h.read_text())
    (out / SRC.name).write_text(text)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(out / "fused_step.so"), str(out / SRC.name)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "fused_step.so"))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_step_num_spans.argtypes = [i, i, ll, i]
    lib.fused_step_num_spans.restype = i
    lib.fused_step_f32.argtypes = [vp, i, ll, vp, vp, i, i, ctypes.c_uint32,
                                   vp, vp, vp, vp, vp]
    lib.fused_step_f32.restype = i
    return lib


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("fused_step_ablation: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(build, VARIANTS,
                                         VARIANTS.values())))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, Ie, d, k = 64, 66, 1 << 20, 256
    rows = torch.randn(Ie, d, generator=gen, device=dev)
    W = torch.randn(B, d, generator=gen, device=dev)
    cw = torch.randn(B, Ie, generator=gen, device=dev) * 0.01
    stream = torch.cuda.current_stream(dev).cuda_stream

    def time_one(lib) -> float:
        nspan = lib.fused_step_num_spans(B, Ie, d, k)
        part_r = torch.empty((nspan, B, Ie), device=dev)
        part_sk = torch.empty((nspan, Ie, k), device=dev)
        resid = torch.empty((B, Ie), device=dev)
        sk = torch.empty((Ie, k), device=dev)

        def call():
            st = lib.fused_step_f32(
                rows.data_ptr(), Ie, d, W.data_ptr(), cw.data_ptr(), B, k,
                7, part_r.data_ptr(), part_sk.data_ptr(), resid.data_ptr(),
                sk.data_ptr(), stream)
            if st:
                raise RuntimeError(f"fused_step_f32: CUDA error {st}")

        return cs.median_ms(torch, call, reps=10, warm=3, launches=5)

    res = {name: [] for name in VARIANTS}
    for _ in range(2):
        for name, lib in libs.items():
            res[name].append(time_one(lib))
    for name, ts in res.items():
        print(f"{name}: " + ", ".join(f"{t:.4f}" for t in ts) + " ms")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fused_step_ablation.json").write_text(json.dumps(
        dict(card=card, shape=[B, Ie, d, k], ms=res), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
