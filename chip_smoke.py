#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failed check exits nonzero:

1. the card: name and power limit, a build of every CUDA source;
2. each kernel against its plain PyTorch version on the card, at the
   engine's main-path shapes and at ragged shapes, with times (CUDA
   events, median after warm-up) beside the card's bound;
3. the main path: ``repro_torch.run_batch`` on the gram_sweep
   configuration (B = 32 trials, T = 120 steps, n = 8 workers, f = 2,
   byz = (2, 5), drift attack, q = 0.2, n_data = 64, d = 2^20), with the
   kernels' launch counts, against the same run with the plain versions
   (``kernel_impl="torch"``) and against the CPU run on a small input;
4. a ``{"kernels": [...]}`` line;
5. the last line, ``{"ok": true, "device": {...}}``.

A copy of the report goes to ``chiprun_out/chip_smoke.json``.  The
script imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s; f32 adds/s
# (67 TFLOP/s counts an FMA as two operations, so one add is half of it)
HBM_BYTES_S = 3.35e12
F32_ADDS_S = 67e12 / 2
F32_OPS_S = 67e12

GRAM_SWEEP = dict(B=32, T=120, n_data=64, d=1 << 20)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(torch, fn, reps: int = 10, warm: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def close(a, b, rtol: float, atol: float) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


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
    print(f"K1 gram SK (T={T}, Ie={Ie}, d=2^20): max|kernel-plain| = "
          f"{err_sk:.3e} (tolerance: atol 1e-3 + rtol 2e-5)")
    check(close(sk_k, sk_p, 2e-5, 1e-3), "K1 sketch tables disagree")
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

    ms = median_ms(torch, lambda: gm.gram_factors_cuda(rows, None, keys,
                                                       with_gram=False))
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
    bytes_k1 = Ie * d * 4 + T * 4 + T * Ie * k * 4
    ops_k1 = T * Ie * d                       # signed f32 adds
    t_bytes, t_ops = bytes_k1 / HBM_BYTES_S * 1e3, ops_k1 / F32_ADDS_S * 1e3
    report["gram_factors"] = dict(
        name="gram_factors", route="cuda",
        source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/gram.py:45",
        max_abs_err=err_sk, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=library_ms)
    print(f"K1 gram SK: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={max(t_bytes, t_ops):.4f} "
          f"(bytes {t_bytes:.4f} ms, adds {t_ops:.4f} ms)")
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
    ms = median_ms(torch, lambda: mv.pairwise_relmax_batched_cuda(x_main),
                   reps=50)
    plain_ms = median_ms(torch, lambda: mv.pairwise_relmax_batched_plain(
        x_main), reps=50)
    B, R, dd = main_shape
    bytes_k3 = B * R * dd * 4 + B * R * R * 4
    ops_k3 = B * R * R * dd                   # one f32 division per element
    t_bytes, t_ops = bytes_k3 / HBM_BYTES_S * 1e3, ops_k3 / F32_OPS_S * 1e3
    report["pairwise_relmax_batched"] = dict(
        name="pairwise_relmax_batched", route="cuda",
        source="src/repro_torch/kernels/csrc/majority_vote.cu",
        replaces="src/repro/kernels/majority_vote.py:63",
        max_abs_err=err_main, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None)
    print(f"K3 relmax {main_shape}: kernel_ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} bound_ms={max(t_bytes, t_ops):.6f}")
    return report


def gram_sweep_specs(TrialSpec, B, T, n_data, d):
    return [TrialSpec(byz=(2, 5), attack="drift", q=0.2, steps=T, seed=s,
                      n_data=n_data, d=d, lr=float(n_data) / d,
                      label=f"gram_sweep/s{s}") for s in range(B)]


def same_control(a, b) -> bool:
    if not all(ra.identify_step == rb.identify_step
               and ra.efficiency == rb.efficiency
               and ra.q_trace == rb.q_trace for ra, rb in zip(a, b)):
        return False
    if not (a.detect_flags == b.detect_flags).all():
        return False
    return all((v == b.schedule.arrays[key]).all()
               for key, v in a.schedule.arrays.items())


def w_close(a, b) -> tuple[float, float]:
    import numpy as np

    Wa = np.stack([r.w for r in a])
    Wb = np.stack([r.w for r in b])
    return float(np.abs(Wa - Wb).max()), 1e-4 * (1 + float(np.abs(Wb).max()))


def phase_main_path(torch):
    import numpy as np

    import repro_torch
    from repro_torch.kernels import ops

    specs = gram_sweep_specs(repro_torch.TrialSpec, **GRAM_SWEEP)
    repro_torch.run_batch(specs)                       # warm-up
    ops.reset_launch_counts()
    runs = [repro_torch.run_batch(specs)]
    launches = ops.launch_counts()
    runs += [repro_torch.run_batch(specs) for _ in range(2)]
    res = runs[0]
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    print(res.plan.explain())
    check(res.plan.data_plane == "gram", "main path is not the gram plane")
    check(res.plan.schedule_mode == "vector", "schedule is not 'vector'")
    print(f"main path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    W = np.stack([r.w for r in res])
    L = np.array([r.losses for r in res])
    check(W.shape == (GRAM_SWEEP["B"], GRAM_SWEEP["d"]), f"W shape {W.shape}")
    check(bool(np.isfinite(W).all() and np.isfinite(L).all()),
          "non-finite W or losses")
    for s, r in zip(specs, res):
        honest_hit = set(r.identify_step) - set(s.byz)
        check(not honest_hit, f"{s.label}: honest workers {honest_hit} "
                              f"identified")
        check(not np.asarray(r.state.identified)[
            [w for w in range(s.n) if w not in s.byz]].any(),
            f"{s.label}: an honest worker was eliminated")

    plain = repro_torch.run_batch(specs, kernel_impl="torch")
    check(same_control(res, plain),
          "control quantities differ between kernels and plain versions")
    err, tol = w_close(res, plain)
    print(f"main path W: max|kernels-plain| = {err:.3e} (tolerance "
          f"1e-4*(1+max|W|) = {tol:.3e})")
    check(err <= tol, "W differs between kernels and plain versions")

    # a small input whose gradient descent contracts (lr below 2/L), so
    # the tolerance is not dominated by a growing iterate
    small = [repro_torch.TrialSpec(byz=(2, 5), attack="drift", q=0.3,
                                   steps=40, seed=s, n_data=64, d=4096,
                                   lr=16.0 / 4096) for s in range(4)]
    on_card = repro_torch.run_batch(small)
    on_cpu = repro_torch.run_batch(small, device="cpu")
    check(same_control(on_card, on_cpu), "small input: card vs CPU control")
    err_s, tol_s = w_close(on_card, on_cpu)
    print(f"small input (B=4, T=40, d=4096) card vs CPU: max|dW| = "
          f"{err_s:.3e} (tolerance {tol_s:.3e})")
    check(err_s <= tol_s, "small input: card vs CPU W")

    phases = {k: statistics.median(r.phase_s[k] for r in runs)
              for k in runs[0].phase_s}
    wall = statistics.median(r.elapsed_s for r in runs)
    ident = int(res.schedule.arrays["identify"].sum())
    print(f"main path warm wall (median of 3): {wall:.4f} s; phases (s): "
          + ", ".join(f"{k}={v:.4f}" for k, v in phases.items()))
    print(f"identify rounds: {ident}; detect flags: "
          f"{int(res.detect_flags.sum())}; efficiency (mean): "
          f"{statistics.mean(r.efficiency for r in res):.6f}")
    return launches, dict(wall_s=wall, phases_s=phases,
                          identify_rounds=ident, w_err_vs_plain=err,
                          w_err_small_vs_cpu=err_s)


def main() -> int:
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
    launches, main_path = phase_main_path(torch)
    for key, n in launches.items():
        kernels[key]["launches"] = n
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
