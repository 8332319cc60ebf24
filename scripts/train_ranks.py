#!/usr/bin/env python3
"""Parts of ``chip_smoke.py``'s ``phase_train_ranks`` alone on the card:
the training cell (llama3.2-1b at full width, 8 workers, 2 Byzantine)
with its workers as ranks.

    python3 scripts/train_ranks.py a      # one NCCL rank, bitwise
    python3 scripts/train_ranks.py b      # two gloo ranks on one card
    python3 scripts/train_ranks.py c      # one NCCL rank a visible card
    python3 scripts/train_ranks.py all    # the whole phase

Run from the root of a checkout; the readings go to
``chiprun_out/train_ranks.json``.
"""
import json
import pathlib
import sys
import time


def main(parts) -> int:
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("train_ranks: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(C.SRC))
    from repro_torch.launch import train as launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    C.phase_card(torch)
    spec = C.TRAIN
    seed = C.train_seed(spec["n"], spec["f"], spec["byz"])
    mask = np.isin(np.arange(spec["n"]), spec["byz"])
    out = {}
    t0 = time.time()
    try:
        if "a" in parts:
            out["a"] = C.ranks_a(torch, spec, seed, mask, {})[1]
        if "b" in parts:
            out["b"] = C.ranks_b(torch, spec, seed, mask)
        if "c" in parts:
            out["c"] = C.ranks_c(torch, spec, seed, mask, {},
                                 launch.default_nproc(spec["n"], "cuda"))
        if "all" in parts:
            out["phase"] = C.phase_train_ranks(torch, spec, {})[1]
    finally:
        launch.stop_rank_server()
    path = root / "chiprun_out" / "train_ranks.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    print(f"train_ranks {parts}: {time.time() - t0:.1f} s")
    return 0


# the spawned ranks run this module: nothing outside the guard
if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["all"]))
