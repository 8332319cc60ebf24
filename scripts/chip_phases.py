#!/usr/bin/env python3
"""Some of ``chip_smoke.py``'s phases alone on the card, after its
first phase (the card's name and power limit, the kernels' build):

    python3 scripts/chip_phases.py split          # phase_engine_split
    python3 scripts/chip_phases.py kernels split train dryrun mamba moe
    python3 scripts/chip_phases.py tp             # phase_train_tp's (b)

``kernels`` runs ``phase_kernels`` and ``phase_stream_kernels``;
``split`` the trials split over every visible card (with two or more,
each kernel launched on a card that is not current); ``train``,
``mamba`` and ``moe`` ``phase_train`` on the llama3.2-1b, mamba2-780m
and phi3.5-moe cells; ``mamba_full`` the mamba2-780m cell at all 48
layers (the script cuts it to 16); ``dryrun`` ``phase_dryrun``; ``tp``
``phase_train_tp``'s (b) alone, the training cells split over the model
axis with one NCCL rank a card (llama3.2-1b at model 2 x W 2 and model
4, phi3.5-moe at one layer with model 4: four cards; its readings also
go to ``chiprun_out/chip_phases_tp.json``), and ``tp_a`` the phase's
one-card part (a).  Run from the root of a checkout; the phases print
their readings and raise on a failed check.
"""
import pathlib
import sys
import time

PHASES = ("kernels", "split", "train", "dryrun", "mamba", "mamba_full",
          "moe", "tp", "tp_a")


def main(which) -> int:
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as C

    unknown = sorted(set(which) - set(PHASES))
    if unknown or not which:
        print(f"chip_phases: name phases among {PHASES}, got {which}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(C.SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        C.phase_card(torch)
        t0 = time.perf_counter()
        if "kernels" in which:
            C.phase_kernels(torch)
            C.phase_stream_kernels(torch)
        if "split" in which:
            C.phase_engine_split(torch)
        if "train" in which:
            C.phase_train(torch, C.TRAIN, "train")
        if "dryrun" in which:
            C.phase_dryrun(torch, None)
        if "mamba" in which:
            C.phase_train(torch, C.MAMBA_TRAIN, "mamba_train")
        if "mamba_full" in which:
            C.phase_train(torch, dict(C.MAMBA_TRAIN, layers=None),
                          "mamba_train")
        if "moe" in which:
            C.phase_train(torch, C.MOE_TRAIN, "moe_train")
        if "tp" in which or "tp_a" in which:
            import json

            import numpy as np

            from repro_torch.launch import train as launch

            spec = C.TRAIN
            seed = C.train_seed(spec["n"], spec["f"], spec["byz"])
            mask = np.isin(np.arange(spec["n"]), spec["byz"])
            out = {}
            try:
                if "tp_a" in which:
                    out["a"] = C.phase_train_tp(torch, spec)[2]
                if "tp" in which:
                    out["b"] = C.tp_cards(torch, seed, mask,
                                          torch.cuda.device_count())
            finally:
                launch.stop_rank_server()
            path = root / "chiprun_out" / "chip_phases_tp.json"
            path.parent.mkdir(exist_ok=True)
            path.write_text(json.dumps(out, indent=1, default=str))
        print(f"chip_phases: {which} in {time.perf_counter() - t0:.1f} s")
    finally:
        C.stop_children()
    return 0


# the spawned ranks run this module: nothing outside the guard
if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
