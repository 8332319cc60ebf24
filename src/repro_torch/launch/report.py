"""Tables of the dry-run's cells (``launch.dryrun``'s JSON files): the
dry-run matrix, the one-card roofline and the BFT steps.

Port of ``repro.launch.report``; the same tables, for one H100: the fit
column reads "fits 80G" (``roofline.HBM_PER_CARD``) and the roofline's
figures are bounds from the card's constants, not measurements.
``--kind summary`` folds every cell into one row an arch.  The plain
cells of ``--mesh production`` (rank 0 of 16x16 and 2x16x16, FSDP + TP)
get a per-device table each (``production_table``), the reference's
single-pod roofline table.  The BFT
cells of ``--mesh workers`` (n ranks on ``data``) also get a table of
their collectives: all-reduce and all-gather calls, result and wire
bytes a rank, and the collective term at NVLink's rate.

    PYTHONPATH=src python -m repro_torch.launch.report --dir results/dryrun
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def fmt_b(x: float) -> str:
    if x >= 2**30:
        return f"{x/2**30:.2f}GiB"
    return f"{x/2**20:.1f}MiB"


def load(dirname: str) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as fh:
            out.append(json.load(fh))
    return out


ARCH_ORDER = [
    "llama-3.2-vision-90b", "llama3.2-1b", "gemma3-1b", "qwen3-4b",
    "starcoder2-7b", "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
    "whisper-tiny", "jamba-v0.1-52b", "mamba2-780m",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def sort_key(r: dict):
    a = ARCH_ORDER.index(r["arch"]) if r["arch"] in ARCH_ORDER else 99
    s = SHAPE_ORDER.index(r["shape"]) if r.get("shape") in SHAPE_ORDER else 99
    return (a, s, r.get("mesh", ""))


def dryrun_table(cells: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | compile | bytes/dev (arg+temp) | fits 80G | collectives (AR/AG/RS/A2A/CP) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(cells, key=sort_key):
        if "skipped" in r:
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | SKIP: {r['skipped']} |"
            )
            continue
        if "error" in r:
            lines.append(
                f"| {r['arch']} | {r.get('shape')} | {r.get('mesh')} | — | — | — | ERROR: {r['error'][:80]} |"
            )
            continue
        f = r["full"]
        c = f.get("collective_counts", {})
        cc = "/".join(
            str(c.get(k, 0))
            for k in ("all-reduce", "all-gather", "reduce-scatter",
                      "all-to-all", "collective-permute")
        )
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {f['compile_s']:.0f}s "
            f"| {fmt_b(f['arg_bytes'])}+{fmt_b(f['temp_bytes'])} "
            f"| {'Y' if r['fits_hbm'] else 'N*'} | {cc} |"
        )
    return "\n".join(lines)


def roofline_table(cells: list[dict]) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | dominant | MODEL/HLO FLOPs | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(cells, key=sort_key):
        rl = r.get("roofline")
        if not rl:
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rl['compute_s'])} "
            f"| {fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} "
            f"| **{rl['dominant']}** | {rl['useful_flops_fraction']:.2f} "
            f"| {rl['roofline_fraction']:.3f} |"
        )
    return "\n".join(lines)


PRODUCTION = ("16x16", "2x16x16")


def production_table(cells: list[dict], mesh: str = "16x16") -> str:
    """Rank 0 of a production mesh (``dryrun --mesh production``), per
    device per step: the peak and its fit, the roofline's terms, the
    collectives' wire bytes by axis, and at 16x16 MODEL / counted FLOPs
    over the mesh's chips (the reference's per-device table)."""
    lines = [
        "| arch | shape | peak/dev | fits 80G | compute | memory | collective "
        "| wire bytes by axis | dominant | MODEL/HLO FLOPs | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(cells, key=sort_key):
        if r.get("mesh") != mesh:
            continue
        if "skipped" in r or "error" in r:
            why = r.get("skipped") or r["error"]
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — "
                         f"| — | — | SKIP: {why} | | |")
            continue
        rl = r["roofline"]
        axes = ", ".join(f"{a} {fmt_b(b)}" for a, b in
                         r.get("collective_by_axis", {}).items())
        mf = (f"{rl['useful_flops_fraction']:.2f}"
              if rl["model_flops_total"] else "—")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_b(r['full']['peak_bytes'])} "
            f"| {'Y' if r['fits_hbm'] else 'N*'} | {fmt_s(rl['compute_s'])} "
            f"| {fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} "
            f"| {axes} | **{rl['dominant']}** | {mf} "
            f"| {rl['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def bft_table(cells: list[dict]) -> str:
    lines = [
        "| arch | mesh | workers | step | r | shards | peak bytes/dev | collective bytes/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in cells:
        if "error" in r:
            lines.append(f"| {r['arch']} | — | — | ERROR {r['error'][:60]} | | | | |")
            continue
        for mode in ("fast", "check", "identify"):
            if mode not in r:
                continue
            m = r[mode]
            lines.append(
                f"| {r['arch']} | {r['mesh']} | {r['n']} | {mode} "
                f"| {m['replication']} | {m['num_shards']} "
                f"| {fmt_b(m['peak_bytes'])} | {fmt_b(m['collective_bytes'])} |"
            )
    return "\n".join(lines)


def bft_collectives_table(cells: list[dict]) -> str:
    """Each BFT step's collectives a rank: calls and result bytes of the
    all-reduces (AR) and all-gathers (AG), the bytes on the wire
    (``roofline.ring_bytes``), the collective term and the step's
    bound."""
    lines = [
        "| arch | mesh | step | AR calls | AR bytes | AG calls | AG bytes "
        "| wire bytes/rank | collective | bound | dominant |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in cells:
        if "error" in r:
            continue
        for mode in ("fast", "check", "check_full", "identify"):
            m = r.get(mode)
            if m is None:
                continue
            c = m.get("collective_counts", {})
            b = m.get("collective_result_bytes", {})
            rl = m["roofline"]
            lines.append(
                f"| {r['arch']} | {r['mesh']} | {mode} "
                f"| {c.get('all-reduce', 0)} | {fmt_b(b.get('all-reduce', 0))} "
                f"| {c.get('all-gather', 0)} | {fmt_b(b.get('all-gather', 0))} "
                f"| {fmt_b(m['collective_bytes'])} "
                f"| {fmt_s(rl['collective_s'])} | {fmt_s(_bound(rl))} "
                f"| {rl['dominant']} |")
    return "\n".join(lines)


def _bound(rl: dict) -> float:
    return max(rl["compute_s"], rl["memory_s"], rl["collective_s"])


def summary_table(cells: list[dict], bft: list[dict] = ()) -> str:
    """Every (arch x shape) cell in one row an arch: the predicted peak
    (arguments + temporaries), whether it fits the card, the roofline
    bound and its dominant term (c compute, m memory, n collective);
    with ``bft`` cells, a last column of their fast / check / identify
    bounds."""
    by_arch: dict[str, dict] = {}
    for r in cells:
        by_arch.setdefault(r["arch"], {})[r.get("shape")] = r
    steps = {r["arch"]: r for r in bft}
    head = list(SHAPE_ORDER) + (["BFT fast / check / identify"] if bft
                                else [])
    lines = ["| arch | " + " | ".join(head) + " |",
             "|---|" + "---|" * len(head)]
    for arch in sorted(by_arch, key=lambda a: sort_key({"arch": a})):
        row = []
        for shape in SHAPE_ORDER:
            r = by_arch[arch].get(shape)
            if r is None:
                row.append("—")
            elif "skipped" in r:
                row.append("skip")
            elif "error" in r:
                row.append("ERROR")
            else:
                rl = r.get("roofline")
                row.append(f"{fmt_b(r['full']['peak_bytes'])} "
                           f"{'fits' if r['fits_hbm'] else 'no'}"
                           + (f", {fmt_s(_bound(rl))} {rl['dominant'][0]}"
                              if rl else ""))
        if bft:
            r = steps.get(arch)
            row.append("—" if r is None else "ERROR" if "error" in r else
                       " / ".join(fmt_s(_bound(r[m]["roofline"]))
                                  for m in ("fast", "check", "identify")))
        lines.append(f"| {arch} | " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--kind", default="all", choices=[
        "all", "dryrun", "roofline", "bft", "summary"])
    args = ap.parse_args(argv)
    cells = load(args.dir)
    bft = [c for c in cells if "fast" in c or ("error" in c and "shape" not in c)]
    reg = [c for c in cells if c not in bft]
    prod = [c for c in reg if c.get("mesh") in PRODUCTION]
    one = [c for c in reg if c not in prod]
    if args.kind in ("all", "dryrun"):
        print("### Dry-run matrix\n")
        print(dryrun_table(reg))
        print()
    if args.kind in ("all", "roofline"):
        print("### Roofline (one H100, per step; bounds from the card's "
              "constants, not measured)\n")
        print(roofline_table(one))
        print()
        for mesh in PRODUCTION:
            if any(c.get("mesh") == mesh for c in prod):
                print(f"### Roofline ({mesh}, rank 0, per device per step; "
                      f"FSDP + TP, bounds from the card's constants, not "
                      f"measured)\n")
                print(production_table(prod, mesh))
                print()
    if args.kind in ("all", "bft") and bft:
        print("### BFT step dry-runs\n")
        print(bft_table(bft))
        print()
        print("### BFT step collectives (a rank; bounds from the card's "
              "constants, not measured)\n")
        print(bft_collectives_table(bft))
    if args.kind == "summary":
        print("### One H100: predicted peak, fit and roofline bound a cell"
              " (bounds from the card's constants, not measured)\n")
        print(summary_table(one, bft))


if __name__ == "__main__":
    main()
