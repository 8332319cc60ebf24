"""Fill a document's marker comments with the report's tables.

Port of ``repro.launch.fill_experiments``: the text after each of
``<!-- DRYRUN_TABLE -->``, ``<!-- ROOFLINE_TABLE -->`` and
``<!-- BFT_TABLE -->`` up to its ``_END`` marker (or the next heading)
becomes ``launch.report``'s table over the cells in ``--dir``.

    PYTHONPATH=src python -m repro_torch.launch.fill_experiments \
        --dir results/dryrun --file EXPERIMENTS.md
"""
from __future__ import annotations

import argparse
import re

from repro_torch.launch.report import bft_table, dryrun_table, load, roofline_table


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--file", default="EXPERIMENTS.md")
    args = ap.parse_args(argv)
    cells = load(args.dir)
    bft = [c for c in cells if "fast" in c]
    reg = [c for c in cells if "fast" not in c]

    text = open(args.file).read()

    def fill(marker: str, content: str, text: str) -> str:
        pat = re.compile(
            rf"<!-- {marker} -->.*?(?=<!-- {marker}_END -->|\n## |\n### |\Z)",
            re.S,
        )
        repl = f"<!-- {marker} -->\n\n{content}\n\n"
        if pat.search(text):
            return pat.sub(lambda _: repl, text, count=1)
        return text

    text = fill("DRYRUN_TABLE", dryrun_table(reg), text)
    text = fill("ROOFLINE_TABLE", roofline_table(reg), text)
    if bft:
        text = fill("BFT_TABLE", bft_table(bft), text)
    open(args.file, "w").write(text)
    n_ok = sum(1 for c in reg if "full" in c)
    n_skip = sum(1 for c in reg if "skipped" in c)
    n_err = sum(1 for c in reg if "error" in c)
    print(f"filled: {n_ok} cells, {n_skip} skips, {n_err} errors, {len(bft)} bft")


if __name__ == "__main__":
    main()
