"""Render the §Dry-run and §Roofline tables from dry-run reports: one
card, and one rank of the reference's 16x16 and 2x16x16 grids.
Counterpart of ``repro.roofline.render``.

    PYTHONPATH=src python -m repro_torch.roofline.render [--dir reports/dryrun_torch]

The reports are ``launch/dryrun.py``'s JSON files: meta-device counts at
the card's data-sheet rates, so every number in the tables is a
prediction. A grid's row is one rank's (its peak, work and collective
bytes: the reference's per-device columns).
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load(reports_dir: str) -> list[dict]:
    rows = []
    for fn in sorted(glob.glob(os.path.join(reports_dir, "*.json"))):
        with open(fn) as f:
            rows.append(json.load(f))
    return rows


def fmt_bytes(b) -> str:
    return f"{b / 2**30:.2f}"


def dryrun_table(rows, mesh="1 card") -> str:
    out = [
        "| arch | shape | µbatch | peak GiB | fits | aten GFLOPs | kernel GFLOPs | GB moved | "
        "kernel calls | collective GiB (top op) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        coll = r["collective_bytes"]
        top = max((k for k in coll if k != "total" and coll[k]), key=lambda k: coll[k],
                  default="-")
        calls = ", ".join(f"{k.replace('_kernel', '')} {v}"
                          for k, v in sorted(r["kernel_calls"].items())) or "-"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['num_micro']} | "
            f"{r['memory']['peak_estimate_gib']} | {'yes' if r['memory']['fits'] else 'no'} | "
            f"{r['flops']['aten'] / 1e9:.0f} | {sum(r['flops']['kernels'].values()) / 1e9:.0f} | "
            f"{r['bytes']['total'] / 1e9:.0f} | {calls} | {fmt_bytes(coll['total'])} ({top}) |"
        )
    return "\n".join(out)


def roofline_table(rows, mesh="1 card") -> str:
    out = [
        "| arch | shape | compute s | memory s | collective s | dominant | useful-FLOPs ratio |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.4f} | "
            f"{rf['memory_s']:.4f} | {rf['collective_s']:.4f} | "
            f"{rf['dominant'].replace('_s', '')} | {rf['useful_flops_ratio']:.3f} |"
        )
    return "\n".join(out)


GRID_TITLES = (("16x16", "single pod 16×16 (256 cards)"),
               ("2x16x16", "multi-pod 2×16×16 (512 cards)"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="reports/dryrun_torch")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    card = rows[0]["card"] if rows else "the card"
    print(f"## §Dry-run — one {card} (meta-device counts, predictions)\n")
    print(dryrun_table(rows))
    for mesh, title in GRID_TITLES:
        print(f"\n## §Dry-run — {title}, one rank's counts (meta, predictions)\n")
        print(dryrun_table(rows, mesh))
    print(f"\n## §Roofline — one {card} at its data-sheet rates (predictions)\n")
    print(roofline_table(rows))
    for mesh, title in GRID_TITLES:
        print(f"\n## §Roofline — {title}, one rank at the card's data-sheet rates "
              "(predictions)\n")
        print(roofline_table(rows, mesh))


if __name__ == "__main__":
    main()
