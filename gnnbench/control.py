"""The readings that the limits of ``gnnbench/limits/<cell>.json`` are set
from, for a cell, on the card, at the cell's own size, over many seeds in
one process:

    python3 -m gnnbench.control --workload <name> --seeds <n> [<n> ...] [--variants ...]

For each seed it prints one JSON line per variant (all, or those named)
with the numbers ``compare`` computes:

* ``program``: the cell's set-up as a run makes it (the three checked
  training steps) against the plain reference: the lower readings;
* ``control``: the reference itself at TF32 (``Precision("tf32")``) put in
  the program's place: one precision below the configuration's float32;
* planted in the reference put in the program's place: ``half_batch`` (the
  chunks of the first half alone, the mean taken over them) and
  ``unchanged`` (steps that return the state they were given).

No window runs: none of these numbers needs one. The graph and the
program's plan are drawn once for all the seeds. A fault that returns the
state unchanged reads 1 in ``grad_gap`` and ``change_gap`` by their
definition on every seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


VARIANTS = ("control", "half_batch", "unchanged")


def reference_variants(cell, p0: dict, graphs: list, seed: int, variants=VARIANTS) -> dict:
    """The compared numbers of the control and of each planted fault."""
    from gnnbench import compare
    from gnnbench.harness import CHECKED_STEPS
    from gnnbench.reference import common as ref

    model, cfg = cell.reference, cell.config
    want = ref.train_steps(model, p0, graphs, cfg, seed, CHECKED_STEPS)

    def as_program(out):
        return {"losses": out["losses"],
                "grad1": {k: v / (1 - ref.Adam(0.0).b1) for k, v in out["mu1"].items()},
                "change": {k: v - p0[k] for k, v in out["params"][-1].items()}}

    half = list(range(len(graphs) // 2))
    runs = {
        "control": lambda: ref.train_steps(model, p0, graphs, cfg, seed, CHECKED_STEPS,
                                           ref.Precision("tf32")),
        "half_batch": lambda: ref.train_steps(model, p0, graphs, cfg, seed, CHECKED_STEPS,
                                              chunks=half),
        "unchanged": lambda: ref.train_steps(model, p0, graphs, cfg, seed, CHECKED_STEPS,
                                             hold=True),
    }
    return {name: compare.train_gaps(as_program(runs[name]()), want, p0) for name in variants}


def readings(cell, seed: int, device, drawn: dict, variants=VARIANTS) -> dict:
    from gnnbench import harness
    from gnnbench.reference import common as ref
    from gnnbench.trace import Spans

    run = harness.Run()
    graph = harness.train_setup(cell, seed, device, run, Spans(False), drawn)[0]
    gc.collect()  # the program's engine, plan and layout
    torch.cuda.empty_cache()
    graphs = ref.chunk_graphs(graph, cell.traffic, device)
    p0 = {k: v.to(device) for k, v in ref.flat(run.judged["p0"]).items()}
    return {"program": harness.judge(cell, seed, run, graphs, device),
            **reference_variants(cell, p0, graphs, seed, variants)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="*", choices=VARIANTS, default=list(VARIANTS))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))  # the program's package

    from gnnbench.harness import Cell

    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card", file=sys.stderr)
        return 2
    cell = Cell.find(args.workload)
    drawn: dict = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        found = readings(cell, seed, torch.device("cuda"), drawn, args.variants)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        for variant, numbers in found.items():
            print(json.dumps({"cell": cell.name, "seed": seed, "variant": variant, **numbers}),
                  flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
