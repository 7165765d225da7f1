"""Run one cell of the benchmark once, on the card this process sees:

    python3 -m gnnbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It prints the host's CPU and the card's name,
clocks and power limit, then as its last line one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (and with ``--trace 1``
``breakdown``), and last ``checks``, each compared number beside its limit,
which also close standard error. It exits non-zero, printing no result,
without a CUDA card or with fewer than the cell asks for, and when a module
of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host_lines() -> list[str]:
    cpu = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")),
                       cpu)
    except OSError:
        pass
    import torch

    lines = [f"host: {cpu}, {os.cpu_count()} CPUs, torch threads {torch.get_num_threads()}, "
             f"torch {torch.__version__}, CUDA {torch.version.cuda}"]
    query = "name,clocks.sm,clocks.max.sm,clocks.mem,power.limit,power.draw,temperature.gpu"
    try:
        smi = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        lines.append(f"card ({query}): {smi.stdout.strip() or smi.stderr.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        lines.append(f"card: nvidia-smi unavailable ({e})")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's package; the kernels it builds stay under the checkout's build/
    sys.path.insert(0, str(ROOT / "src"))
    # the profiler keeps CUPTI up across the CUDA-graph captures (device
    # records of later passes are lost otherwise); set before CUDA starts
    os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")
    os.environ.setdefault("TEARDOWN_CUPTI", "0")

    import torch

    from gnnbench.harness import Cell, forbidden_modules, run_cell

    cell = Cell.find(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this process sees {seen}",
              file=sys.stderr)
        return 2
    result, checks, info = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    for line in host_lines() + info:
        print(line)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in checks:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
