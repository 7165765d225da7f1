"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: the program's ``repro_torch`` begins with ``repro``), and the plain
reference loads nothing of the program."""

import ast
import subprocess
import sys

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}
REFERENCE = [ROOT / "gnnbench" / "graph.py", ROOT / "gnnbench" / "compare.py",
             ROOT / "gnnbench" / "costs.py",
             *sorted((ROOT / "gnnbench" / "reference").glob("*.py"))]


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return {m.split(".")[0] for m in eval(out.stdout.strip().splitlines()[-1])}


def test_a_run_loads_no_jax():
    top = _loaded_after(
        "import sys; sys.path[:0] = ['src']\n"
        "import torch; torch.set_num_threads(2)\n"
        "from gnnbench.harness import Cell, forbidden_modules, run_cell\n"
        "cell = Cell.find('gat-products-train', overrides={'graph': {'num_nodes': 2048,"
        " 'block_size': 512}})\n"
        "res, *_ = run_cell(cell, 3, 0.1, True, 'cpu')\n"
        "assert res['correct'] and forbidden_modules() == []\n")
    assert "repro_torch" in top and not top & BANNED


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded_after("import gnnbench.graph, gnnbench.compare, gnnbench.costs, "
                        "gnnbench.reference.gat, gnnbench.reference.gcn")
    assert not top & (BANNED | {"repro_torch"})
    for path in REFERENCE:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {n.split(".")[0] for n in names} & (BANNED | {"repro_torch"}), path
