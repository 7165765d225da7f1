"""The port stands alone: no module under ``src/repro_torch/``, no script of
``examples/torch/``, and not ``chip_smoke.py``, imports ``jax`` or the JAX
package ``repro``; and every port module imports with ``torch`` alone."""

import ast
import importlib
import pkgutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples" / "torch").glob("*.py")) + [ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    assert "import_module" not in path.read_text() or path.name == "chip_smoke.py"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"serve_gnn.py", "pipeline.py", "kernel.py", "chip_smoke.py", "train.py",
            "schedule.py", "microbatch.py", "optimizer.py", "loop.py"} <= names
    port = ROOT / "src" / "repro_torch"
    assert (port / "kernels" / "gat_edge" / "csrc" / "gat_edge.cu").exists()
    assert (port / "kernels" / "spmm" / "csrc" / "spmm.cu").exists()
    assert (port / "launch" / "train.py").exists()
    assert (port / "kernels" / "flash" / "csrc" / "flash.cu").exists()
    assert (port / "kernels" / "ssd" / "csrc" / "ssd.cu").exists()
    assert (port / "launch" / "serve.py").exists()
    assert (port / "launch" / "dryrun.py").exists()
    assert (port / "roofline" / "render.py").exists()
    assert (port / "roofline" / "counter.py").exists()
    assert {"quickstart.py", "pipeline_parallel_gnn.py", "scaling_larger_graphs.py",
            "serve_batched.py", "lm_pretrain.py"} <= names


def test_every_port_module_imports():
    import repro_torch

    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    assert {"repro_torch.launch.serve_gnn", "repro_torch.launch.train",
            "repro_torch.kernels.spmm.ops", "repro_torch.core.schedule",
            "repro_torch.launch.serve", "repro_torch.models.transformer.model",
            "repro_torch.kernels.flash.ops", "repro_torch.kernels.ssd.ops"} <= set(names)
    for name in names:
        importlib.import_module(name)
