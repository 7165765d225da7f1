import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# a few thousand nodes: every cell's path on the CPU, in seconds
SMALL = {"graph": {"num_nodes": 4096, "block_size": 512, "seed": 2**31 + 777}}
SEED = 2**31 + 12345  # past 32 signed bits: a run's seed may be that large


def find(name: str, **kwargs):
    """``Cell.find`` in this checkout."""
    from gnnbench.harness import Cell

    return Cell.find(name, **kwargs)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
