"""The numbers that decide ``correct``: the program's outputs held to the
plain reference's (``gnnbench.reference``), each against a limit of its own
(``gnnbench/limits/<cell>.json``).

Training (the reference follows the first three steps from the same
weights, graph and dropout keys):

* ``loss_gap``: the largest gap of a step's loss, over the reference's.
* ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step, over ``1 - b1``), by its worst leaf: the gap
  between the program's norm of the leaf and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is larger.
* ``change_gap``: the parameters' change over the three steps, by its worst
  leaf, measured the same way. Leaves whose first reference gradient is
  under ``QUIET`` of the median leaf's are left out: their gradient is
  nought to rounding (a GAT's source-score vector under the softmax), so
  Adam moves them by round-off alone.
"""

from __future__ import annotations

import statistics

import torch

QUIET = 1e-3


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def worst_leaf(got: dict, want: dict, leaves=None) -> float:
    """The largest ``|‖got‖ - ‖want‖|`` of a leaf over ``max(‖want‖ of the
    leaf, the median leaf's ‖want‖)``."""
    leaves = list(want) if leaves is None else list(leaves)
    g, w = _norms({k: got[k] for k in leaves}), _norms({k: want[k] for k in leaves})
    scale = statistics.median(w.values())
    return max(abs(g[k] - w[k]) / max(w[k], scale, 1e-30) for k in leaves)


def train_gaps(got: dict, want: dict, p0: dict) -> dict:
    """``got``: the program's ``losses`` (each checked step's), ``grad1``
    (leaf -> first gradient) and ``change`` (leaf -> p3 - p0); ``want``: the
    reference's ``train_steps`` record from ``p0``."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"], strict=True)]
    g1 = want["grads"][0]
    g1_norms = _norms(g1)
    median = statistics.median(g1_norms.values())
    moving = [k for k, n in g1_norms.items() if n >= QUIET * median]
    change = {k: v - p0[k] for k, v in want["params"][-1].items()}
    return {
        "loss_gap": max(losses),
        "grad_gap": worst_leaf(got["grad1"], g1),
        "change_gap": worst_leaf(got["change"], change, moving),
    }

