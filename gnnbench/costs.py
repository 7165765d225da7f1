"""The yardstick's constants and arithmetic: the chips' peak rates, and the
sum and least time of the work a model needs. What each kind of model needs
in a forward pass is counted by ``work`` in its reference,
``gnnbench/reference/<kind>.py``, from the model's shapes and the graph's
live edges, never from the program, after the arithmetic of the program's
``roofline/stage_report.py`` ``_layer_roof``: an aggregation's bytes are each
input read once and each output written once. A training step's FLOPs are
three forward passes (the backward as twice the forward), without recompute,
as ``6·N·D`` counts a language model's step.
"""

from __future__ import annotations

F32 = 4

# NVIDIA H100 data sheet, SXM part (the 80 GB HBM3 card's device name):
# float32 outside the tensor cores, HBM3 bandwidth
PEAKS = {"NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bw": 3.35e12}}


def add(total: dict, part: dict) -> None:
    """Add ``part`` into ``total``, numbers and tuples of numbers alike."""
    for k, v in part.items():
        if isinstance(v, tuple):
            old = total.get(k, (0,) * len(v))
            total[k] = tuple(a + b for a, b in zip(old, v, strict=True))
        else:
            total[k] = total.get(k, 0) + v


def least_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    """The larger of operations over the fp32 rate and bytes over the memory rate."""
    return max(ops / peaks["fp32_flops"], nbytes / peaks["hbm_bw"])
