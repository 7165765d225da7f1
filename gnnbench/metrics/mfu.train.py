"""The whole step's share of the card's fp32 peak: the model's FLOPs a step
(its reference's ``work``'s ``model_fwd``, three times for forward and
backward, over live edges, without recompute) over the traced window's time a step."""

UNIT = "%"
LAYER = "Whole step"
MOVES = "train_step_s"
PASSES = 3  # forward passes' FLOPs a step


def read(r):
    if r.window.busy_s <= 0 or r.peaks is None or r.units == 0 or "model_fwd" not in r.work:
        return None
    flops = PASSES * r.work["model_fwd"] * r.units
    return 100.0 * flops / (r.window.window_s * r.peaks["fp32_flops"])
