"""The GCN (SpMM) aggregation kernel's share of its roofline in a training run:
the least time of the work that every one of its calls in the window asks
for, over the device time of the kernels that do it.

A call is one chunk's GCN layer (a run of back-to-back launches, one per
degree bucket), and each asks for that layer's forward aggregation over that
chunk, whether the step runs it as the stage's forward or as its recompute
in the backward. The window's calls over the calls of one forward pass
(``work``'s ``calls``: chunks x GCN layers) count the forward passes' work
the kernels did, so an engine that recomputes less moves their time and
their work together, and this share with neither. The least time of a
pass's work is its operations at the fp32 rate or its bytes at the memory
rate, whichever is longer."""

from gnnbench.costs import least_seconds

UNIT = "%"
LAYER = "Kernels"
MOVES = "train_step_s"
KERNELS = ("spmm_kernel",)  # device kernel names, matched as parts
WORK = "spmm_agg"


def read(r):
    if r.window.busy_s <= 0 or r.peaks is None or WORK not in r.work:
        return None
    spent, calls = r.window.seconds_of(KERNELS), r.window.calls_of(KERNELS)
    if spent <= 0 or calls == 0:
        return None
    ops, nbytes, pass_calls = r.work[WORK]
    return 100.0 * least_seconds(ops, nbytes, r.peaks) * (calls / pass_calls) / spent
