"""Device milliseconds a step spends on the neighbor gather's gradient: the
index-put that autograd runs for the plain backward's gathers, and the sort
it launches."""

UNIT = "ms"
LAYER = "Model backward"
MOVES = "train_step_s"
KERNELS = ("indexing_backward_kernel", "RadixSort")  # device kernel names, matched as parts


def read(r):
    if r.window.busy_s <= 0 or r.units == 0:
        return None
    return 1e3 * r.window.seconds_of(KERNELS) / r.units
