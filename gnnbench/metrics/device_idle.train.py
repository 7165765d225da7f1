"""Share of the traced window in which nothing ran on the card: no kernel,
copy or set (the union of the device's activity, over the window)."""

UNIT = "%"
LAYER = "Engine"
MOVES = "train_step_s"


def read(r):
    if r.window.busy_s <= 0 or r.window.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.window.busy_s / r.window.window_s)
