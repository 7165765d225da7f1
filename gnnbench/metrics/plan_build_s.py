"""Seconds the program's ``streamed_plan`` took to chunk and pad the drawn
graph on the host: the plan's own ``rebuild_seconds``."""

UNIT = "s"
LAYER = "Graph / plan"
MOVES = "setup_s"


def read(r):
    return r.plan_build_s
