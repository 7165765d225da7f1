"""The traced window: ``torch.profiler`` around the window, the device's
activity read from its events, and what the per-layer readers see.

The harness names its own host spans (``span``): plan build, layout,
capture, each step or pass, and the window itself. In a traced run they are
``record_function`` ranges, so they share the profiler's clock with the
device's kernels, copies and sets. Busy time is the union of the device's
activity inside the window (interval arithmetic copied from the program's
``core/overlap_report.py`` ``_union``); an idle gap is named by the host span
that was open at its middle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

WINDOW = "gnnbench.window"
PREFIX = "gnnbench."
MARGIN_S = 0.5  # the profiler keeps only device records stamped inside its pass


def union(intervals: list) -> list:
    """Union of (start, end) intervals as a sorted disjoint list."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


class Spans:
    """The harness's host spans: ``record_function`` ranges when tracing."""

    def __init__(self, traced: bool):
        self.traced = traced

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.traced:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            yield


@contextlib.contextmanager
def profiled(on_card: bool):
    """A profiler pass (CPU and, on a card, CUDA activity) opened and closed
    ``MARGIN_S`` around what runs inside; yields a list that receives the
    pass's events when it closes."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    got: list = []
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(MARGIN_S)
        yield got
        time.sleep(MARGIN_S)
    got.extend(prof.profiler.kineto_results.events())


@dataclasses.dataclass
class Window:
    """The traced window's device activity: ``device`` holds (name, start,
    end) in seconds, clipped to the window; ``spans`` the harness's host
    spans inside it."""

    window_s: float
    busy_s: float
    device: list
    spans: list
    gaps: list  # (start, end) of idle stretches

    @classmethod
    def from_events(cls, events) -> "Window":
        # the profiler mirrors each host range on the device's timeline; only
        # kernels, copies and sets count as the device's work
        on_card = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.name().startswith(PREFIX)]
        host = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU
                and e.name().startswith(PREFIX)]
        windows = [e for e in host if e.name() == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} window spans, not one")
        ws = windows[0].start_ns() * 1e-9
        we = ws + windows[0].duration_ns() * 1e-9
        device = []
        for e in on_card:
            s = e.start_ns() * 1e-9
            t = s + e.duration_ns() * 1e-9
            if t > ws and s < we:
                device.append((e.name(), max(s, ws), min(t, we)))
        busy = union([(s, t) for _, s, t in device])
        edges = [ws] + [x for iv in busy for x in iv] + [we]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = [(e.name()[len(PREFIX):], e.start_ns() * 1e-9,
                  (e.start_ns() + e.duration_ns()) * 1e-9) for e in host if e.name() != WINDOW]
        return cls(window_s=we - ws, busy_s=sum(t - s for s, t in busy), device=device,
                   spans=spans, gaps=gaps)

    def seconds_of(self, parts) -> float:
        """Device seconds of the operations whose name holds any of ``parts``."""
        return sum(t - s for name, s, t in self.device if any(p in name for p in parts))

    def calls_of(self, parts) -> int:
        """Runs of back-to-back kernels whose names hold any of ``parts``,
        no other kernel between them (copies and sets do not part a run):
        one call of an aggregation that launches once per degree bucket."""
        kernels = sorted((s, any(p in name for p in parts)) for name, s, _ in self.device
                         if not name.startswith(("Memcpy", "Memset")))
        return sum(hit and not (i and kernels[i - 1][1]) for i, (_, hit) in enumerate(kernels))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by the host span open at their middle."""
        by_name: dict = {}
        for name, s, t in self.device:
            by_name[name] = by_name.get(name, 0.0) + (t - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

        def doing(mid):
            open_ = [(s, name) for name, s, t in self.spans if s <= mid < t]
            return max(open_)[1] if open_ else "outside any span"

        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[name[:200], sec] for name, sec in ops],
                "idle_gaps": [[doing((s + t) / 2), t - s] for s, t in gaps]}
