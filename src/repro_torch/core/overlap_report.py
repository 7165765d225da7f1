"""Communication/compute overlap of one pipeline step, from a
``torch.profiler`` trace.

Counterpart of ``repro.core.overlap_report``. The double-buffered wires
(``GPipeConfig.overlap``; ``core.spmd_pipe``'s wire-parity rule) post each
tick's outputs on a wire stream of their own before the tick's work, so
the copy may run beside the work's kernels. Whether it does is the card's
call; this module measures it: trace one step, attribute device time to
communication and compute, and report the share of communication time that
ran under compute on the same device.

On one card the ring hop is a device-to-device copy. "Communication" is
every device event on the wire stream, and every NCCL kernel; "compute" is
every kernel on another stream. The wire stream is named by its id in the
trace: ``capture_overlap_report(step_fn, wire_stream=s)`` launches a probe
on ``s`` inside a ``record_function`` range (``WIRE_PROBE``) before and
after the step, and the streams that ran the probes' device work are the
wire (the probes' own events are then dropped). That holds for a step run eagerly, as the
compiled engine's program runs before its capture. A step captured as a
CUDA graph does not keep its streams: CUDA runs the graph's branches on
streams of its own, so the wire posts, the banks and the work's kernels
appear on streams that change along the step, and no stream id names the
wire. Without a wire stream, the report therefore counts every device copy
(category ``gpu_memcpy``: the posts, but also the banks, stash, gradient
and optimizer copies) and every NCCL kernel as communication: a
device-copy overlap, not the wire's.
Events are grouped per device (the trace's ``pid``), not per stream as the
reference groups its per-executor lanes: hiding a copy means another
stream of the same device computing meanwhile.

On ranks (``core.ranks``) the hop is NCCL's point-to-point kernel
(``SendRecv``) and the step runs eagerly: ``capture_rank_reports`` traces
one call on every rank (a GNN ring step, or an LM stage ring's train
step, prefill or decode steps), counts only the NCCL kernels as
communication (the banks and stash copies are the rank's own work), and
gathers the reports on rank 0, which prints them.

``capture_overlap_report(step_fn)`` traces one call of a step. It raises
when the profiler fails, when, with CUDA activity on, it records no device
event, or when the wire probe's stream cannot be found: it never returns
zeroed metrics in place of a trace.
The profiler loses device records in short passes made after CUDA-graph
captures unless CUPTI stays initialized (``DISABLE_CUPTI_LAZY_REINIT=1``,
``TEARDOWN_CUPTI=0`` in the environment before CUDA starts); each pass
therefore opens and closes ``PROFILE_MARGIN_S`` around the step.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
import time
from typing import Callable

import torch

PROFILE_MARGIN_S = 0.5
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WIRE_PROBE = "overlap_report.wire_probe"


def load_trace_events(path: str) -> list:
    """The events of the ``torch.profiler`` Chrome traces at ``path``: one
    trace file, or every ``*.json`` file of a directory. Raises when there
    is none or one cannot be read."""
    files = sorted(glob.glob(os.path.join(path, "*.json"))) if os.path.isdir(path) else [path]
    if not files:
        raise FileNotFoundError(f"no Chrome trace in {path}")
    events: list = []
    for name in files:
        with open(name) as f:
            events.extend(json.load(f)["traceEvents"])
    return events


def _union(intervals: list) -> list:
    """Union of (start, end) intervals as a sorted disjoint list."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _intersect_len(intervals: list, union: list) -> float:
    """Total length of ``intervals`` covered by the disjoint ``union``."""
    total = 0.0
    for s, e in intervals:
        for us, ue in union:
            if ue <= s:
                continue
            if us >= e:
                break
            total += min(e, ue) - max(s, us)
    return total


def _stream(ev: dict):
    return ev.get("args", {}).get("stream", ev.get("tid"))


def _is_nccl(ev: dict) -> bool:
    return ev["cat"] == "kernel" and "nccl" in ev.get("name", "").lower()


def probe_streams(events: list, probe: str = WIRE_PROBE) -> tuple[set, set]:
    """``(streams, correlations)`` of the device work launched inside the
    host ranges named ``probe``: the runtime calls on the range's thread
    within its span give the correlation ids, and the device events with
    those ids give the streams, as the trace numbers them."""
    spans = [(ev.get("pid"), ev.get("tid"), ev["ts"], ev["ts"] + ev.get("dur", 0))
             for ev in events if ev.get("name") == probe and ev.get("cat") == "user_annotation"]
    corr = {
        ev["args"]["correlation"]
        for ev in events
        if ev.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in ev.get("args", {})
        and any(pid == ev.get("pid") and tid == ev.get("tid") and lo <= ev["ts"] <= hi
                for pid, tid, lo, hi in spans)
    }
    work = [ev for ev in events if ev.get("cat") in DEVICE_CATEGORIES
            and ev.get("args", {}).get("correlation") in corr]
    return {_stream(ev) for ev in work}, {ev["args"]["correlation"] for ev in work}


def overlap_from_events(events: list, *, wire_streams=None) -> dict:
    """Attribute a trace's device time to communication vs compute and
    measure how much communication time ran under compute on the same
    device.

    Only device events count (categories ``kernel``, ``gpu_memcpy``,
    ``gpu_memset``; host-side events carry none of these). Communication
    is every device event on a stream of ``wire_streams`` (the trace's
    stream ids) and every NCCL kernel; with ``wire_streams`` None, every
    device copy and every NCCL kernel (module docstring). Compute is the
    other kernels, and among them only LEAF events, as in the reference:
    within one stream, an event that starts before its successor's start
    but ends after it contains it. Returns total microseconds per class,
    the overlapped microseconds, and ``overlap_fraction`` (0.0 when nothing
    was sent), with the reference's keys."""
    streams: dict = {}
    for ev in events:
        if ev.get("ph") != "X" or not ev.get("dur") or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        start = float(ev.get("ts", 0.0))
        if wire_streams is None:
            is_comm = ev["cat"] == "gpu_memcpy" or _is_nccl(ev)
        else:
            is_comm = _stream(ev) in wire_streams or _is_nccl(ev)
        streams.setdefault((ev.get("pid"), _stream(ev)), []).append(
            (start, start + float(ev["dur"]), is_comm, ev["cat"] == "kernel"))

    devices: dict = {}  # pid -> (communication spans, compute spans)
    for (pid, _), spans in streams.items():
        comm, comp = devices.setdefault(pid, ([], []))
        spans.sort(key=lambda x: (x[0], -x[1]))
        for i, (s, e, is_comm, is_kernel) in enumerate(spans):
            is_container = i + 1 < len(spans) and spans[i + 1][0] < e
            if is_comm:
                comm.append((s, e))
            elif is_kernel and not is_container:
                comp.append((s, e))

    comm_time = comp_time = hidden = 0.0
    n_comm = n_comp = 0
    for comm, comp in devices.values():
        n_comm += len(comm)
        n_comp += len(comp)
        comm_union = _union(comm)
        comm_time += sum(e - s for s, e in comm_union)
        comp_time += sum(e - s for s, e in _union(comp))
        hidden += _intersect_len(comm_union, _union(comp))
    return {
        "collective_time_us": comm_time,
        "compute_time_us": comp_time,
        "overlapped_time_us": hidden,
        "overlap_fraction": (hidden / comm_time) if comm_time > 0 else 0.0,
        "num_collective_events": n_comm,
        "num_compute_events": n_comp,
    }


def capture_overlap_report(
    step_fn: Callable[[], None],
    *,
    wire_stream: "torch.cuda.Stream | None" = None,
    trace_dir: str | None = None,
) -> dict:
    """Trace ONE call of ``step_fn`` and return its overlap report.

    ``step_fn`` runs one already-built step. With ``wire_stream`` (a step
    run eagerly, whose wire posts are issued on that stream), a probe on
    the stream names its id in the trace, and communication is what ran on
    it (``wire_streams`` in the report); without, a captured step's
    replay, communication is every device copy. The Chrome trace stays at
    ``trace_dir/overlap_trace.json`` (a fresh temp dir by default), named
    in the report's ``trace_dir``. The device is synchronized before and
    after the step when CUDA is available; the CUDA activity is then traced
    too, and a trace without a device event raises."""
    events, wire, out_dir = _trace(step_fn, wire_stream, trace_dir)
    report = overlap_from_events(events, wire_streams=wire)
    report["wire_streams"] = sorted(wire) if wire is not None else None
    report["trace_dir"] = out_dir
    return report


def capture_rank_reports(step_fn: Callable[[], None], *, trace_dir: str | None = None):
    """On ranks: every rank traces ONE call of its ``step_fn`` (each rank
    calls this at once, as its step's collectives need) and reports the
    overlap of its NCCL kernels with its compute (only NCCL kernels
    communicate), with its ``rank`` and the traced step's wall time
    ``step_us`` (device synchronized). Rank 0 gathers every rank's report
    and returns them in rank order, for it to print; the other ranks return
    None. Each rank's trace stays under ``trace_dir/rank<r>``."""
    import torch.distributed as dist

    rank = dist.get_rank()
    sub = None if trace_dir is None else os.path.join(trace_dir, f"rank{rank}")
    walls = []

    def timed():
        t0 = time.perf_counter()
        step_fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)

    events, _, out_dir = _trace(timed, None, sub)
    report = overlap_from_events(events, wire_streams=set())
    report.update(rank=rank, step_us=walls[0], trace_dir=out_dir)
    reports = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(report, reports, dst=0)
    return reports


def _trace(step_fn, wire_stream, trace_dir):
    """One traced call of ``step_fn``: ``(events, wire streams or None,
    trace directory)``, the wire probe's own events dropped."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out_dir = trace_dir or tempfile.mkdtemp(prefix="overlap_trace_")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "overlap_trace.json")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()

    def probe():
        if wire_stream is not None:
            with record_function(WIRE_PROBE), torch.cuda.stream(wire_stream):
                torch.zeros(1, device=wire_stream.device)
            torch.cuda.synchronize()

    with profile(activities=activities) as prof:
        if cuda:
            time.sleep(PROFILE_MARGIN_S)
        probe()
        step_fn()
        if cuda:
            torch.cuda.synchronize()
        probe()  # once more: the device records of a pass's first launches can be lost
        if cuda:
            time.sleep(PROFILE_MARGIN_S)
    prof.export_chrome_trace(path)
    events = load_trace_events(path)
    if cuda and not any(ev.get("cat") in DEVICE_CATEGORIES for ev in events):
        raise RuntimeError(f"the profiler recorded no device event for the step ({path})")
    wire = None
    if wire_stream is not None:
        wire, corr = probe_streams(events)
        if not wire:
            ranges = [(ev.get("cat"), ev["ts"], ev.get("dur"))
                      for ev in events if ev.get("name") == WIRE_PROBE]
            device = sorted(ev["ts"] for ev in events if ev.get("cat") in DEVICE_CATEGORIES)
            raise RuntimeError(
                f"the wire probe's device work is not in the trace ({path}): probe ranges "
                f"(category, start us, us) {ranges}, {len(device)} device events from "
                f"{device[0] if device else None} to {device[-1] if device else None} us")
        events = [ev for ev in events if ev.get("args", {}).get("correlation") not in corr]
    return events, wire, out_dir
