"""One run of one cell: set-up, the measured window, the traced readings and
the comparison that decides ``correct``.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix. The harness finds each by its name:
``gnnbench/configs/<config>.json`` (the model, its optimizer, its graph's
shape, its pipeline, and the program builder that makes it),
``gnnbench/traffic/<traffic>.json`` (how the graph is drawn and split),
``gnnbench/limits/<cell>.json`` (the limit of each
compared number), the plain reference of the model's kind
``gnnbench/reference/<kind>.py`` (with the work its model needs) and each
per-layer metric's reader ``gnnbench/metrics/<metric>.py``. A cell made of new files of these kinds
runs without an edit here.

What a run does, in order:

1. Set-up (``setup_s``, from the process's start): the traffic's graph is
   drawn (``gnnbench.graph``); the program chunks and pads it
   (``graphs.streamed_plan``, through the dataset interface it reads), the
   compiled engine lays it out on the card, and the weights are drawn on the
   card from the seed. Set-up drives the engine's ``train_step`` from the
   seed through its first three steps (the first captures the step's CUDA
   graph).
2. The window: training steps, each to a device synchronize, until one ends
   past ``--seconds``; ``train_step_s`` is the window's time over its steps.
   With ``--trace 1`` the window runs under the profiler and the per-layer
   readers take their numbers from it.
3. ``peak_mem_gb``: the allocator's peak over the whole run. Then the
   program's state is freed and the plain reference, which works the chunks
   out again from the drawn graph, follows the first three steps:
   ``compare`` holds the program's outputs to it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from gnnbench import compare, costs
from gnnbench.graph import Traffic
from gnnbench.reference import common as ref
from gnnbench.trace import Spans, Window, profiled

ROOT = Path(__file__).resolve().parents[1]
CHECKED_STEPS = 3  # the training steps the reference follows


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """What one ``workloads`` entry asks for, with every file it names read."""

    name: str
    chips: int
    config: dict
    traffic: Traffic
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1
    readers: dict  # per-layer metric name -> its reader module
    reference: object  # the plain reference module of the model's kind

    @classmethod
    def find(cls, name: str, root: Path = ROOT, overrides: dict | None = None) -> "Cell":
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
        w = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        config = json.loads((root / configs[w["config"]]["file"]).read_text())
        traffic = Traffic.load(root / "gnnbench" / "traffic" / f"{w['traffic']}.json", config,
                               overrides)

        def ours(metric):
            return name in metric.get("workloads", [name])

        e2e = [m for m in bench["end_to_end"] if ours(m)]
        e2e_names = {m["name"] for m in e2e}
        per_layer = [m for m in bench["per_layer"]
                     if m["moves"] in e2e_names and ours(m)]
        readers = {m["name"]: load_module(root / "gnnbench" / "metrics" / f"{m['name']}.py",
                                          "gnnbench_metric_" + m["name"].replace(".", "_"))
                   for m in per_layer}
        kind = config["kind"]
        reference = load_module(root / "gnnbench" / "reference" / f"{kind}.py",
                                f"gnnbench_reference_{kind}")
        limits = json.loads((root / "gnnbench" / "limits" / f"{name}.json").read_text())
        return cls(name, int(w["chips"]), config, traffic, limits, e2e, per_layer, readers,
                   reference)


def process_age_s() -> float:
    """Seconds since this process started (``/proc``'s clock ticks)."""
    import os

    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------- the program --

def port_dataset(graph):
    """The drawn graph behind the dataset interface the program's
    ``streamed_plan`` reads (``chunk_ranges``, ``chunk_edges``,
    ``chunk_batch``): the program's own streamed-graph class, its blocks
    served from the benchmark's draw. Chunking and padding stay the
    program's."""
    from repro_torch.graphs.datasets import StreamedPowerlaw

    class Drawn(StreamedPowerlaw):
        def generate_block(self, block):
            return graph.block(block)

    return Drawn(name=graph.name, num_nodes=graph.num_nodes, num_features=graph.num_features,
                 num_classes=graph.num_classes, zipf_a=graph.zipf_a, deg_cap=graph.deg_cap,
                 seed=graph.seed, block_size=graph.block_size, p_intra=graph.p_intra)


def build_program(cell: Cell, device: torch.device):
    """The configuration's model and the compiled engine that runs it."""
    from repro_torch.core.pipeline import GPipeConfig, make_engine
    from repro_torch.models.gnn import net

    prog, pipe_cfg, g = cell.config["program"], cell.config["pipeline"], cell.traffic.graph
    builder = getattr(net, prog["builder"])
    model = builder(*prog.get("args", []), g["num_features"], g["num_classes"],
                    backend="kernel", **prog.get("kwargs", {}))
    engine = make_engine(model, GPipeConfig(
        balance=tuple(pipe_cfg["balance"]), chunks=cell.traffic.chunks,
        schedule=pipe_cfg["schedule"], engine="compiled", backend="kernel", device=str(device)))
    return model, engine


def host_copy(tree):
    from repro_torch.core.cuda_graph import map_tensors

    return map_tensors(lambda t: t.detach().to("cpu", copy=True), tree)


@dataclasses.dataclass
class Run:
    """What a run measured and what its program produced for the check."""

    units: int = 0  # steps or passes in the window
    window_s: float = 0.0
    setup_s: float = 0.0
    plan_build_s: float = 0.0
    peak_bytes: int = 0
    failed: int = 0
    trace: Window | None = None
    judged: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)  # set-up span -> host seconds


def _timed(run: Run, spans: Spans, name: str, device, fn):
    t0 = time.perf_counter()
    with spans(name):
        out = fn()
        synchronize(device)
    run.spans[name] = run.spans.get(name, 0.0) + time.perf_counter() - t0
    return out


def _set_up(cell: Cell, seed: int, device, run: Run, spans: Spans, drawn: dict | None = None):
    from repro_torch.graphs import streamed_plan

    drawn = {} if drawn is None else drawn  # the graph and plan of a cell, kept across seeds
    if not drawn:
        drawn["graph"] = _timed(run, spans, "graph", device,
                                lambda: cell.traffic.make_graph().draw())
        drawn["plan"] = _timed(run, spans, "plan_build", device, lambda: streamed_plan(
            port_dataset(drawn["graph"]), cell.traffic.chunks,
            max_degree=cell.traffic.max_degree))
    graph, plan = drawn["graph"], drawn["plan"]
    run.plan_build_s = plan.rebuild_seconds
    model, engine = build_program(cell, device)
    layout = _timed(run, spans, "layout", device, lambda: engine.layout(plan.stacked().graph))
    params = cell.reference.make_params(cell.config, seed, device)
    run.judged["p0"] = host_copy(params)
    return graph, plan, engine, layout, params


def train_setup(cell: Cell, seed: int, device, run: Run, spans: Spans,
                drawn: dict | None = None):
    """Set-up of a training cell, through the three steps the reference
    follows (the first captures the step's graph): ``(graph, engine, plan,
    (params, optimizer state), optimizer)``. ``drawn`` keeps the graph and
    the program's plan for another seed's set-up (``gnnbench.control``)."""
    from repro_torch.train import optimizer as opt_lib

    graph, plan, engine, _, params = _set_up(cell, seed, device, run, spans, drawn)
    cfg = cell.config
    opt = opt_lib.adam(cfg["lr"], weight_decay=cfg["weight_decay"])
    state = (params, opt.init(params))
    losses = []
    for i in range(CHECKED_STEPS):
        p, s, loss = _timed(run, spans, "capture" if i == 0 else "step", device,
                            lambda: engine.train_step(*state, plan, ref.step_key(seed, i), opt))
        losses.append(float(loss))
        if i == 0:
            run.judged["mu1"] = host_copy(s.mu)
        state = (p, s)
    run.judged["p3"] = host_copy(state[0])
    run.judged["losses"] = losses
    return graph, engine, plan, state, opt


def _train(cell: Cell, seed: int, seconds: float, device, run: Run, spans: Spans, traced):
    graph, engine, plan, state, opt = train_setup(cell, seed, device, run, spans)
    window_losses = []
    run.setup_s = process_age_s()
    with traced() as events:
        with spans("window"):
            t0 = time.perf_counter()
            while True:
                with spans("step"):
                    p, s, loss = engine.train_step(*state, plan,
                                                   ref.step_key(seed, CHECKED_STEPS + run.units),
                                                   opt)
                    window_losses.append(loss.clone())
                    synchronize(device)
                state = (p, s)
                run.units += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            run.window_s = time.perf_counter() - t0
    run.failed = sum(not math.isfinite(float(x)) for x in window_losses)
    return graph, events


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device):
    """One run: ``(the result object, the compared numbers' lines, lines on
    where the run's time went)``."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    run = Run()
    spans = Spans(trace)

    def traced():
        return profiled(on_card) if trace else contextlib.nullcontext([])

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    graph, events = _train(cell, seed, seconds, device, run, spans, traced)
    if trace:
        run.trace = Window.from_events(events)
        del events
    if on_card:
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    gc.collect()  # the program's engine, plan and layout go with the drive's frame
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    graphs = ref.chunk_graphs(graph, cell.traffic, device)
    checks = judge(cell, seed, run, graphs, device)
    check_s = time.perf_counter() - t0
    correct = all(math.isfinite(v) and v <= cell.limits[k] for k, v in checks.items())
    result = {
        "correct": bool(correct and run.failed == 0),
        "attempted": run.units,
        "failed": run.failed,
        "metrics": measured(cell, run, graphs, device) if trace else end_to_end(cell, run),
        "device": device_record(device, run),
    }
    if trace:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": cell.limits[k]} for k, v in checks.items()}
    lines = [f"check {k} {v!r} limit {cell.limits[k]!r}" for k, v in checks.items()]
    spent = ", ".join(f"{k} {v:.3f} s" for k, v in run.spans.items())
    info = [f"set-up {run.setup_s:.2f} s: {spent}; window {run.window_s:.3f} s, "
            f"{run.units} steps; "
            f"reference and check {check_s:.3f} s"]
    return result, lines, info


def judge(cell: Cell, seed: int, run: Run, graphs, device) -> dict:
    """The compared numbers: the program's outputs held to the reference."""
    cfg, model = cell.config, cell.reference
    p0 = {k: v.to(device) for k, v in ref.flat(run.judged["p0"]).items()}
    want = ref.train_steps(model, p0, graphs, cfg, seed, CHECKED_STEPS)
    got = {
        "losses": run.judged["losses"],
        "grad1": {k: v.to(device) / (1 - ref.Adam(0.0).b1)
                  for k, v in ref.flat(run.judged["mu1"]).items()},
        "change": {k: run.judged["p3"][int(k.split(".")[0])][k.split(".")[1]].to(device) - v
                   for k, v in p0.items()},
    }
    return compare.train_gaps(got, want, p0)


def end_to_end(cell: Cell, run: Run) -> dict:
    values = {
        "train_step_s": run.window_s / run.units,
        "peak_mem_gb": run.peak_bytes / 1e9,
        "setup_s": run.setup_s,
    }
    out = {}
    for m in cell.end_to_end:
        value = values.get(m["name"])
        if value is None:
            raise ValueError(f"cell {cell.name} lists {m['name']}, which a "
                             "training run does not measure")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the traced window, the work the model
    needs in one forward pass over every chunk (its reference's ``work``),
    the card's peaks, the run."""

    units: int
    window: Window
    work: dict
    peaks: dict | None
    plan_build_s: float


def measured(cell: Cell, run: Run, graphs, device) -> dict:
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else None
    reading = Reading(run.units, run.trace,
                      cell.reference.work(cell.config, graphs), costs.PEAKS.get(name),
                      run.plan_build_s)
    if device.type == "cuda" and reading.peaks is None:
        raise KeyError(f"no peak rates for {name!r} in gnnbench/costs.py")
    out = {}
    for m in cell.per_layer:
        value = cell.readers[m["name"]].read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_record(device, run: Run) -> dict:
    on_card = device.type == "cuda"
    rec = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": run.peak_bytes,
    }
    if run.trace is not None:
        rec["busy_s"] = run.trace.busy_s
        rec["window_s"] = run.trace.window_s
    return rec


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: the program's name begins with it)."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in banned)
