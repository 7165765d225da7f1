"""Profiling-driven stage partitioning for the GNN pipeline.

Counterpart of ``repro.core.costmodel``. The paper's Fig 3 runtime model
(and ``Schedule.predicted_step_time``'s default) assumes every stage costs
``total / num_stages``, but real GNN stacks are heterogeneous (a 1433-wide
input conv next to an 8-wide hidden conv, attention next to dropout), so
the slowest stage sets the pipeline tick. This module supplies the
cost-aware partition:

  * ``profile_layer_costs`` — measure each ``SeqLayer``'s forward,
    input-grad (B) and weight-grad (W) cost on a representative padded
    chunk, on the device the chunk lives on;
  * ``choose_balance`` — enumerate contiguous layer->stage groupings and
    pick the one minimizing the target schedule's weighted makespan
    (``predicted_step_time(stage_fwd_costs=..., stage_bwd_costs=...)``);
  * ``uniform_balance`` — the layer-count split the profiled partition is
    measured against.

The output is an ordinary ``balance`` tuple, so the partitioner composes
with every engine, schedule and ``Placement`` unchanged: partitioning moves
layer boundaries, never the math.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import os
import time

import torch

from repro_torch.graphs.data import GraphBatch
from repro_torch.models.gnn.net import GNNModel
from repro_torch.train.loop import synchronize


# eq=False: cost tables are measurement artifacts — identity semantics keep
# accidental == out of test assertions.
@dataclasses.dataclass(frozen=True, eq=False)
class LayerCosts:
    """Measured per-layer per-chunk costs (seconds) on one padded chunk.

    ``bwd`` is the fused backward — one autograd pass producing both grads,
    what the fused-``bwd`` schedules execute. It is measured directly, not
    summed from the halves: each split half re-runs the layer's forward, so
    ``bwd_b + bwd_w`` carries two forwards where the fused pass carries one
    (the halves match the zb-h1 execution, which re-materializes per half).
    """

    names: tuple[str, ...]
    fwd: tuple[float, ...]
    bwd: tuple[float, ...]  # fused backward: one pass, both grads
    bwd_b: tuple[float, ...]  # input-grad half (the pipeline's critical path)
    bwd_w: tuple[float, ...]  # weight-grad half (deferred by zb-h1)

    def _check_balance(self, balance: tuple[int, ...]):
        if sum(balance) != len(self.names):
            raise ValueError(
                f"balance {balance} must sum to {len(self.names)} layers"
            )

    def stage_costs(self, balance: tuple[int, ...]):
        """(stage_fwd_costs, stage_bwd_costs) for a contiguous ``balance``
        grouping: each stage's cost is the sum of its member layers'."""
        self._check_balance(balance)
        f, b, lo = [], [], 0
        for n in balance:
            f.append(sum(self.fwd[lo : lo + n]))
            b.append(sum(self.bwd[lo : lo + n]))
            lo += n
        return f, b

    def stage_costs_split(self, balance: tuple[int, ...]):
        """(fwd, bwd_b, bwd_w) per-stage sums — the measured B/W halves the
        zero-bubble makespan weights separately."""
        self._check_balance(balance)
        f, b, w, lo = [], [], [], 0
        for n in balance:
            f.append(sum(self.fwd[lo : lo + n]))
            b.append(sum(self.bwd_b[lo : lo + n]))
            w.append(sum(self.bwd_w[lo : lo + n]))
            lo += n
        return f, b, w

    def table(self) -> list[dict]:
        """The per-layer cost table (CLI printout)."""
        return [
            {
                "layer": i,
                "name": self.names[i],
                "fwd_s": self.fwd[i],
                "bwd_s": self.bwd[i],
                "bwd_b_s": self.bwd_b[i],
                "bwd_w_s": self.bwd_w[i],
            }
            for i in range(len(self.names))
        ]


def _time_best_of(fn, device: torch.device, *, repeats: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    synchronize(device)
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def profile_layer_costs(
    model: GNNModel,
    params: list,
    graph: GraphBatch,
    *,
    rng: int | None = None,
    train: bool = True,
    repeats: int = 3,
    warmup: int = 1,
) -> LayerCosts:
    """Measure fwd / input-grad / weight-grad cost of every ``SeqLayer`` on
    ``graph`` (one representative padded chunk, the shape the engines
    dispatch per tick, so stage sums predict per-tick stage costs), on the
    device ``graph`` and ``params`` live on.

    Each layer runs eagerly: the forward is its ``apply`` without autograd;
    the fused backward is one ``torch.autograd.grad`` with respect to the
    params and the input together, B with respect to the input only, W with
    respect to the params only, each re-running the layer's forward as the
    reference's ``jax.vjp`` does (a parameter-free layer's W is that
    forward alone, as the engine's W half runs it). A time is the host wall
    clock from one device synchronize to the next, the best of ``repeats``
    after ``warmup`` discarded runs: the reference's semantics. Wall clock,
    not CUDA events, because the host engine's ticks are partly host-bound
    on a card, and device time alone would underprice them.
    """
    rng = 0 if rng is None else rng
    device = graph.features.device
    fwd_s, bwd_s, b_s, w_s = [], [], [], []
    h = graph.features
    for layer, p in zip(model.layers, params):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        flat = list(leaves.values())
        x = h.detach().requires_grad_(True)

        def fwd(layer=layer, p=p, h=h):
            with torch.no_grad():
                return layer.apply(p, graph, h, rng, train)

        y = fwd()
        ct = torch.ones_like(y)

        def pull(want_params, want_input, layer=layer, p=p, h=h, leaves=leaves, flat=flat, x=x,
                 ct=ct):
            wrt = (flat if want_params else []) + ([x] if want_input else [])
            with torch.enable_grad():
                y = layer.apply(leaves if want_params else p, graph, x if want_input else h,
                                rng, train)
                if wrt:
                    torch.autograd.grad(y, wrt, ct, allow_unused=True)

        def timed(fn):
            return _time_best_of(fn, device, repeats=repeats, warmup=warmup)

        fwd_s.append(timed(fwd))
        bwd_s.append(timed(lambda: pull(True, True)))
        b_s.append(timed(lambda: pull(False, True)))
        w_s.append(timed(lambda: pull(True, False)))
        h = y
    return LayerCosts(
        names=tuple(layer.name for layer in model.layers),
        fwd=tuple(fwd_s),
        bwd=tuple(bwd_s),
        bwd_b=tuple(b_s),
        bwd_w=tuple(w_s),
    )


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def profile_fingerprint(model, params, graph, backend: str = "padded") -> str:
    """The cache key a profile is stored under: a digest of the device's
    name, the model's layer stack (names + every param leaf's shape and
    dtype name), the chunk shape the engines dispatch per tick, and the
    aggregation backend. The device and the ``framework`` entry keep it
    apart from every key the JAX package writes for the same (model, chunk,
    backend): a sidecar from another framework or card is never read as
    this card's costs."""
    spec = {
        "framework": "torch",
        "device": _device_name(graph.features.device),
        "layers": [layer.name for layer in model.layers],
        "params": [
            [(list(p[k].shape), str(p[k].dtype).removeprefix("torch.")) for k in sorted(p)]
            for p in params
        ],
        "chunk": [
            list(graph.features.shape),
            list(graph.neighbors.shape),
        ],
        "backend": backend,
    }
    return hashlib.sha1(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]


# in-process profile cache: fingerprint -> LayerCosts. One sweep (the --auto
# planner's chunk ladder) profiles each shape once.
_PROFILE_CACHE: dict[str, LayerCosts] = {}

_FIELDS = ("names", "fwd", "bwd", "bwd_b", "bwd_w")


def cached_profile_layer_costs(
    model,
    params,
    graph,
    *,
    backend: str = "padded",
    cache_path: str | None = None,
    refresh: bool = False,
    **profile_kwargs,
) -> LayerCosts:
    """``profile_layer_costs`` behind a two-level cache keyed by
    ``profile_fingerprint``:

      * an in-process dict, so ``--auto`` and ``--partition profiled``
        never re-profile the same shape within a run;
      * an optional JSON sidecar at ``cache_path``, so a sweep reuses
        measurements across processes.

    ``refresh=True`` bypasses both reads (the write still lands, replacing
    the stale entry). Corrupt or unreadable sidecars are ignored: the
    profiler is the fallback."""
    key = profile_fingerprint(model, params, graph, backend)
    if not refresh:
        hit = _PROFILE_CACHE.get(key)
        if hit is not None:
            return hit
        if cache_path and os.path.exists(cache_path):
            try:
                with open(cache_path) as f:
                    entry = json.load(f).get(key)
            except (OSError, json.JSONDecodeError):
                entry = None
            if entry is not None:
                costs = LayerCosts(**{k: tuple(entry[k]) for k in _FIELDS})
                _PROFILE_CACHE[key] = costs
                return costs
    costs = profile_layer_costs(model, params, graph, **profile_kwargs)
    _PROFILE_CACHE[key] = costs
    if cache_path:
        store: dict = {}
        if os.path.exists(cache_path):
            try:
                with open(cache_path) as f:
                    store = json.load(f)
            except (OSError, json.JSONDecodeError):
                store = {}
        store[key] = {k: list(getattr(costs, k)) for k in _FIELDS}
        parent = os.path.dirname(cache_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{cache_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(store, f, indent=1, sort_keys=True)
        os.replace(tmp, cache_path)
    return costs


def uniform_balance(n_layers: int, num_stages: int) -> tuple[int, ...]:
    """The layer-count-balanced contiguous split (earlier stages take the
    remainder) — the baseline the profiled partition is measured against."""
    if not 1 <= num_stages <= n_layers:
        raise ValueError(f"need 1 <= num_stages <= {n_layers}, got {num_stages}")
    base, rem = divmod(n_layers, num_stages)
    return tuple(base + (1 if s < rem else 0) for s in range(num_stages))


def enumerate_balances(n_layers: int, num_stages: int):
    """All contiguous groupings of ``n_layers`` into ``num_stages`` non-empty
    stages, as balance tuples (C(n-1, S-1) of them)."""
    for cuts in itertools.combinations(range(1, n_layers), num_stages - 1):
        bounds = (0, *cuts, n_layers)
        yield tuple(bounds[i + 1] - bounds[i] for i in range(num_stages))


def predicted_balance_time(
    costs: LayerCosts,
    balance: tuple[int, ...],
    schedule,
    num_chunks: int,
    *,
    transfer_cost: float = 0.0,
) -> float:
    """``schedule``'s weighted makespan under ``costs`` grouped by
    ``balance`` (seconds per step, rebuild excluded). Zero-bubble schedules
    get the measured B/W halves instead of the 50/50 fallback split."""
    from repro_torch.core.schedule import ZeroBubbleH1Schedule

    if isinstance(schedule, ZeroBubbleH1Schedule):
        f, b, w = costs.stage_costs_split(balance)
        return schedule.predicted_step_time(
            len(balance),
            num_chunks,
            stage_fwd_costs=f,
            stage_bwd_b_costs=b,
            stage_bwd_w_costs=w,
            transfer_cost=transfer_cost,
        )
    f, b = costs.stage_costs(balance)
    return schedule.predicted_step_time(
        len(balance),
        num_chunks,
        stage_fwd_costs=f,
        stage_bwd_costs=b,
        transfer_cost=transfer_cost,
    )


def choose_balance(
    costs: LayerCosts,
    num_stages: int,
    schedule,
    num_chunks: int,
    *,
    transfer_cost: float = 0.0,
    max_candidates: int = 100_000,
) -> tuple[tuple[int, ...], float]:
    """The contiguous balance minimizing ``schedule``'s weighted makespan
    under the measured costs. Exhaustive over the C(n-1, S-1) candidates
    (ties break toward the uniform split, then lexicographically);
    ``max_candidates`` guards the combinatorial cliff with a clear error.
    Returns (balance, predicted_step_seconds)."""
    n = len(costs.names)
    n_cand = math.comb(n - 1, num_stages - 1)
    if n_cand > max_candidates:
        raise ValueError(
            f"{n_cand} candidate partitions of {n} layers into {num_stages} "
            f"stages exceeds max_candidates={max_candidates}"
        )
    uniform = uniform_balance(n, num_stages)
    best: tuple | None = None
    for bal in enumerate_balances(n, num_stages):
        t = predicted_balance_time(
            costs, bal, schedule, num_chunks, transfer_cost=transfer_cost
        )
        cand = (t, bal != uniform, bal)
        if best is None or cand < best:
            best = cand
    if best is None:
        raise ValueError(f"no balance of {n} layers into {num_stages} stages")
    return best[2], best[0]
