"""Self-tuning pipeline planner: one ``--auto`` knob resolves the rest.

Counterpart of ``repro.core.autotune``. ``plan_pipeline`` enumerates the
(schedule x chunk-count x balance x placement) space through
``profile_layer_costs`` / ``predicted_balance_time``, prunes candidates
whose peak live activations exceed the memory constraint, and picks the
argmin predicted step time:

    profile   — per-layer fwd/B/W costs on one representative padded chunk
                per candidate chunk count (the shape the engines dispatch
                per tick), on the card, through the cost model's cached
                profiler so a sweep never re-measures a shape;
    enumerate — schedule x chunk-count x balance x placement-rotation, in a
                deterministic order, capped by ``budget``;
    predict   — each candidate's weighted makespan through the schedule's
                own ``predicted_step_time`` (zero-bubble schedules get the
                measured B/W split);
    pick      — argmin predicted step time over the feasible candidates,
                ties broken by the documented total order (see
                ``plan_pipeline``).

The resolved choice is a ``PipelinePlan``: inspectable (``table`` /
``format_table`` print the ranked candidates, the ``--auto --dry-run``
surface) and replayable (``make_engine(model, plan)`` accepts it, or
``plan.to_config()`` yields the plain ``GPipeConfig``). Given the same
costs, the ranked table equals the reference's row for row.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.costmodel import (
    LayerCosts,
    cached_profile_layer_costs,
    enumerate_balances,
    predicted_balance_time,
    uniform_balance,
)
from repro_torch.core.pipeline import GPipeConfig
from repro_torch.core.schedule import Placement, get_schedule

# the planner's search space: every trainable schedule in the registry
# ("gpipe" is an alias of fill_drain, so it is not enumerated twice)
PLAN_SCHEDULES = ("fill_drain", "1f1b", "interleaved", "zb-h1", "zb-v")

#: chunk counts enumerated by default (a power-of-two ladder around the
#: paper's 4-chunk operating point)
DEFAULT_CHUNK_COUNTS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class PlanConstraints:
    """The search-space bounds ``plan_pipeline`` enumerates under.

    ``num_stages`` fixes the balance length (the paper's 6-layer model has
    no uniform split for arbitrary stage counts, but the planner enumerates
    ALL contiguous balances, so any 1 <= S <= n_layers works).
    ``max_devices`` prunes candidates needing a wider ring than the host
    has; ``max_live_activations`` prunes by the schedule's peak-live
    accounting (the memory gate); ``budget`` caps how many candidate
    configurations are enumerated (deterministic order, so a truncated
    search is still reproducible); ``rotations`` adds the ring-rotation
    placement axis (predicted time is placement-invariant in the model, so
    rotations only ever lose ties to the schedule's default placement —
    they are enumerated to keep the axis inspectable, and prunable via
    ``budget``). ``min_devices`` prunes candidates whose ring is narrower:
    on ranks the world fixes the ring (``plan_for_cli``), and a rank left
    out of it would hang the others' collectives."""

    num_stages: int = 4
    chunk_counts: tuple[int, ...] = DEFAULT_CHUNK_COUNTS
    schedules: tuple[str, ...] = PLAN_SCHEDULES
    max_devices: int | None = None
    min_devices: int | None = None
    max_live_activations: int | None = None
    budget: int | None = None
    transfer_cost: float = 0.0
    rotations: bool = True


@dataclasses.dataclass(frozen=True)
class PlanCandidate:
    """One enumerated configuration with its prediction (or prune reason).

    ``pruned`` is ``None`` for feasible candidates; otherwise the
    human-readable reason the candidate was excluded from the argmin
    (illegal schedule combo, memory bound, device bound). Pruned candidates
    carry ``predicted_step_s = inf`` and rank after every feasible one."""

    schedule: str
    chunks: int
    balance: tuple[int, ...]
    num_devices: int | None  # pipe devices for round-robin schedules
    rotation: int  # ring rotation; 0 = the schedule's default placement
    predicted_step_s: float
    peak_live: int
    pruned: str | None = None

    def row(self) -> dict:
        """The candidate as a flat dict (benchmark artifact / JSON)."""
        return {
            "schedule": self.schedule,
            "chunks": self.chunks,
            "balance": list(self.balance),
            "num_devices": self.num_devices,
            "rotation": self.rotation,
            "predicted_step_s": self.predicted_step_s,
            "peak_live": self.peak_live,
            "pruned": self.pruned,
        }


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """A fully-resolved pipeline configuration: the planner's pick plus the
    ranked candidate table it was chosen from.

    Both engines accept a plan directly (``make_engine(model, plan)``);
    ``to_config`` assembles the equivalent ``GPipeConfig`` with any field
    overridden — the replay path for a pick logged by an earlier run."""

    schedule: str
    chunks: int
    balance: tuple[int, ...]
    num_devices: int | None
    placement: Placement | None
    predicted_step_s: float
    costs: LayerCosts | None
    candidates: tuple[PlanCandidate, ...]  # ranked: best first, pruned last
    evaluated: int  # candidates actually evaluated (budget may truncate)
    truncated: bool  # True when the budget cut enumeration short
    engine: str = "compiled"
    backend: str = "padded"
    data_parallel: int = 1
    overlap: str = "off"
    device: str = "cuda"
    # every chunk count's costs the planner read: what another rank plans from
    costs_by_chunks: dict = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def num_stages(self) -> int:
        """Pipeline stages (= entries in ``balance``)."""
        return len(self.balance)

    def to_config(self, **overrides) -> GPipeConfig:
        """The plan as a plain ``GPipeConfig`` (``overrides`` win — e.g.
        ``to_config(engine="host")`` replays the pick on the other
        engine)."""
        kw = dict(
            balance=self.balance,
            chunks=self.chunks,
            schedule=self.schedule,
            num_devices=self.num_devices,
            placement=self.placement,
            engine=self.engine,
            backend=self.backend,
            data_parallel=self.data_parallel,
            overlap=self.overlap,
            device=self.device,
        )
        kw.update(overrides)
        return GPipeConfig(**kw)

    def table(self, limit: int | None = None) -> list[dict]:
        """The ranked candidate rows (``limit`` trims to the head)."""
        cands = self.candidates if limit is None else self.candidates[:limit]
        return [dict(c.row(), rank=i) for i, c in enumerate(cands)]

    def format_table(self, limit: int | None = 10) -> str:
        """The ranked candidate table as aligned text — what ``--auto
        --dry-run`` prints (mirrors the ``--partition profiled`` table)."""
        lines = [
            f"[auto] evaluated {self.evaluated} candidates"
            + (" (budget-truncated)" if self.truncated else "")
            + f"; pick: schedule={self.schedule} chunks={self.chunks} "
            f"balance={self.balance} devices={self.num_devices or len(self.balance)} "
            f"rotation={0 if self.placement is None else '-'.join(map(str, self.placement.stage_to_device))} "
            f"predicted_step={self.predicted_step_s * 1e3:.3f}ms",
            f"  {'rank':>4} {'schedule':<12} {'chunks':>6} {'devices':>7} "
            f"{'balance':<12} {'rot':>3} {'pred_ms':>9} {'peak_live':>9}  note",
        ]
        for row in self.table(limit):
            bal = "-".join(map(str, row["balance"]))
            pred = (
                f"{row['predicted_step_s'] * 1e3:9.3f}"
                if math.isfinite(row["predicted_step_s"])
                else f"{'-':>9}"
            )
            note = row["pruned"] or ""
            devices = row["num_devices"] or len(row["balance"])
            lines.append(
                f"  {row['rank']:>4} {row['schedule']:<12} {row['chunks']:>6} "
                f"{devices:>7} {bal:<12} {row['rotation']:>3} {pred} "
                f"{row['peak_live']:>9}  {note}"
            )
        if limit is not None and len(self.candidates) > limit:
            lines.append(f"  ... {len(self.candidates) - limit} more candidates")
        return "\n".join(lines)


def _device_options(name: str, num_stages: int):
    """The pipe-device counts a schedule can place ``num_stages`` on:
    round-robin schedules (interleaved, zb-v) take any proper divisor of S
    (V >= 2 virtual stages per device); the rest place one stage per
    device."""
    if name in ("interleaved", "zb-v"):
        return [d for d in range(1, num_stages) if num_stages % d == 0]
    return [None]


def plan_pipeline(
    model,
    graph,
    constraints: PlanConstraints | None = None,
    *,
    params=None,
    rng: int | None = None,
    strategy: str = "sequential",
    halo_hops: int = 2,
    seed: int = 0,
    costs_by_chunks: dict[int, LayerCosts] | None = None,
    cache_path: str | None = None,
    engine: str = "compiled",
    backend: str = "padded",
    data_parallel: int = 1,
    overlap: str = "off",
    device: str = "cuda",
    profile_repeats: int = 3,
    profile_warmup: int = 1,
) -> PipelinePlan:
    """Resolve (schedule x chunks x balance x placement) by prediction.

    For each candidate chunk count a representative padded chunk of this
    graph (a host graph; the chunk moves to ``device``) is profiled (``cached_profile_layer_costs`` — the sidecar cache
    means a sweep profiles each (model, chunk shape, backend) once), every
    contiguous balance is priced through the schedule's own weighted
    makespan (``predicted_balance_time``: zero-bubble schedules get the
    measured B/W split), candidates over the memory bound are pruned, and
    the argmin predicted step time wins.

    The tie-break is a documented total order, so the argmin is stable
    under tied candidates: lower predicted time, then lower peak-live
    activations, then fewer chunks, then the caller's schedule order, then
    the uniform balance before any other, then lexicographic balance, then
    fewer pipe devices, then the schedule's default placement (rotation 0)
    before any rotation.

    ``costs_by_chunks`` injects pre-measured ``LayerCosts`` per chunk count
    (tests and replay skip profiling entirely); ``graph`` may then be
    ``None``.
    """
    cons = constraints or PlanConstraints()
    S = cons.num_stages
    n_layers = len(model.layers)
    if not 1 <= S <= n_layers:
        raise ValueError(
            f"num_stages must satisfy 1 <= S <= {n_layers} layers, got {S}"
        )
    uniform = uniform_balance(n_layers, S)
    if params is None:
        params = model.init_params(seed, device=device)
    if rng is None:
        rng = seed

    costs_cache: dict[int, LayerCosts] = dict(costs_by_chunks or {})

    def costs_for(C: int) -> LayerCosts:
        if C not in costs_cache:
            if graph is None:
                raise ValueError(
                    f"no costs_by_chunks entry for chunks={C} and no graph "
                    f"to profile on"
                )
            from repro_torch.core.microbatch import make_plan

            plan = make_plan(graph, C, strategy=strategy, halo_hops=halo_hops, seed=seed)
            chunk0 = plan.stacked().graph.chunk(0).to(device)
            costs_cache[C] = cached_profile_layer_costs(
                model, params, chunk0, backend=backend, cache_path=cache_path,
                rng=rng, repeats=profile_repeats, warmup=profile_warmup,
            )
        return costs_cache[C]

    candidates: list[tuple[tuple, PlanCandidate]] = []
    evaluated = 0
    truncated = False

    def budget_left() -> bool:
        return cons.budget is None or evaluated < cons.budget

    for sched_idx, name in enumerate(cons.schedules):
        if truncated:
            break
        for C in cons.chunk_counts:
            if truncated:
                break
            if C % data_parallel:
                candidates.append((
                    (math.inf, 0, C, sched_idx, False, (), 0, 0),
                    PlanCandidate(name, C, uniform, None, 0, math.inf, 0,
                                  pruned=f"chunks {C} not divisible by "
                                         f"data_parallel {data_parallel}"),
                ))
                continue
            for nd in _device_options(name, S):
                D = nd if nd is not None else S
                if cons.max_devices is not None and D > cons.max_devices:
                    candidates.append((
                        (math.inf, 0, C, sched_idx, False, (), D, 0),
                        PlanCandidate(name, C, uniform, nd, 0, math.inf, 0,
                                      pruned=f"needs {D} devices > "
                                             f"max_devices {cons.max_devices}"),
                    ))
                    continue
                if cons.min_devices is not None and D < cons.min_devices:
                    candidates.append((
                        (math.inf, 0, C, sched_idx, False, (), D, 0),
                        PlanCandidate(name, C, uniform, nd, 0, math.inf, 0,
                                      pruned=f"ring of {D} positions < the "
                                             f"{cons.min_devices} ranks"),
                    ))
                    continue
                try:
                    sched = get_schedule(name, num_devices=nd)
                    peak = sched.peak_live_activations(S, C)
                except ValueError as e:
                    candidates.append((
                        (math.inf, 0, C, sched_idx, False, (), D, 0),
                        PlanCandidate(name, C, uniform, nd, 0, math.inf, 0,
                                      pruned=str(e)),
                    ))
                    continue
                if (
                    cons.max_live_activations is not None
                    and peak > cons.max_live_activations
                ):
                    candidates.append((
                        (math.inf, peak, C, sched_idx, False, (), D, 0),
                        PlanCandidate(name, C, uniform, nd, 0, math.inf, peak,
                                      pruned=f"peak_live {peak} > "
                                             f"max {cons.max_live_activations}"),
                    ))
                    continue
                rotations = range(D) if cons.rotations else (0,)
                for bal in enumerate_balances(n_layers, S):
                    if not budget_left():
                        truncated = True
                        break
                    t = predicted_balance_time(
                        costs_for(C), bal, sched, C,
                        transfer_cost=cons.transfer_cost,
                    )
                    for rot in rotations:
                        if not budget_left():
                            truncated = True
                            break
                        evaluated += 1
                        key = (t, peak, C, sched_idx, bal != uniform, bal, D, rot)
                        candidates.append((
                            key,
                            PlanCandidate(name, C, bal, nd, rot, t, peak),
                        ))
                    if truncated:
                        break
                if truncated:
                    break

    candidates.sort(key=lambda kc: kc[0])
    ranked = tuple(c for _, c in candidates)
    feasible = [c for c in ranked if c.pruned is None]
    if not feasible:
        raise ValueError(
            "plan_pipeline: every candidate was pruned or illegal — relax "
            "the constraints (see PipelinePlan candidates for reasons): "
            + "; ".join(sorted({c.pruned for c in ranked if c.pruned}))
        )
    best = feasible[0]
    D = best.num_devices if best.num_devices is not None else S
    placement = (
        None
        if best.rotation == 0
        else Placement.ring(S, best.num_devices, rotation=best.rotation)
    )
    return PipelinePlan(
        schedule=best.schedule,
        chunks=best.chunks,
        balance=best.balance,
        num_devices=best.num_devices,
        placement=placement,
        predicted_step_s=best.predicted_step_s,
        costs=costs_cache.get(best.chunks),
        candidates=ranked,
        evaluated=evaluated,
        truncated=truncated,
        engine=engine,
        backend=backend,
        data_parallel=data_parallel,
        overlap=overlap,
        device=device,
        costs_by_chunks=dict(costs_cache),
    )


def plan_for_cli(
    model,
    graph,
    cli,
    *,
    params=None,
    rng: int | None = None,
    strategy: str = "sequential",
    seed: int = 0,
    cache_path: str | None = None,
    costs_by_chunks: dict[int, LayerCosts] | None = None,
    device=None,
) -> PipelinePlan:
    """``plan_pipeline`` parameterized by a ``PipelineCLIConfig`` — the one
    translation every ``--auto`` entry point (train / serve) shares. ``--stages`` fixes the balance length (default: the
    paper's 4-stage pipeline when the flag is at its single-device
    default); ``--auto-budget`` caps the enumeration; the engine / backend /
    data-parallel / overlap / device flags ride into the plan untouched —
    the planner resolves schedule, chunks, balance and placement, nothing
    else. ``--device`` is resolved first: no card means a raise; ``device``
    (a rank's card) overrides it.

    Under a process group the world fixes the ring: D = world /
    ``--data-parallel`` positions, so candidates of any other ring width are
    pruned (``max_devices`` = ``min_devices`` = D). Rank 0 alone plans, and
    profiles on its own card (and reads and writes ``cache_path``); the
    costs it planned from reach every rank by one broadcast, every rank
    plans from them, and a gather of the ranked table raises if any rank's
    differs: one plan on every rank, as the reference's one process has. An
    error on rank 0 (no candidate fits the ring) raises on every rank."""
    from repro_torch.core import ranks
    from repro_torch.core.cli import resolve_device

    device = str(device if device is not None else resolve_device(cli.device))
    stages = cli.stages if cli.stages > 1 else 4
    chunk_counts = tuple(sorted(set(DEFAULT_CHUNK_COUNTS) | {cli.chunks}))
    ring = None
    if ranks.active():
        world = ranks.world_size()
        if world % cli.data_parallel:
            raise ValueError(f"a world of {world} ranks does not split into --data-parallel "
                             f"{cli.data_parallel} replicas of a ring")
        ring = world // cli.data_parallel
    cons = PlanConstraints(
        num_stages=stages,
        chunk_counts=chunk_counts,
        budget=cli.auto_budget,
        max_devices=ring,
        min_devices=ring,
    )

    def plan(costs, graph, cache_path):
        return plan_pipeline(
            model,
            graph,
            cons,
            params=params,
            rng=rng,
            strategy=strategy,
            seed=seed,
            costs_by_chunks=costs,
            cache_path=cache_path,
            engine=cli.engine,
            backend=cli.backend,
            data_parallel=cli.data_parallel,
            overlap=cli.overlap,
            device=device,
        )

    if ring is None:
        return plan(costs_by_chunks, graph, cache_path)
    picked = None

    def on_leader():
        nonlocal picked
        picked = plan(costs_by_chunks, graph, cache_path)
        return picked.costs_by_chunks

    costs = ranks.from_leader(on_leader)
    if picked is None:  # every other rank plans from rank 0's costs alone
        picked = plan(costs, None, None)
    ranks.same_on_every_rank(picked.table(), "the --auto plan table")
    return picked
