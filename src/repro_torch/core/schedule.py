"""Pluggable pipeline schedules + bubble/memory accounting.

Counterpart of ``repro.core.schedule``, carried over whole: the module is
numpy only, so the port keeps its own copy and every timeline, bubble
fraction, peak-live count and lowered array equals the JAX package's.

The schedule is the paper's object of study: with S stages and C chunks the
synchronous fill-drain pipeline runs C + S - 1 forward ticks and C + S - 1
backward ticks; the idle ("bubble") fraction is (S - 1) / (C + S - 1).
GNNPipe/GraphPipe show smarter schedules are the main lever for closing that
gap, so the schedule is now an abstraction, not a single function:

  * ``fill_drain``  — GPipe's synchronous schedule (the paper's §6 baseline).
    All C forwards complete before any backward: peak live activations are
    C per stage, bubble (S-1)/(C+S-1).
  * ``1f1b``        — one-forward-one-backward (PipeDream-flush /
    Megatron-LM's non-interleaved schedule). Same bubble as fill-drain for
    equal fwd/bwd tick costs, but stage s holds at most min(S-s, C) live
    activations — the memory lever.
  * ``interleaved`` — interleaved 1F1B: each of D physical devices hosts
    V = S/D *virtual* stages placed round-robin (stage k on device k mod D);
    activations hop device→device circularly. The bubble shrinks by ~V:
    (D-1)/(V·C+D-1) instead of (D-1)/(C+D-1).
  * ``zb-h1``      — zero-bubble H1 (Qi et al.): the backward is SPLIT into
    a **B** phase (input-grad — the only part on the pipeline's critical
    path) and a **W** phase (weight-grad — needed only by the optimizer at
    the end of the step). B items keep 1F1B's ordering and memory window;
    W items fill the drain bubble whenever their device would otherwise
    idle. With unit costs the makespan is 3C + S - 1 ticks for 3C work
    units per device — the drain bubble all but disappears.

Split-backward timelines use two extra phases: ``bwd_b`` (consumes the
stashed stage input + downstream cotangent, emits the upstream cotangent
and a residual) and ``bwd_w`` (consumes the residual, emits the stage's
parameter gradients). A (stage, chunk) pair either runs the fused ``bwd``
or BOTH split halves, W strictly after its matching B on the same device.

Every schedule emits a ``WorkItem`` timeline — (tick, stage, chunk, phase,
device) — consumed generically by the host-driven GNN engine
(``repro_torch.core.pipeline``) and by the benchmark harness (predicted-vs-measured
epoch time, Fig 3 analogue). ``validate_timeline`` checks the invariants any
correct timeline must satisfy; the 1F1B/interleaved timelines come out of a
greedy list scheduler whose dependency graph encodes both data flow and the
1F1B in-flight activation window, so they are correct by construction.

Module-level ``fill_drain_timeline`` / ``bubble_fraction`` /
``predicted_step_time`` are kept as the fill-drain shorthand (the paper's
formulas, used throughout the benchmarks).

Lowering contract (``lower_timeline`` -> ``LoweredTimeline``) — the bridge
between a ``WorkItem`` timeline and the compiled executors: the timeline
becomes dense per-tick ``(T, D)`` index arrays (phase / stage / chunk) plus
stash-slot routing, one slot family per buffer kind:

  * **fslot** — activation-stash slots. ``in_fslot[t, d]`` banks the
    forward-wire value arriving at device d this tick; ``work_fslot[t, d]``
    is where this tick's item reads its stage input (bwd/bwd_b re-derive
    the vjp from it — GPipe re-materialization).
  * **bslot** — cotangent-stash slots, same in/work pattern for the
    backward wire.
  * **wslot** — deferred-W residual slots: ``bwd_b`` writes its residual to
    ``store_wslot``; the matching ``bwd_w`` reads ``work_wslot``. Empty
    (``n_wslots == 0``) for fused-backward schedules.

Slot indices come from a FREE-LIST simulation over the timeline (allocate
at arrival, release after last read, reuse eagerly), so ``n_fslots`` /
``n_bslots`` / ``n_wslots`` are the schedule's *real* live windows — 1F1B
lowers to ~min(S, C) activation slots where fill-drain needs C — and the
executors' stash arrays are sized by them, never by S*C. Every slot array
reserves index ``n_*slots`` as the sacrificial slot: idle ticks read/write
it so the scan body stays branch-free. See ``LoweredTimeline`` for the
authoritative field-by-field statement.

Wire parity (communication/compute overlap): ``wire_latency`` is the number
of ticks between a value's producing tick and the tick its arrival is
banked. Latency 1 is the serialized executor — the ``ppermute`` for tick
t's output issues after tick t's work, and the value is banked at t+1.
Latency 2 is the DOUBLE-BUFFERED executor: each direction holds two wire
buffers alternating by tick parity — the value produced at tick t sits in
the *pending* buffer through tick t+1 (its ``ppermute`` is issued at the
top of tick t+1, BEFORE t+1's work, so the collective has a full tick of
compute to hide behind) and is banked from the *wire* buffer at t+2.
``retime_timeline`` stretches any validated timeline so every wire edge
has >= ``wire_latency`` ticks of slack; ``lower_timeline(...,
wire_latency=2)`` then emits arrival indices one tick ahead of consumption
and rejects timelines whose wire edges are too tight. All-idle ticks
(ragged plans lowered with ``skip_chunks`` produce them) are deleted from
the emitted arrays — the remap keeps every producer→arrival distance
exactly ``wire_latency``, so dead ticks never pay their two ppermutes.
"""

from __future__ import annotations

import abc
import dataclasses
import heapq

import numpy as np

# ----------------------------------------------------------------- items --


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One scheduled unit of work: (tick, stage, chunk, phase, device) —
    the element every timeline is a sorted list of."""

    tick: int
    stage: int
    chunk: int
    phase: str  # "fwd" | "bwd" (fused) | "bwd_b" (input-grad) | "bwd_w" (weight-grad)
    device: int = -1  # physical device; defaults to == stage (one stage/device)

    def __post_init__(self):
        if self.device < 0:
            object.__setattr__(self, "device", self.stage)


def _sort_key(it: WorkItem):
    # canonical execution order: tick-major, forwards before backwards inside
    # a tick (a tick's items are concurrent on real hardware; a host executor
    # running them in this order never frees an activation before its save)
    return (it.tick, 0 if it.phase == "fwd" else 1, it.stage, it.chunk)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Stage -> device assignment for a pipeline timeline.

    ``stage_to_device[s]`` is the RING POSITION hosting stage ``s``. The only
    placements the compiled executors can route are the ring-compatible ones
    ``lower_timeline`` accepts — stage s+1 one ``ppermute`` hop downstream of
    stage s (``stage_to_device[s + 1] == (stage_to_device[s] + 1) % D``) — so
    every valid placement is a rotation of the schedule's default: one stage
    per device rotated by k, or the interleaved round-robin rotated by k.
    ``validate`` enforces exactly that rule (the same check the lowering
    performs) so a bad placement fails loudly at construction instead of
    surfacing as mis-routed activations.

    ``device_order`` (optional) maps ring position -> PHYSICAL device index
    (an index into the host's device list): it chooses which real device
    hosts which ring position without changing the logical dataflow — the
    knob for heterogeneous hosts where the slowest stage should sit on the
    fastest device. ``None`` means positions 0..D-1 in enumeration order.
    """

    stage_to_device: tuple[int, ...]
    device_order: tuple[int, ...] | None = None

    @property
    def num_devices(self) -> int:
        """Physical ring size implied by the stage->device map."""
        return max(self.stage_to_device) + 1

    @classmethod
    def ring(
        cls,
        num_stages: int,
        num_devices: int | None = None,
        *,
        rotation: int = 0,
        device_order: tuple[int, ...] | None = None,
    ) -> "Placement":
        """The canonical ring placements: stage s on ring position
        ``(s + rotation) % D`` — one stage per device when ``num_devices`` is
        omitted, the interleaved round-robin otherwise."""
        D = num_stages if num_devices is None else num_devices
        return cls(
            tuple((s + rotation) % D for s in range(num_stages)),
            device_order=device_order,
        ).validate(num_stages)

    def validate(self, num_stages: int) -> "Placement":
        """Check stage count, device contiguity and device_order arity;
        returns self for chaining."""
        std = self.stage_to_device
        if len(std) != num_stages:
            raise ValueError(
                f"placement maps {len(std)} stages, schedule has {num_stages}"
            )
        D = self.num_devices
        if sorted(set(std)) != list(range(D)):
            raise ValueError(
                f"placement must use ring positions 0..{D - 1} contiguously, "
                f"got {std}"
            )
        for s in range(num_stages - 1):
            if std[s + 1] != (std[s] + 1) % D:
                raise ValueError(
                    f"placement is not ring-compatible: stage {s + 1} on "
                    f"device {std[s + 1]}, expected {(std[s] + 1) % D} (one "
                    f"hop after stage {s} on device {std[s]})"
                )
        if self.device_order is not None:
            if len(self.device_order) != D or len(set(self.device_order)) != D:
                raise ValueError(
                    f"device_order must list {D} distinct physical device "
                    f"indices, got {self.device_order}"
                )
        return self

    def apply(self, items: list[WorkItem]) -> list[WorkItem]:
        """Re-device a timeline onto this placement (ticks untouched)."""
        return [
            dataclasses.replace(it, device=self.stage_to_device[it.stage])
            for it in items
        ]


def validate_timeline(
    items: list[WorkItem], num_stages: int, num_chunks: int
) -> None:
    """Raise AssertionError unless ``items`` is a correct pipeline timeline:

    * each (stage, chunk, phase) appears exactly once; every (stage, chunk)
      has its fwd plus EITHER a fused ``bwd`` OR both split halves
      (``bwd_b`` + ``bwd_w``), never a mix;
    * no device runs two items in the same tick, and a stage never moves
      between devices;
    * fwd(s, c) strictly after fwd(s-1, c);
    * the input-grad tick b(s, c) — the fused bwd or the split bwd_b —
      strictly after b(s+1, c), and after fwd(S-1, c) at the last stage;
    * b(s, c) strictly after fwd(s, c) at EVERY stage, and strictly after
      fwd(s+1, c) — a chunk's backward can only start once its forward has
      cleared the stage whose cotangent it consumes. (For a complete
      timeline these follow from the chained checks above, but they are
      asserted directly so a violation is reported at the offending item
      instead of surfacing as a far-away chain inconsistency.)
    * bwd_w(s, c) strictly after its matching bwd_b(s, c), on the SAME
      device — the residual it consumes never travels the wire.
    """
    S, C = num_stages, num_chunks
    seen: dict[tuple[int, int, str], int] = {}
    dev: dict[tuple[int, int, str], int] = {}
    for it in items:
        key = (it.stage, it.chunk, it.phase)
        assert key not in seen, f"duplicate work item {key}"
        assert 0 <= it.stage < S and 0 <= it.chunk < C, it
        assert it.phase in ("fwd", "bwd", "bwd_b", "bwd_w"), it
        seen[key] = it.tick
        dev[key] = it.device
    busy: dict[tuple[int, int], WorkItem] = {}
    for it in items:
        other = busy.setdefault((it.tick, it.device), it)
        assert other is it, (
            f"device {it.device} runs two items in tick {it.tick}: "
            f"(stage {other.stage}, chunk {other.chunk}, {other.phase}) and "
            f"(stage {it.stage}, chunk {it.chunk}, {it.phase})"
        )
    stage_dev: dict[int, int] = {}
    for it in items:
        assert stage_dev.setdefault(it.stage, it.device) == it.device, (
            f"stage {it.stage} placed on two devices: "
            f"{stage_dev[it.stage]} and {it.device}"
        )

    n_split = 0
    for c in range(C):
        for s in range(S):
            assert (s, c, "fwd") in seen, (s, c, "missing fwd")
            fused = (s, c, "bwd") in seen
            has_b = (s, c, "bwd_b") in seen
            has_w = (s, c, "bwd_w") in seen
            assert fused != (has_b or has_w), (
                s, c, "backward must be fused bwd XOR split bwd_b/bwd_w",
            )
            if not fused:
                assert has_b, (s, c, "bwd_w without a matching bwd_b")
                assert has_w, (s, c, "bwd_b without a matching bwd_w")
                assert seen[(s, c, "bwd_w")] > seen[(s, c, "bwd_b")], (
                    s, c, "W scheduled before its matching B",
                )
                assert dev[(s, c, "bwd_w")] == dev[(s, c, "bwd_b")], (
                    s, c, "W on a different device than its matching B",
                )
                n_split += 1
    assert len(seen) == 2 * S * C + n_split, (
        f"expected {2 * S * C + n_split} items, got {len(seen)}"
    )

    def t_b(s, c):  # the input-grad tick: fused bwd or split bwd_b
        return seen[(s, c, "bwd")] if (s, c, "bwd") in seen else seen[(s, c, "bwd_b")]

    for c in range(C):
        for s in range(1, S):
            assert seen[(s, c, "fwd")] > seen[(s - 1, c, "fwd")], (s, c, "fwd dep")
        assert t_b(S - 1, c) > seen[(S - 1, c, "fwd")], (c, "loss dep")
        for s in range(S - 1):
            assert t_b(s, c) > t_b(s + 1, c), (s, c, "bwd dep")
        # direct cross-phase checks: b(s, c) after its own fwd AND after
        # the downstream fwd whose cotangent it consumes
        for s in range(S):
            assert t_b(s, c) > seen[(s, c, "fwd")], (s, c, "bwd before own fwd")
        for s in range(S - 1):
            assert t_b(s, c) > seen[(s + 1, c, "fwd")], (
                s, c, "bwd before fwd of next stage",
            )


def validate_forward_timeline(
    items: list[WorkItem], num_stages: int, num_chunks: int
) -> None:
    """The inference/eval subset of ``validate_timeline``: forward items
    only, each (stage, chunk) exactly once, fwd chain respected, no device
    double-booked."""
    S, C = num_stages, num_chunks
    seen: dict[tuple[int, int], int] = {}
    for it in items:
        assert it.phase == "fwd", it
        key = (it.stage, it.chunk)
        assert key not in seen, f"duplicate forward item {key}"
        assert 0 <= it.stage < S and 0 <= it.chunk < C, it
        seen[key] = it.tick
    assert len(seen) == S * C, f"expected {S * C} items, got {len(seen)}"
    busy = {(it.tick, it.device) for it in items}
    assert len(busy) == len(items), "a device runs two items in one tick"
    for c in range(C):
        for s in range(1, S):
            assert seen[(s, c)] > seen[(s - 1, c)], (s, c, "fwd dep")


def peak_live_activations(items: list[WorkItem]) -> int:
    """Max simultaneous saved stage-inputs implied by the timeline: the input
    of stage s for chunk c is live from fwd(s, c) until bwd(s, c) consumes it
    (GPipe re-materializes stage internals, so only stage *inputs* persist).
    For split-backward timelines the input-grad half (``bwd_b``) is the
    consumer — it moves the input into the W residual, so the activation
    window matches 1F1B's; ``bwd_w`` touches only the residual stash,
    accounted separately (``LoweredTimeline.n_wslots``)."""
    live = 0
    peak = 0
    for it in sorted(items, key=_sort_key):
        if it.phase == "fwd":
            live += 1
            peak = max(peak, live)
        elif it.phase in ("bwd", "bwd_b"):
            live -= 1
    return peak


# ------------------------------------------ timeline -> index arrays --

PHASE_IDLE, PHASE_FWD, PHASE_BWD, PHASE_BWD_B, PHASE_BWD_W = 0, 1, 2, 3, 4

_PHASE_CODE = {
    "fwd": PHASE_FWD, "bwd": PHASE_BWD, "bwd_b": PHASE_BWD_B, "bwd_w": PHASE_BWD_W,
}


# eq=False: the auto-generated __eq__ would compare ndarray fields with
# bool(a == b) and raise the ambiguous-truth-value error on first use (and
# frozen+eq would try to hash arrays); identity semantics are the contract.
@dataclasses.dataclass(frozen=True, eq=False)
class LoweredTimeline:
    """A ``WorkItem`` timeline compiled to dense per-tick index arrays — the
    static program the schedule-aware compiled executor
    (the compiled single-program engine, a later slice) scans over.

    Every array is (num_ticks, num_devices) int32; device d reads its column
    each tick:

      * ``phase``      — PHASE_IDLE / PHASE_FWD / PHASE_BWD;
      * ``stage``      — the (virtual) stage the work item runs (0 when idle);
      * ``chunk``      — the item's microbatch (0 when idle);
      * ``work_fslot`` — activation-stash slot holding this item's *stage
        input*: a fwd reads its banked input there, a bwd re-materializes
        from it.  ``n_fslots`` (the sacrificial slot) for stage-0 items,
        whose input is read from the chunk's features instead, and when idle;
      * ``in_fslot``   — where to bank the forward-wire value arriving this
        tick (the upstream stage's output, one ``ppermute`` hop old);
        sacrificial when the arriving value is fill/drain garbage;
      * ``work_bslot`` — cotangent-stash slot a bwd/bwd_b reads; sacrificial
        for the last stage (its cotangent comes from the loss) and ticks
        that consume no cotangent;
      * ``in_bslot``   — where to bank the backward-wire value arriving this
        tick; sacrificial for garbage;
      * ``work_wslot`` — residual-stash slot a ``bwd_w`` reads (the
        (stage input, applied cotangent) pair its matching ``bwd_b``
        banked); sacrificial on every other tick;
      * ``store_wslot`` — residual-stash slot a ``bwd_b`` WRITES after its
        work (no wire hop: B and W run on the same device); sacrificial on
        every other tick.

    Slots are assigned by a free-list simulation over the timeline, so
    ``n_fslots`` is the schedule's real per-device activation window (1F1B's
    min(S-s, C) memory lever) rather than the fill-drain C — plus the wire
    slack between an activation's arrival and the tick its fwd consumes it.
    ``peak_live_stash`` is the max number of simultaneously banked stage
    inputs summed across devices (the compiled analogue of the host engine's
    measured ``len(saved)`` peak, minus stage-0 inputs which are never
    stashed — they are read from the replicated feature table by chunk id).

    ``wire_latency`` selects the executor's wire dataflow: 1 — a value put
    on the wire at tick t is banked at t+1 (the serialized ppermute-after-
    work executor); 2 — banked at t+2 through the parity-alternating double
    buffer (the ppermute for tick t's arrivals is issued before tick t-1's
    work, off the critical path). The index arrays already encode the
    latency (arrivals land ``wire_latency`` ticks after production), so the
    executors only branch on this field to pick the matching carry shape.
    """

    num_stages: int
    num_chunks: int
    num_devices: int
    num_ticks: int
    phase: np.ndarray
    stage: np.ndarray
    chunk: np.ndarray
    work_fslot: np.ndarray
    in_fslot: np.ndarray
    work_bslot: np.ndarray
    in_bslot: np.ndarray
    work_wslot: np.ndarray
    store_wslot: np.ndarray
    n_fslots: int
    n_bslots: int
    n_wslots: int
    peak_live_stash: int
    wire_latency: int = 1


def _alloc_slots(entries):
    """Free-list slot allocation for [arrival, release] tick intervals.

    ``entries`` is a list of (arrival, release, key); a slot freed at tick t
    is reusable from t + 1 (the executor banks arrivals *before* the tick's
    read, so same-tick reuse would clobber an unread value). Returns
    (slot_of_key, n_slots)."""
    slot_of: dict = {}
    n_slots = 0
    free: list[int] = []
    active: list[tuple[int, int]] = []  # (release, slot) min-heap
    for arrival, release, key in sorted(entries):
        while active and active[0][0] < arrival:
            heapq.heappush(free, heapq.heappop(active)[1])
        if free:
            slot = heapq.heappop(free)
        else:
            slot = n_slots
            n_slots += 1
        slot_of[key] = slot
        heapq.heappush(active, (release, slot))
    return slot_of, n_slots


def retime_timeline(
    items: list[WorkItem],
    num_stages: int,
    num_chunks: int,
    *,
    wire_latency: int = 2,
) -> list[WorkItem]:
    """Stretch a validated timeline so every wire edge has >= ``wire_latency``
    ticks between its producing and consuming items — the earliest-start
    retiming that makes a latency-1 schedule double-bufferable.

    A single longest-path pass over the items in canonical order (a valid
    topological order: every dependency's original tick is strictly smaller,
    and within a tick forwards precede backwards). Constraints:

      * per-device sequencing — each device's items keep their original
        relative order, one tick apart at minimum (this also covers the
        same-device dependencies: loss after the last stage's fwd, W after
        its matching B);
      * wire edges — fwd(s, c) at least ``wire_latency`` ticks after
        fwd(s-1, c), and the input-grad item of (s, c) at least
        ``wire_latency`` ticks after that of (s+1, c).

    Per-device order preservation keeps the arrival-collision property of
    the input timeline (one producer per direction per device per tick);
    the fill phase inflates by ~(wire_latency - 1)(S - 1) ticks while steady
    -state 1F1B/zb-h1 ticks mostly already carry the slack."""
    S, C = num_stages, num_chunks
    validate_timeline(items, S, C)
    L = wire_latency
    new_tick: dict[tuple[int, int, str], int] = {}
    last_on_dev: dict[int, int] = {}

    def b_key(s, c):
        return (s, c, "bwd") if (s, c, "bwd") in new_tick else (s, c, "bwd_b")

    out: list[WorkItem] = []
    for it in sorted(items, key=_sort_key):
        earliest = last_on_dev.get(it.device, -1) + 1
        if it.phase == "fwd" and it.stage > 0:
            earliest = max(earliest, new_tick[(it.stage - 1, it.chunk, "fwd")] + L)
        elif it.phase in ("bwd", "bwd_b") and it.stage < S - 1:
            earliest = max(earliest, new_tick[b_key(it.stage + 1, it.chunk)] + L)
        new_tick[(it.stage, it.chunk, it.phase)] = earliest
        last_on_dev[it.device] = earliest
        out.append(dataclasses.replace(it, tick=earliest))
    return sorted(out, key=_sort_key)


def lower_timeline(
    items: list[WorkItem],
    num_stages: int,
    num_chunks: int,
    *,
    forward_only: bool = False,
    wire_latency: int = 1,
    skip_chunks: tuple[int, ...] = (),
) -> LoweredTimeline:
    """Lower a validated timeline to the per-tick index arrays of
    ``LoweredTimeline``.

    Static validation beyond ``validate_timeline``: the device placement must
    be ring-compatible — stage s+1 must sit one ``ppermute`` hop downstream
    of stage s (device_of(s+1) == (device_of(s) + 1) % D) so a single
    forward ring (and its transpose for cotangents) carries every edge of
    the pipeline DAG. All shipped schedules (fill-drain, 1F1B, interleaved
    round-robin placement, zb-h1) satisfy this; a custom placement that does
    not raises ``ValueError`` here instead of silently mis-routing
    activations.

    Split-backward timelines additionally get a W residual-slot free-list:
    ``bwd_b(s, c)`` banks its residual into ``store_wslot`` and the matching
    ``bwd_w(s, c)`` reads it back through ``work_wslot``; slot reuse
    respects the residual's [B-tick, W-tick] live window exactly like the
    activation stash does, so ``n_wslots`` is the schedule's real deferred-W
    window, not C.

    ``forward_only=True`` lowers an inference/eval timeline (fwd items
    only, validated by ``validate_forward_timeline``): each banked stage
    input is released by its own forward, so the stash collapses to the
    wire-slack window (one slot per device for fill-drain forwards).

    ``wire_latency`` sets the production→arrival distance of every wire
    value (see the module docstring's wire-parity rule); a timeline whose
    wire edges are tighter than the latency raises ``ValueError`` pointing
    at ``retime_timeline``. ``skip_chunks`` drops the named chunks' items
    after validation — the lever for ragged plans whose empty chunks
    contribute exactly-zero gradients — and the all-idle ticks that leaves
    behind (plus any the input timeline already had) are deleted from the
    emitted arrays by a monotone tick remap that preserves every
    producer→arrival distance.
    """
    S, C = num_stages, num_chunks
    if forward_only:
        validate_forward_timeline(items, S, C)
    else:
        validate_timeline(items, S, C)
    if wire_latency < 1:
        raise ValueError(f"wire_latency must be >= 1, got {wire_latency}")

    dev_of: dict[int, int] = {}
    for it in items:
        if dev_of.setdefault(it.stage, it.device) != it.device:
            raise ValueError(f"stage {it.stage} placed on two devices")
    D = max(dev_of.values()) + 1
    for s in range(S - 1):
        if dev_of[s + 1] != (dev_of[s] + 1) % D:
            raise ValueError(
                f"placement is not ring-compatible: stage {s + 1} on device "
                f"{dev_of[s + 1]}, expected {(dev_of[s] + 1) % D} (one hop "
                f"after stage {s} on device {dev_of[s]})"
            )

    skip = set(skip_chunks)
    if skip - set(range(C)):
        raise ValueError(
            f"skip_chunks {sorted(skip)} outside the chunk range 0..{C - 1}"
        )
    if skip:
        items = [it for it in items if it.chunk not in skip]
        if not items:
            raise ValueError("skip_chunks removed every item in the timeline")
    live_chunks = [c for c in range(C) if c not in skip]

    t_f: dict[tuple[int, int], int] = {}
    t_b: dict[tuple[int, int], int] = {}  # input-grad tick: fused bwd or bwd_b
    t_w: dict[tuple[int, int], int] = {}
    for it in items:
        key = (it.stage, it.chunk)
        if it.phase == "fwd":
            t_f[key] = it.tick
        elif it.phase == "bwd_w":
            t_w[key] = it.tick
        else:  # "bwd" | "bwd_b"
            t_b[key] = it.tick

    # forward stash: stage s >= 1's input for chunk c is banked on arrival
    # (wire_latency ticks after fwd(s-1, c) put it on the wire) and freed
    # once the input-grad item — fused bwd or bwd_b — has re-materialized
    # from it (forward-only: freed by its own fwd read)
    f_entries: dict[int, list] = {d: [] for d in range(D)}
    b_entries: dict[int, list] = {d: [] for d in range(D)}
    w_entries: dict[int, list] = {d: [] for d in range(D)}
    for c in live_chunks:
        for s in range(1, S):
            release = t_f[(s, c)] if forward_only else t_b[(s, c)]
            arrival = t_f[(s - 1, c)] + wire_latency
            if arrival > t_f[(s, c)]:
                raise ValueError(
                    f"fwd({s}, {c}) at tick {t_f[(s, c)]} reads a wire value "
                    f"arriving at tick {arrival} (wire_latency="
                    f"{wire_latency}); retime the timeline first "
                    f"(retime_timeline)"
                )
            f_entries[dev_of[s]].append((arrival, release, (s, c)))
        if not forward_only:
            for s in range(S - 1):
                # cotangent of stage s's output: produced by the input-grad
                # item of (s+1, c), read (and freed) by that of (s, c)
                arrival = t_b[(s + 1, c)] + wire_latency
                if arrival > t_b[(s, c)]:
                    raise ValueError(
                        f"bwd({s}, {c}) at tick {t_b[(s, c)]} reads a wire "
                        f"value arriving at tick {arrival} (wire_latency="
                        f"{wire_latency}); retime the timeline first "
                        f"(retime_timeline)"
                    )
                b_entries[dev_of[s]].append((arrival, t_b[(s, c)], (s, c)))
            for s in range(S):
                if (s, c) in t_w:
                    # residual written at the B tick, consumed at the W tick
                    w_entries[dev_of[s]].append((t_b[(s, c)], t_w[(s, c)], (s, c)))

    # dead-tick elimination: keep a tick iff some device works it, a wire
    # value is banked at it, or a wire value is in flight across it (for
    # latency L, the L - 1 ticks between production and arrival — deleting
    # one would break the executor's fixed production→arrival distance).
    # The monotone remap therefore keeps every such distance exactly L.
    keep = {it.tick for it in items}
    for entries in (f_entries, b_entries):
        for d in range(D):
            for arrival, _, _ in entries[d]:
                keep.update(range(arrival - wire_latency + 1, arrival + 1))
    remap = {old: new for new, old in enumerate(sorted(keep))}
    T = len(remap)
    items = [dataclasses.replace(it, tick=remap[it.tick]) for it in items]
    for store in (f_entries, b_entries, w_entries):
        for d in range(D):
            store[d] = [(remap[a], remap[r], k) for a, r, k in store[d]]

    f_slot: dict[tuple[int, int], int] = {}
    b_slot: dict[tuple[int, int], int] = {}
    w_slot: dict[tuple[int, int], int] = {}
    n_fslots = n_bslots = n_wslots = 0
    for d in range(D):
        arrivals = {a for a, _, _ in f_entries[d]}
        if len(arrivals) != len(f_entries[d]):
            raise ValueError(f"two forward-wire values arrive at device {d} in one tick")
        arrivals = {a for a, _, _ in b_entries[d]}
        if len(arrivals) != len(b_entries[d]):
            raise ValueError(f"two backward-wire values arrive at device {d} in one tick")
        slots, n = _alloc_slots(f_entries[d])
        f_slot.update(slots)
        n_fslots = max(n_fslots, n)
        slots, n = _alloc_slots(b_entries[d])
        b_slot.update(slots)
        n_bslots = max(n_bslots, n)
        slots, n = _alloc_slots(w_entries[d])
        w_slot.update(slots)
        n_wslots = max(n_wslots, n)

    phase = np.full((T, D), PHASE_IDLE, dtype=np.int32)
    stage = np.zeros((T, D), dtype=np.int32)
    chunk = np.zeros((T, D), dtype=np.int32)
    work_fslot = np.full((T, D), n_fslots, dtype=np.int32)
    in_fslot = np.full((T, D), n_fslots, dtype=np.int32)
    work_bslot = np.full((T, D), n_bslots, dtype=np.int32)
    in_bslot = np.full((T, D), n_bslots, dtype=np.int32)
    work_wslot = np.full((T, D), n_wslots, dtype=np.int32)
    store_wslot = np.full((T, D), n_wslots, dtype=np.int32)

    for it in items:
        key = (it.stage, it.chunk)
        phase[it.tick, it.device] = _PHASE_CODE[it.phase]
        stage[it.tick, it.device] = it.stage
        chunk[it.tick, it.device] = it.chunk
        if it.stage > 0 and it.phase in ("fwd", "bwd", "bwd_b"):
            work_fslot[it.tick, it.device] = f_slot[key]
        if it.phase in ("bwd", "bwd_b") and it.stage < S - 1:
            work_bslot[it.tick, it.device] = b_slot[key]
        if it.phase == "bwd_b":
            store_wslot[it.tick, it.device] = w_slot[key]
        if it.phase == "bwd_w":
            work_wslot[it.tick, it.device] = w_slot[key]
    for d in range(D):
        for arrival, _, (s, c) in f_entries[d]:
            in_fslot[arrival, d] = f_slot[(s, c)]
        for arrival, _, (s, c) in b_entries[d]:
            in_bslot[arrival, d] = b_slot[(s, c)]

    # true peak: max simultaneously banked stage inputs across all devices
    delta = np.zeros(T + 2, dtype=np.int64)
    for d in range(D):
        for arrival, release, _ in f_entries[d]:
            delta[arrival] += 1
            delta[release + 1] -= 1
    peak = int(np.cumsum(delta).max()) if T else 0

    return LoweredTimeline(
        num_stages=S,
        num_chunks=C,
        num_devices=D,
        num_ticks=T,
        phase=phase,
        stage=stage,
        chunk=chunk,
        work_fslot=work_fslot,
        in_fslot=in_fslot,
        work_bslot=work_bslot,
        in_bslot=in_bslot,
        work_wslot=work_wslot,
        store_wslot=store_wslot,
        n_fslots=n_fslots,
        n_bslots=n_bslots,
        n_wslots=n_wslots,
        peak_live_stash=peak,
        wire_latency=wire_latency,
    )


# ------------------------------------------------------- list scheduler --


def _stage_cost_vector(cost, num_stages: int) -> list[float]:
    """Normalize a scalar-or-per-stage cost to a length-S list of floats."""
    if np.ndim(cost) == 0:
        out = [float(cost)] * num_stages
    else:
        out = [float(c) for c in cost]
        if len(out) != num_stages:
            raise ValueError(
                f"per-stage cost vector has {len(out)} entries for "
                f"{num_stages} stages"
            )
    if any(c < 0 for c in out):
        raise ValueError(f"per-stage costs must be >= 0, got {out}")
    return out


def _greedy_timeline(
    num_stages: int,
    num_chunks: int,
    *,
    device_of,
    fwd_window,
    fwd_cost=1.0,
    bwd_cost=1.0,
):
    """Greedy list scheduler over the pipeline DAG.

    Per-stage op streams are FIFO in chunk order (fwds in order, bwds in
    order); dependencies are

        fwd(s, c)  after  fwd(s-1, c)
        bwd(s, c)  after  bwd(s+1, c)        (loss grad at s = S-1: after
                                              fwd(S-1, c))
        fwd(s, c)  after  bwd(s, c - fwd_window(s))   # 1F1B memory window

    The window dependency caps in-flight activations at stage s to
    ``fwd_window(s)``; with window = S - s this greedy ASAP scheduler emits
    exactly the synchronous 1F1B schedule (a window >= C removes the memory
    cap). Backwards win ties so the drain starts as early as possible.
    ``fwd_cost``/``bwd_cost`` may be scalars (balanced partition) or
    per-stage vectors (heterogeneous stage costs). Returns (ops, makespan)
    where ops maps (stage, chunk, phase) -> (start, end) in cost units.
    """
    S, C = num_stages, num_chunks
    fwd_cost = _stage_cost_vector(fwd_cost, S)
    bwd_cost = _stage_cost_vector(bwd_cost, S)
    done: dict[tuple[int, int, str], tuple[float, float]] = {}
    fwd_next = [0] * S
    bwd_next = [0] * S
    free_by_dev: dict[int, float] = {}
    for s in range(S):
        free_by_dev.setdefault(device_of(s), 0.0)

    n_total = 2 * S * C
    while len(done) < n_total:
        best = None
        for s in range(S):
            dev = device_of(s)
            # candidate backward
            c = bwd_next[s]
            if c < C:
                dep = ((S - 1, c, "fwd") if s == S - 1 else (s + 1, c, "bwd"))
                if dep in done:
                    start = max(free_by_dev[dev], done[dep][1])
                    cand = (start, 0, s, c)
                    if best is None or cand < best[0]:
                        best = (cand, s, c, "bwd", dev)
            # candidate forward
            c = fwd_next[s]
            if c < C:
                ready = 0.0
                ok = True
                if s > 0:
                    dep = (s - 1, c, "fwd")
                    if dep not in done:
                        ok = False
                    else:
                        ready = done[dep][1]
                w = fwd_window(s)
                if ok and c - w >= 0:
                    dep = (s, c - w, "bwd")
                    if dep not in done:
                        ok = False
                    else:
                        ready = max(ready, done[dep][1])
                if ok:
                    start = max(free_by_dev[dev], ready)
                    cand = (start, 1, s, c)
                    if best is None or cand < best[0]:
                        best = (cand, s, c, "fwd", dev)
        assert best is not None, "scheduler stalled (dependency cycle?)"
        (start, _, _, _), s, c, phase, dev = best
        cost = fwd_cost[s] if phase == "fwd" else bwd_cost[s]
        done[(s, c, phase)] = (start, start + cost)
        free_by_dev[dev] = start + cost
        if phase == "fwd":
            fwd_next[s] += 1
        else:
            bwd_next[s] += 1

    makespan = max(end for _, end in done.values())
    return done, makespan


def _ordered_timeline(
    streams: dict[int, list[tuple[str, int, int]]],
    num_stages: int,
    *,
    fwd_cost=1.0,
    bwd_cost=1.0,
):
    """ASAP tick assignment for per-device *fixed* op streams.

    ``streams[d]`` is device d's op sequence as (phase, stage, chunk); data
    dependencies are the pipeline DAG (fwd chain, bwd chain, loss at the last
    stage). Each step schedules the earliest-startable stream head. Costs may
    be scalars or per-stage vectors. Returns (ops, makespan) like
    ``_greedy_timeline``."""
    S = num_stages
    fwd_cost = _stage_cost_vector(fwd_cost, S)
    bwd_cost = _stage_cost_vector(bwd_cost, S)
    done: dict[tuple[int, int, str], tuple[float, float]] = {}
    ptr = {d: 0 for d in streams}
    free = {d: 0.0 for d in streams}
    total = sum(len(v) for v in streams.values())
    while len(done) < total:
        best = None
        for d, ops in streams.items():
            if ptr[d] >= len(ops):
                continue
            phase, s, c = ops[ptr[d]]
            if phase == "fwd":
                dep = (s - 1, c, "fwd") if s > 0 else None
            else:
                dep = (S - 1, c, "fwd") if s == S - 1 else (s + 1, c, "bwd")
            if dep is not None and dep not in done:
                continue
            start = max(free[d], done[dep][1] if dep else 0.0)
            cand = (start, d)
            if best is None or cand < best[0]:
                best = (cand, d, phase, s, c)
        assert best is not None, "scheduler stalled: stream order deadlocks"
        (start, _), d, phase, s, c = best
        cost = fwd_cost[s] if phase == "fwd" else bwd_cost[s]
        done[(s, c, phase)] = (start, start + cost)
        free[d] = start + cost
        ptr[d] += 1
    makespan = max(end for _, end in done.values())
    return done, makespan


def _ops_to_items(ops, device_of) -> list[WorkItem]:
    items = [
        WorkItem(int(round(start)), s, c, phase, device_of(s))
        for (s, c, phase), (start, _) in ops.items()
    ]
    return sorted(items, key=_sort_key)


# ---------------------------------------------------------- the classes --


class Schedule(abc.ABC):
    """A pipeline schedule: emits a WorkItem timeline plus its accounting."""

    name: str = "abstract"

    @abc.abstractmethod
    def timeline(self, num_stages: int, num_chunks: int) -> list[WorkItem]:
        """Tick-accurate (unit fwd/bwd cost) timeline, sorted canonically."""

    def num_devices(self, num_stages: int) -> int:
        """Physical devices the schedule places ``num_stages`` stages on."""
        return num_stages

    def device_of(self, stage: int, num_stages: int) -> int:
        """Physical device hosting ``stage`` (identity by default)."""
        return stage

    def ticks(self, num_stages: int, num_chunks: int) -> int:
        """Makespan of the unit-cost timeline in ticks."""
        return max(it.tick for it in self.timeline(num_stages, num_chunks)) + 1

    def bubble_fraction(self, num_stages: int, num_chunks: int) -> float:
        """Idle fraction across devices for the unit-cost timeline: the
        timeline's unit work items (2·S·C fused, 3·S·C split-backward) out
        of D·T tick-slots."""
        tl = self.timeline(num_stages, num_chunks)
        T = max(it.tick for it in tl) + 1
        D = self.num_devices(num_stages)
        return 1.0 - len(tl) / (D * T)

    def peak_live_activations(self, num_stages: int, num_chunks: int) -> int:
        """Max simultaneously stashed chunk inputs across stages."""
        return peak_live_activations(self.timeline(num_stages, num_chunks))

    def predicted_step_time(
        self,
        num_stages: int,
        num_chunks: int,
        *,
        fwd_cost_per_chunk: float | None = None,
        bwd_cost_per_chunk: float | None = None,
        transfer_cost: float = 0.0,
        rebuild_cost_per_chunk: float = 0.0,
        stage_fwd_costs=None,
        stage_bwd_costs=None,
    ) -> float:
        """Analytic step time: the makespan of the schedule's DAG under
        per-stage per-chunk costs, plus the paper's host-side rebuild term.

        Costs come either from the balanced-partition model —
        ``fwd_cost_per_chunk / num_stages`` (+ transfer) per stage, the
        paper's Fig 3 assumption — or, when ``stage_fwd_costs`` /
        ``stage_bwd_costs`` are given, from an explicit per-stage cost
        vector (e.g. the profiler's measured stage sums): real GNN stacks
        are heterogeneous, the slowest stage sets the tick, and the
        balanced model silently diverges from measurement there."""
        f = self._stage_vec(
            stage_fwd_costs, fwd_cost_per_chunk, num_stages, transfer_cost, "fwd"
        )
        b = self._stage_vec(
            stage_bwd_costs, bwd_cost_per_chunk, num_stages, transfer_cost, "bwd"
        )
        _, makespan = self._weighted(num_stages, num_chunks, f, b)
        return makespan + num_chunks * rebuild_cost_per_chunk

    @staticmethod
    def _stage_vec(stage_costs, cost_per_chunk, S, transfer_cost, what):
        if stage_costs is None:
            if cost_per_chunk is None:
                raise ValueError(
                    f"need {what}_cost_per_chunk or stage_{what}_costs"
                )
            stage_costs = cost_per_chunk / S
        return [c + transfer_cost for c in _stage_cost_vector(stage_costs, S)]

    def _weighted(self, S, C, f, b):
        raise NotImplementedError

    def describe(self, num_stages: int, num_chunks: int) -> dict:
        """Name + derived stats bundle for logs and benchmark tables."""
        return {
            "schedule": self.name,
            "num_stages": num_stages,
            "num_chunks": num_chunks,
            "num_devices": self.num_devices(num_stages),
            "ticks": self.ticks(num_stages, num_chunks),
            "bubble_fraction": self.bubble_fraction(num_stages, num_chunks),
            "peak_live_activations": self.peak_live_activations(num_stages, num_chunks),
        }


class FillDrainSchedule(Schedule):
    """GPipe: C+S-1 forward ticks, then C+S-1 backward ticks (the paper)."""

    name = "fill_drain"

    def timeline(self, num_stages: int, num_chunks: int) -> list[WorkItem]:
        """All-forwards wave then all-backwards wave (GPipe's order)."""
        S, C = num_stages, num_chunks
        items: list[WorkItem] = []
        # forward: stage s handles chunk c at tick c + s
        for t in range(C + S - 1):
            for s in range(S):
                c = t - s
                if 0 <= c < C:
                    items.append(WorkItem(t, s, c, "fwd"))
        off = C + S - 1
        # backward: reverse stage order; stage s handles chunk c at tick
        # off + (C - 1 - c) + (S - 1 - s)
        for t in range(C + S - 1):
            for s in range(S):
                c = (C - 1) - (t - (S - 1 - s))
                if 0 <= c < C:
                    items.append(WorkItem(off + t, s, c, "bwd"))
        return sorted(items, key=_sort_key)

    def ticks(self, num_stages: int, num_chunks: int) -> int:
        """Closed form: 2 (C + S - 1)."""
        return 2 * (num_chunks + num_stages - 1)

    def bubble_fraction(self, num_stages: int, num_chunks: int) -> float:
        """GPipe's (S - 1) / (C + S - 1)."""
        return (num_stages - 1) / (num_chunks + num_stages - 1)

    def peak_live_activations(self, num_stages: int, num_chunks: int) -> int:
        """S * C: every stage holds all C inputs when the forward ends."""
        return num_stages * num_chunks

    def predicted_step_time(
        self,
        num_stages: int,
        num_chunks: int,
        *,
        fwd_cost_per_chunk: float | None = None,
        bwd_cost_per_chunk: float | None = None,
        transfer_cost: float = 0.0,
        rebuild_cost_per_chunk: float = 0.0,
        stage_fwd_costs=None,
        stage_bwd_costs=None,
    ) -> float:
        """Closed-form fill-drain makespan for uniform stages; falls back
        to the generic weighted makespan when per-stage costs differ."""
        if stage_fwd_costs is not None or stage_bwd_costs is not None:
            # heterogeneous stages: no closed form — the generic weighted
            # makespan over fill-drain's fixed per-device op streams
            return super().predicted_step_time(
                num_stages,
                num_chunks,
                fwd_cost_per_chunk=fwd_cost_per_chunk,
                bwd_cost_per_chunk=bwd_cost_per_chunk,
                transfer_cost=transfer_cost,
                rebuild_cost_per_chunk=rebuild_cost_per_chunk,
                stage_fwd_costs=stage_fwd_costs,
                stage_bwd_costs=stage_bwd_costs,
            )
        if fwd_cost_per_chunk is None or bwd_cost_per_chunk is None:
            raise ValueError("need fwd/bwd_cost_per_chunk or stage_fwd/bwd_costs")
        # closed form (the paper's model): critical path is C + S - 1 ticks
        # in each phase
        f = fwd_cost_per_chunk / num_stages + transfer_cost
        b = bwd_cost_per_chunk / num_stages + transfer_cost
        ticks = num_chunks + num_stages - 1
        return ticks * (f + b) + num_chunks * rebuild_cost_per_chunk

    def _weighted(self, S, C, f, b):
        # fill-drain's per-device streams: all C forwards in chunk order,
        # then all C backwards in drain (descending-chunk) order
        streams = {
            s: [("fwd", s, c) for c in range(C)]
            + [("bwd", s, c) for c in reversed(range(C))]
            for s in range(S)
        }
        return _ordered_timeline(streams, S, fwd_cost=f, bwd_cost=b)


class OneFOneBSchedule(Schedule):
    """Synchronous 1F1B (PipeDream-flush): stage s runs min(S-s, C) warmup
    forwards then strictly alternates bwd/fwd, capping live activations at
    min(S-s, C) instead of C. Same optimizer semantics as fill-drain (one
    flush per step); same bubble for equal tick costs; far less memory."""

    name = "1f1b"

    def _ops(self, S, C, f=1.0, b=1.0):
        return _greedy_timeline(
            S, C, device_of=lambda s: s, fwd_window=lambda s: S - s,
            fwd_cost=f, bwd_cost=b,
        )

    def timeline(self, num_stages: int, num_chunks: int) -> list[WorkItem]:
        """1F1B order: warmup forwards, strict alternation, drain."""
        ops, _ = self._ops(num_stages, num_chunks)
        return _ops_to_items(ops, lambda s: s)

    def _weighted(self, S, C, f, b):
        return self._ops(S, C, f, b)


class InterleavedSchedule(Schedule):
    """Interleaved 1F1B over virtual stages (Megatron-LM's interleaving):
    ``num_physical`` devices each host V = S/num_physical virtual stages,
    stage k on device k mod num_physical; activations hop circularly. Each
    device runs (D-d-1)·2 + (V-1)·D warmup forwards in D-microbatch groups
    round-robinned over its virtual stages, then strict 1F1B, then drains.
    Requires C >= D and C % D == 0 (Megatron's constraint) for a stall-free
    steady state; the unit-cost makespan is then exactly 2·(V·C + D - 1)
    ticks — bubble (D-1)/(V·C+D-1), the fill-drain bubble divided by ~V —
    while holding far fewer live activations than interleaved fill-drain."""

    name = "interleaved"

    def __init__(self, num_physical: int):
        if num_physical < 1:
            raise ValueError(f"num_physical must be >= 1, got {num_physical}")
        self.num_physical = num_physical

    def num_devices(self, num_stages: int) -> int:
        """The configured physical-device count (V stages share each)."""
        return self.num_physical

    def device_of(self, stage: int, num_stages: int) -> int:
        """Round-robin: virtual stage k lives on device k mod D."""
        return stage % self.num_physical

    def _check(self, S, C):
        D = self.num_physical
        if S % D != 0:
            raise ValueError(
                f"interleaved schedule needs num_stages ({S}) divisible by "
                f"num_physical devices ({D})"
            )
        if C < D or C % D != 0:
            raise ValueError(
                f"interleaved schedule needs num_chunks ({C}) a positive "
                f"multiple of num devices ({D})"
            )

    def _streams(self, S, C):
        """Per-device op sequences: microbatches advance in groups of D;
        within a group the device cycles its V virtual stages (fwd ascending,
        bwd descending), giving Megatron's interleaved order."""
        D = self.num_physical
        V = S // D
        n = C * V  # fwd (and bwd) ops per device
        streams: dict[int, list[tuple[str, int, int]]] = {}
        for d in range(D):
            seq_f = []
            seq_b = []
            for i in range(n):
                vf = (i // D) % V
                mb = (i // (D * V)) * D + (i % D)
                seq_f.append(("fwd", vf * D + d, mb))
                vb = V - 1 - vf
                seq_b.append(("bwd", vb * D + d, mb))
            warm = min((D - d - 1) * 2 + (V - 1) * D, n)
            ops = list(seq_f[:warm])
            for k in range(n - warm):
                ops.append(seq_f[warm + k])
                ops.append(seq_b[k])
            ops.extend(seq_b[n - warm:])
            streams[d] = ops
        return streams

    def _ops(self, S, C, f=1.0, b=1.0):
        self._check(S, C)
        return _ordered_timeline(self._streams(S, C), S, fwd_cost=f, bwd_cost=b)

    def timeline(self, num_stages: int, num_chunks: int) -> list[WorkItem]:
        """Megatron's interleaved 1F1B over V virtual stages per device."""
        ops, _ = self._ops(num_stages, num_chunks)
        D = self.num_physical
        return _ops_to_items(ops, lambda s: s % D)

    def _weighted(self, S, C, f, b):
        return self._ops(S, C, f, b)


class ZeroBubbleH1Schedule(Schedule):
    """Zero-bubble H1 (Qi et al., 2023): the backward splits into B
    (input-grad — the only half on the inter-stage critical path) and W
    (weight-grad — needed only by the end-of-step optimizer update). The B
    stream keeps 1F1B's ordering and its min(S-s, C) activation window (B
    frees the stage input into the W residual), while W items fill ticks
    their device would otherwise idle through — the drain bubble becomes W
    work. Emitted via a greedy list scheduler with per-device priority
    B > F > W; with unit costs the makespan is 3C + S - 1 ticks for 3C unit
    ops per device, so the bubble drops to (S-1)/(3C+S-1) — strictly below
    1F1B's (S-1)/(C+S-1) whenever there is a bubble at all."""

    name = "zb-h1"

    def _ops(self, S, C, f=1.0, b=1.0, w=1.0):
        done: dict[tuple[int, int, str], tuple[float, float]] = {}
        nxt = {"fwd": [0] * S, "bwd_b": [0] * S, "bwd_w": [0] * S}
        free = {s: 0.0 for s in range(S)}  # device == stage
        cost = {
            "fwd": _stage_cost_vector(f, S),
            "bwd_b": _stage_cost_vector(b, S),
            "bwd_w": _stage_cost_vector(w, S),
        }
        n_total = 3 * S * C
        while len(done) < n_total:
            best = None
            for s in range(S):
                # candidate B (priority 0: the drain's critical path)
                c = nxt["bwd_b"][s]
                if c < C:
                    deps = [(s, c, "fwd")]
                    deps.append((S - 1, c, "fwd") if s == S - 1 else (s + 1, c, "bwd_b"))
                    if all(d in done for d in deps):
                        start = max([free[s]] + [done[d][1] for d in deps])
                        cand = ((start, 0, s, c), s, c, "bwd_b")
                        if best is None or cand[0] < best[0]:
                            best = cand
                # candidate F (priority 1), 1F1B's S - s in-flight window —
                # the window dep is on B: the input-grad half frees the slot
                c = nxt["fwd"][s]
                if c < C:
                    deps = []
                    if s > 0:
                        deps.append((s - 1, c, "fwd"))
                    if c - (S - s) >= 0:
                        deps.append((s, c - (S - s), "bwd_b"))
                    if all(d in done for d in deps):
                        start = max([free[s]] + [done[d][1] for d in deps])
                        cand = ((start, 1, s, c), s, c, "fwd")
                        if best is None or cand[0] < best[0]:
                            best = cand
                # candidate W (priority 2: pure bubble filler)
                c = nxt["bwd_w"][s]
                if c < C and (s, c, "bwd_b") in done:
                    start = max(free[s], done[(s, c, "bwd_b")][1])
                    cand = ((start, 2, s, c), s, c, "bwd_w")
                    if best is None or cand[0] < best[0]:
                        best = cand
            assert best is not None, "zb-h1 scheduler stalled (dependency cycle?)"
            (start, _, _, _), s, c, phase = best
            done[(s, c, phase)] = (start, start + cost[phase][s])
            free[s] = start + cost[phase][s]
            nxt[phase][s] += 1
        makespan = max(end for _, end in done.values())
        return done, makespan

    def timeline(self, num_stages: int, num_chunks: int) -> list[WorkItem]:
        """1F1B's F/B order with every backward split into B then a
        bubble-filling deferred W (zero-bubble H1)."""
        ops, _ = self._ops(num_stages, num_chunks)
        return _ops_to_items(ops, lambda s: s)

    def predicted_step_time(
        self,
        num_stages: int,
        num_chunks: int,
        *,
        fwd_cost_per_chunk: float | None = None,
        bwd_cost_per_chunk: float | None = None,
        transfer_cost: float = 0.0,
        rebuild_cost_per_chunk: float = 0.0,
        stage_fwd_costs=None,
        stage_bwd_costs=None,
        stage_bwd_b_costs=None,
        stage_bwd_w_costs=None,
    ) -> float:
        """Weighted zb-h1 makespan with the B/W split costed separately."""
        # the wire hop belongs to B alone — W consumes a local residual and
        # sends nothing, so it carries no transfer term. The B/W split is
        # the MEASURED one when the caller provides both halves (the
        # profiler does); otherwise the fused backward's compute is assumed
        # to split evenly
        S, C = num_stages, num_chunks
        f = self._stage_vec(
            stage_fwd_costs, fwd_cost_per_chunk, S, transfer_cost, "fwd"
        )
        if stage_bwd_b_costs is not None or stage_bwd_w_costs is not None:
            if stage_bwd_b_costs is None or stage_bwd_w_costs is None:
                raise ValueError(
                    "stage_bwd_b_costs and stage_bwd_w_costs go together"
                )
            b = [c + transfer_cost for c in _stage_cost_vector(stage_bwd_b_costs, S)]
            w = _stage_cost_vector(stage_bwd_w_costs, S)
        else:
            bwd = self._stage_vec(stage_bwd_costs, bwd_cost_per_chunk, S, 0.0, "bwd")
            b = [c * 0.5 + transfer_cost for c in bwd]
            w = [c * 0.5 for c in bwd]
        _, makespan = self._ops(S, C, f, b, w)
        return makespan + C * rebuild_cost_per_chunk


class ZeroBubbleVSchedule(ZeroBubbleH1Schedule):
    """Zero-bubble V (after Qi et al.'s ZB-V shape): zb-h1's split backward
    COMPOSED with interleaving — ``num_physical`` devices each host
    V = S/num_physical virtual stages placed round-robin (stage k on device
    k mod D, the same circular hop ``lower_timeline`` routes for the
    interleaved schedule), and every backward splits into the critical-path
    B half and the bubble-filling deferred W half. Interleaving divides the
    warmup bubble by ~V while the W stream soaks up the drain bubble, so
    both ends of the step shrink at once.

    Note the honest departure from the paper's letter: ZB-V's literal
    placement folds the stage chain back on itself (device d hosts stages d
    and 2D-1-d), which is NOT ring-compatible — the compiled executors route
    exactly one ``ppermute`` ring, and ``lower_timeline`` rejects any
    placement where stage s+1 is not one hop downstream of stage s. The
    round-robin V-stage placement keeps the paper's two bubble levers
    (interleaving + B/W split) inside the ring contract, so zb-v runs
    unmodified through both engines, every ``Placement`` rotation, and the
    double-buffered overlap executors, bit-identical to host fill-drain.

    Scheduling is the same greedy list scheduler as zb-h1 (per-device
    priority B > F > W, 1F1B's S-s in-flight window on the B that frees each
    stage input), with the device free-time shared by all virtual stages a
    device hosts. Requires S % D == 0; unlike interleaved's fixed streams
    the greedy scheduler needs no chunk-count constraint."""

    name = "zb-v"

    def __init__(self, num_physical: int):
        if num_physical < 1:
            raise ValueError(f"num_physical must be >= 1, got {num_physical}")
        self.num_physical = num_physical

    def num_devices(self, num_stages: int) -> int:
        """The configured physical-device count (V stages share each)."""
        return self.num_physical

    def device_of(self, stage: int, num_stages: int) -> int:
        """Round-robin: virtual stage k lives on device k mod D."""
        return stage % self.num_physical

    def _check(self, S):
        D = self.num_physical
        if S % D != 0:
            raise ValueError(
                f"zb-v schedule needs num_stages ({S}) divisible by "
                f"num_physical devices ({D})"
            )

    def _ops(self, S, C, f=1.0, b=1.0, w=1.0):
        self._check(S)
        D = self.num_physical
        dev_of = lambda s: s % D  # noqa: E731
        done: dict[tuple[int, int, str], tuple[float, float]] = {}
        nxt = {"fwd": [0] * S, "bwd_b": [0] * S, "bwd_w": [0] * S}
        free = {d: 0.0 for d in range(D)}  # shared by the device's V stages
        cost = {
            "fwd": _stage_cost_vector(f, S),
            "bwd_b": _stage_cost_vector(b, S),
            "bwd_w": _stage_cost_vector(w, S),
        }
        n_total = 3 * S * C
        while len(done) < n_total:
            best = None
            for s in range(S):
                dev = dev_of(s)
                # candidate B (priority 0: the drain's critical path)
                c = nxt["bwd_b"][s]
                if c < C:
                    deps = [(s, c, "fwd")]
                    deps.append((S - 1, c, "fwd") if s == S - 1 else (s + 1, c, "bwd_b"))
                    if all(d in done for d in deps):
                        start = max([free[dev]] + [done[d][1] for d in deps])
                        cand = ((start, 0, s, c), s, c, "bwd_b")
                        if best is None or cand[0] < best[0]:
                            best = cand
                # candidate F (priority 1), 1F1B's S - s in-flight window on B
                c = nxt["fwd"][s]
                if c < C:
                    deps = []
                    if s > 0:
                        deps.append((s - 1, c, "fwd"))
                    if c - (S - s) >= 0:
                        deps.append((s, c - (S - s), "bwd_b"))
                    if all(d in done for d in deps):
                        start = max([free[dev]] + [done[d][1] for d in deps])
                        cand = ((start, 1, s, c), s, c, "fwd")
                        if best is None or cand[0] < best[0]:
                            best = cand
                # candidate W (priority 2: pure bubble filler)
                c = nxt["bwd_w"][s]
                if c < C and (s, c, "bwd_b") in done:
                    start = max(free[dev], done[(s, c, "bwd_b")][1])
                    cand = ((start, 2, s, c), s, c, "bwd_w")
                    if best is None or cand[0] < best[0]:
                        best = cand
            assert best is not None, "zb-v scheduler stalled (dependency cycle?)"
            (start, _, _, _), s, c, phase = best
            done[(s, c, phase)] = (start, start + cost[phase][s])
            free[dev_of(s)] = start + cost[phase][s]
            nxt[phase][s] += 1
        makespan = max(end for _, end in done.values())
        return done, makespan

    def timeline(self, num_stages: int, num_chunks: int) -> list[WorkItem]:
        """Interleaved round-robin placement with every backward split into
        B then a bubble-filling deferred W (the ring-compatible zb-v)."""
        ops, _ = self._ops(num_stages, num_chunks)
        D = self.num_physical
        return _ops_to_items(ops, lambda s: s % D)


# -------------------------------------------------------------- registry --

SCHEDULES = ("fill_drain", "gpipe", "1f1b", "interleaved", "zb-h1", "zb-v")


def get_schedule(name: str, *, num_devices: int | None = None) -> Schedule:
    """Schedule factory. ``num_devices`` is the physical device count for
    ``interleaved`` and ``zb-v`` (stages are placed round-robin on them);
    other schedules place one stage per device and ignore it."""
    if name in ("fill_drain", "gpipe"):
        return FillDrainSchedule()
    if name == "1f1b":
        return OneFOneBSchedule()
    if name in ("zb-h1", "zb_h1"):
        return ZeroBubbleH1Schedule()
    if name == "interleaved":
        if num_devices is None:
            raise ValueError("interleaved schedule requires num_devices")
        return InterleavedSchedule(num_devices)
    if name in ("zb-v", "zb_v"):
        if num_devices is None:
            raise ValueError("zb-v schedule requires num_devices")
        return ZeroBubbleVSchedule(num_devices)
    raise KeyError(f"unknown schedule {name!r}; valid registry: {SCHEDULES}")


# ------------------------------------------- fill-drain shorthand (paper) --


def fill_drain_timeline(num_stages: int, num_chunks: int) -> list[WorkItem]:
    """The paper's fill-drain timeline (module-level shorthand)."""
    return FillDrainSchedule().timeline(num_stages, num_chunks)


def forward_timeline(num_stages: int, num_chunks: int) -> list[WorkItem]:
    """Inference/eval timeline: the fill-drain forward wave only (stage s
    runs chunk c at tick c + s; C + S - 1 ticks, no backward). Lower with
    ``lower_timeline(..., forward_only=True)`` for the compiled eval path."""
    return [
        it
        for it in FillDrainSchedule().timeline(num_stages, num_chunks)
        if it.phase == "fwd"
    ]


def bubble_fraction(num_stages: int, num_chunks: int) -> float:
    """Idle fraction of the synchronous fill-drain schedule (per GPipe)."""
    return FillDrainSchedule().bubble_fraction(num_stages, num_chunks)


def predicted_step_time(
    num_stages: int,
    num_chunks: int,
    *,
    fwd_cost_per_chunk: float,
    bwd_cost_per_chunk: float,
    transfer_cost: float = 0.0,
    rebuild_cost_per_chunk: float = 0.0,
) -> float:
    """Analytic fill-drain step time with per-chunk stage costs.

    Per-stage per-chunk cost is cost/num_stages (balanced partition);
    the critical path runs (C + S - 1) ticks each phase. The paper's observed
    slowdown is the ``rebuild_cost_per_chunk * C`` term (host-side sub-graph
    rebuilds) dominating at small graph scale."""
    return FillDrainSchedule().predicted_step_time(
        num_stages,
        num_chunks,
        fwd_cost_per_chunk=fwd_cost_per_chunk,
        bwd_cost_per_chunk=bwd_cost_per_chunk,
        transfer_cost=transfer_cost,
        rebuild_cost_per_chunk=rebuild_cost_per_chunk,
    )
