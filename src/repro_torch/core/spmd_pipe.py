"""Tick executors of the compiled engine: the lanes of one device, and the
ring across ranks; and the LM stage ring.

Counterpart of ``repro.core.spmd_pipe``'s scheduled executors. Every
executor runs a timeline lowered to the per-tick slot arrays of
``repro_torch.core.schedule.LoweredTimeline``; device (ring position) d
runs column d of those arrays.

  * ``spmd_pipeline_scheduled_lanes`` / ``spmd_pipeline_scheduled_eval_lanes``
    run every column in one program on one device: the schedule's devices
    become *lanes*, each with its own preallocated stashes, and the ring
    hop is a rotation of the lanes' outputs.
  * ``spmd_pipeline_scheduled`` / ``spmd_pipeline_scheduled_eval`` run on
    a ring of ranks (``repro_torch.core.ranks.RankGrid``): each rank runs
    its own column of the same global arrays, and the hop is a
    ``torch.distributed.batch_isend_irecv`` with both directions of a tick
    in one group.

Both share the per-tick logic (``_Column``: the banks and the inputs of a
column's work; ``_run_ticks``: bank, post, work); only the wires differ.

The slot arrays are numpy, so ticks, columns, phases and slots are Python
ints while the program runs. Each tick therefore dispatches only its real
work items: an idle column does nothing, and a value the lowering routes to
a sacrificial slot (fill/drain garbage) is never written, nor sent. Run
under a CUDA graph capture (``repro_torch.core.cuda_graph``), the whole
lanes timeline becomes one graph.

Wire latency (``lowered.wire_latency``, the reference's wire-parity rule):
at latency 1 a tick's outputs are banked by the neighbour at the next
tick. At latency 2 (a timeline retimed by ``schedule.retime_timeline``)
the train executors run the double-buffered dataflow: a tick

  1. banks what arrived (the outputs of tick t-2),
  2. posts the pending outputs of tick t-1 to the neighbours,
  3. runs its work, and
  4. parks its own outputs as the next pending.

On one card the post is a device copy into the neighbour lane's buffer of
tick parity ``t % 2``, on a wire stream of its own, forked from the current
stream after the tick's banks and joined by an event before the next
tick's banks, so the copy runs beside the tick's work. On ranks the post
is the tick's ``batch_isend_irecv``, waited on before the next tick's banks:
NCCL's own stream is the wire. On the CPU the same code runs on the one
stream. Banked values, stash traffic and the gradient order are the
latency-1 ones, so the update is bit-identical. The eval executors take
latency 1 only, as the reference's do.

The LM steps (``models/transformer/model.py``) run ``spmd_pipeline`` and
``spmd_pipeline_interleaved`` (``repro.core.spmd_pipe:88,194``) over a
``StageRing``: fill-drain or circular placement, one position per rank
(or every position in one process), an activation hop per tick, and
``spmd_pipeline_backward``, the same ticks in reverse, which carries each
stage input's cotangent back (autograd does not cross a point-to-point
op). Both sides of every hop read the ring's tick arithmetic, so sends
and receives pair as the scheduled ring's do.

**Pairing on ranks.** A rank sends a value only where the lowering banks it
into a real slot of the neighbour at the next tick, and posts a receive
only where it banks one itself; both sides read that from the same arrays,
so every send has its receive. An unpaired point-to-point op hangs NCCL
rather than raising. With two ranks both neighbours are one peer: the
forward direction's ops precede the backward's in every group, so NCCL
pairs them in that order (gloo by their tags).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.schedule import PHASE_FWD, PHASE_IDLE, LoweredTimeline

_TAG_F, _TAG_B = 0, 1  # the forward and backward wires' P2P tags (gloo matches by tag)


def _stash(n_slots: int, wire_like: torch.Tensor) -> torch.Tensor:
    # slot n_slots is the lowering's sacrificial slot; it is allocated as in
    # the reference but nothing writes or reads it here
    return wire_like.new_zeros((n_slots + 1,) + tuple(wire_like.shape))


class _Column:
    """One device column of a lowered timeline: its stashes, the banks of
    what arrives on its wires, and the inputs its work items read. The
    lanes executors keep one per lane; a rank of the ring keeps its own."""

    def __init__(self, lowered: LoweredTimeline, d: int, wire_like: torch.Tensor):
        self.lw, self.d = lowered, d
        self.n_f, self.n_b, self.n_w = lowered.n_fslots, lowered.n_bslots, lowered.n_wslots
        self.fstash = _stash(self.n_f, wire_like)
        self.bstash = _stash(self.n_b, wire_like) if self.n_b else None
        self.wstash = (_stash(self.n_w, wire_like), _stash(self.n_w, wire_like)) \
            if self.n_w else None

    def bank(self, t: int, wire_f, wire_b) -> None:
        """Bank tick ``t``'s arrivals into the slots the lowering gave them."""
        for stash, slot, sacrificial, value in (
            (self.fstash, int(self.lw.in_fslot[t, self.d]), self.n_f, wire_f),
            (self.bstash, int(self.lw.in_bslot[t, self.d]), self.n_b, wire_b),
        ):
            if slot != sacrificial:
                if value is None:
                    raise RuntimeError(f"tick {t} banks a wire that carries no value")
                stash[slot].copy_(value)

    def item(self, t: int):
        """``(phase, stage, chunk, h_in, ct_in, w_res)`` of the column's work
        at tick ``t``, or None when it idles. ``h_in``/``ct_in``/``w_res``
        are None where the lowering gives the item none."""
        lw, d = self.lw, self.d
        phase = int(lw.phase[t, d])
        if phase == PHASE_IDLE:
            return None
        f_slot, b_slot = int(lw.work_fslot[t, d]), int(lw.work_bslot[t, d])
        w_slot = int(lw.work_wslot[t, d])
        h_in = self.fstash[f_slot] if f_slot != self.n_f else None
        ct_in = self.bstash[b_slot] if b_slot != self.n_b else None
        w_res = None
        if self.n_w and w_slot != self.n_w:
            w_res = (self.wstash[0][w_slot], self.wstash[1][w_slot])
        return phase, int(lw.stage[t, d]), int(lw.chunk[t, d]), h_in, ct_in, w_res

    def keep_residual(self, t: int, w_out) -> None:
        """Bank a B item's (input, cotangent) residual for its W half."""
        store = int(self.lw.store_wslot[t, self.d])
        for buf, value in zip(self.wstash, w_out):
            if value is not None:  # stage 0 banks no input
                buf[store].copy_(value)


class _GradSink:
    """Per-chunk slots of one step's gradients (flat, one row a chunk) and
    of its loss sums and counts. Each (layer, chunk) gradient has exactly
    one producer, which writes its row; the reductions then sum the chunks
    in descending order (the fill-drain drain order) and the losses in
    ascending chunk order, the host engine's orders, so every schedule's
    floats are identical. Row C is the lowering's sacrificial chunk."""

    def __init__(self, grads_like: list, num_chunks: int, wire_like: torch.Tensor):
        self.C = num_chunks
        self.layout = [(i, k, tuple(v.shape), v.numel())
                       for i, p in enumerate(grads_like) for k, v in p.items()]
        self.num_layers = len(grads_like)
        leaves = [v for p in grads_like for v in p.values()]
        like = leaves[0] if leaves else wire_like
        width = sum(n for *_, n in self.layout)
        self.g = like.new_zeros((num_chunks + 1, width))
        self.loss = wire_like.new_zeros((num_chunks + 1, 2), dtype=torch.float32)
        self.written: set[int] = set()
        self.scored: set[int] = set()

    def put(self, chunk: int, grads, loss_sum, count) -> None:
        """Record one work item's gradients (a list over the model's layers,
        None outside its stage) and, from the last stage, its loss."""
        if grads is not None:
            off = 0
            for i, k, _, n in self.layout:
                layer = grads[i]
                if layer is not None and k in layer:
                    self.g[chunk, off:off + n].copy_(layer[k].reshape(-1))
                off += n
            self.written.add(chunk)
        if loss_sum is not None:
            self.loss[chunk, 0].copy_(loss_sum)
            self.loss[chunk, 1].copy_(count)
            self.scored.add(chunk)

    @staticmethod
    def _sums(g_rows, loss_rows):
        """(flat grads, loss, count): ``g_rows`` summed in the order given,
        from zeros, and ``loss_rows`` likewise."""
        flat = None
        for row in g_rows:
            flat = row if flat is None else flat + row
        loss = count = None
        for row in loss_rows:
            loss = row[0] if loss is None else loss + row[0]
            count = row[1] if count is None else count + row[1]
        return flat, loss, count

    def local(self):
        """(flat grads, loss, count) over this sink's own chunks."""
        zero_g, zero_l = self.g.new_zeros(self.g.shape[1]), self.loss.new_zeros(2)
        return self._sums(
            [zero_g] + [self.g[c] for c in reversed(range(self.C)) if c in self.written],
            [zero_l] + [self.loss[c] for c in sorted(self.scored)],
        )

    def gathered(self, group, dp: int):
        """(flat grads, loss, count) over every replica's chunks: the rows
        of the ``dp`` replicas of ``group`` (replica r owns global chunks
        ``[r*C, (r+1)*C)``) gathered and summed in descending global chunk
        order, the losses in ascending order. Each (layer, chunk) gradient
        is nonzero on one replica only, so the sum adds zeros to it."""
        import torch.distributed as dist

        gs = [torch.empty_like(self.g) for _ in range(dp)]
        ls = [torch.empty_like(self.loss) for _ in range(dp)]
        dist.all_gather(gs, self.g, group=group)
        dist.all_gather(ls, self.loss, group=group)
        zero_g, zero_l = self.g.new_zeros(self.g.shape[1]), self.loss.new_zeros(2)
        return self._sums(
            [zero_g] + [gs[r][c] for r in reversed(range(dp)) for c in reversed(range(self.C))],
            [zero_l] + [ls[r][c] for r in range(dp) for c in range(self.C)],
        )

    def unflatten(self, flat) -> list:
        """The flat gradient as a list of per-layer dicts of views."""
        grads: list = [{} for _ in range(self.num_layers)]
        off = 0
        for i, k, shape, n in self.layout:
            grads[i][k] = flat[off:off + n].view(shape)
            off += n
        return grads


def _run_ticks(lowered: LoweredTimeline, columns: list, wires, tick_fn) -> None:
    """The tick loop every executor shares: bank what arrived, post (at
    latency 2, the last tick's outputs, before the work), run each column's
    work (``tick_fn(column, t) -> (y, d_h)``), post (at latency 1, this
    tick's outputs)."""
    outs: list = [(None, None)] * len(columns)
    for t in range(lowered.num_ticks):
        for column, (wire_f, wire_b) in zip(columns, wires.arrived(t, outs)):
            column.bank(t, wire_f, wire_b)
        if lowered.wire_latency == 2:
            wires.post(t, outs)
        outs = [tick_fn(column, t) for column in columns]
        if lowered.wire_latency == 1:
            wires.post(t, outs)


def _train_tick(work_fn, sink: _GradSink):
    """``tick_fn`` of the train executors: one work item, its residual and
    its gradients and loss into ``sink``; returns its wire outputs."""

    def tick(column: _Column, t: int):
        item = column.item(t)
        if item is None:
            return None, None
        y, d_h, w_out, grads, loss_sum, count = work_fn(*item)
        if w_out is not None:
            column.keep_residual(t, w_out)
        sink.put(item[2], grads, loss_sum, count)
        return y, d_h

    return tick


def _eval_tick(work_fn, lowered: LoweredTimeline, out: torch.Tensor):
    """``tick_fn`` of the eval executors: one forward item; a last-stage
    item writes its chunk's row of ``out``."""
    out_slot = _eval_out_slot(lowered)
    C = lowered.num_chunks

    def tick(column: _Column, t: int):
        item = column.item(t)
        if item is None:
            return None, None
        phase, stage, chunk, h_in, _, _ = item
        y = work_fn(phase, stage, chunk, h_in)
        if int(out_slot[t, column.d]) != C:
            out[int(out_slot[t, column.d])].copy_(y)
        return y, None

    return tick


def _eval_out_slot(lowered: LoweredTimeline) -> np.ndarray:
    """Per-tick output slot: last-stage forward ticks write their chunk's
    result, everything else routes to the sacrificial slot C."""
    last = (lowered.phase == PHASE_FWD) & (lowered.stage == lowered.num_stages - 1)
    return np.where(last, lowered.chunk, lowered.num_chunks).astype(np.int32)


# ------------------------------------------------------------ the lanes --


class _LaneRing:
    """The latency-1 wires of the lanes: lane d banks what lane d-1 sent
    forward and lane d+1 sent back at the last tick, straight from the
    tensors the work produced."""

    def __init__(self, num_lanes: int):
        self.D = num_lanes

    def arrived(self, t: int, outs: list) -> list:
        D = self.D
        return [(outs[(d - 1) % D][0], outs[(d + 1) % D][1]) for d in range(D)]

    def post(self, t: int, outs: list) -> None:
        pass


class _DoubleBufferedWires:
    """The latency-2 wires of the lanes: per direction and lane two
    preallocated buffers, used by tick parity. The post of tick t writes
    parity ``t % 2`` and the bank of tick t reads parity ``(t - 1) % 2``.
    With ``stream`` (a CUDA stream) the posts run there and the current
    stream waits on an event after each before the next banks; with None
    they run in line."""

    def __init__(self, lowered: LoweredTimeline, wire_like: torch.Tensor,
                 stream: "torch.cuda.Stream | None"):
        self.lowered = lowered
        self.stream = stream
        lanes = range(lowered.num_devices)
        # [direction: 0 forward, 1 backward][lane][parity]
        self.buf = [[[torch.empty_like(wire_like) for _ in range(2)] for _ in lanes]
                    for _ in range(2)]
        # the last post's event and the tensors it reads: held until the
        # bank that consumes the post, so the allocator cannot hand their
        # blocks to later work while the wire stream still reads them
        self._posted: tuple | None = None

    def arrived(self, t: int, outs: list) -> list:
        """Per lane, the (forward, backward) buffers tick ``t`` banks (the
        outputs of tick t-2), once the current stream has waited for their
        post."""
        if self._posted is not None:
            event, _held = self._posted
            torch.cuda.current_stream(self.stream.device).wait_event(event)
            self._posted = None
        parity = (t - 1) % 2
        return [(self.buf[0][d][parity], self.buf[1][d][parity])
                for d in range(self.lowered.num_devices)]

    def post(self, t: int, outs: list) -> None:
        """Copy tick t-1's outputs ``outs`` (per lane, ``y`` to lane d+1 and
        ``d_h`` to lane d-1) into parity ``t % 2`` of the neighbours'
        buffers: only those that tick t+1 banks into a real stash slot."""
        lw, D, parity = self.lowered, self.lowered.num_devices, t % 2
        if t + 1 >= lw.num_ticks:
            return
        copies = []
        for e in range(D):
            for direction, slots, sacrificial, src in (
                (0, lw.in_fslot, lw.n_fslots, outs[(e - 1) % D][0]),
                (1, lw.in_bslot, lw.n_bslots, outs[(e + 1) % D][1]),
            ):
                if int(slots[t + 1, e]) == sacrificial:
                    continue
                if src is None:
                    raise RuntimeError(f"tick {t + 1} banks a wire that carries no value")
                copies.append((self.buf[direction][e][parity], src))
        if not copies:
            return
        if self.stream is None:
            for dst, src in copies:
                dst.copy_(src)
            return
        # fork after this tick's banks were issued: the last reader of the
        # parity written here was the bank of tick t-1
        self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        with torch.cuda.stream(self.stream):
            for dst, src in copies:
                dst.copy_(src)
        event = torch.cuda.Event()
        event.record(self.stream)
        self._posted = (event, [src for _, src in copies])


def spmd_pipeline_scheduled_lanes(
    work_fn: Callable[..., tuple],
    lowered: LoweredTimeline,
    *,
    wire_like: torch.Tensor,
    grads_like: list,
    wire_stream: "torch.cuda.Stream | None" = None,
):
    """Run a lowered train timeline, its devices as lanes of one program.

    ``work_fn(phase, stage, chunk, h_in, ct_in, w_res) -> (y, d_h, w_out,
    grads, loss_sum, count)`` runs one work item. ``h_in``/``ct_in`` are the
    stash slots the item reads (None where the lowering gives it none:
    stage 0 reads its chunk's features, the last stage derives its
    cotangent from the loss); ``w_res`` is the (input, cotangent) residual
    pair a ``bwd_w`` reads. It returns None for what the item does not
    produce: ``y`` rides the forward wire to the next lane, ``d_h`` the
    backward wire to the previous one, ``w_out`` is banked for the matching
    W half, ``grads`` is a list over the model's layers (None outside the
    item's stage) and ``loss_sum``/``count`` are the last stage's loss.

    ``lowered.wire_latency`` 2 runs the double-buffered wires (module
    docstring), their posts on ``wire_stream`` (a CUDA stream), or in line
    on the current stream when it is None.

    Returns ``(grads, loss, count)``: the per-chunk gradients summed in
    descending chunk order and the losses in ascending order
    (``_GradSink``). Chunks the lowering skipped (``skip_chunks``)
    contribute nothing, as their exactly-zero gradients would."""
    if lowered.wire_latency not in (1, 2):
        raise ValueError(f"unsupported wire_latency {lowered.wire_latency}")
    wires = _LaneRing(lowered.num_devices) if lowered.wire_latency == 1 \
        else _DoubleBufferedWires(lowered, wire_like, wire_stream)
    columns = [_Column(lowered, d, wire_like) for d in range(lowered.num_devices)]
    sink = _GradSink(grads_like, lowered.num_chunks, wire_like)
    _run_ticks(lowered, columns, wires, _train_tick(work_fn, sink))
    flat, loss, count = sink.local()
    return sink.unflatten(flat), loss, count


def spmd_pipeline_scheduled_eval_lanes(
    work_fn: Callable[..., torch.Tensor],
    lowered: LoweredTimeline,
    *,
    wire_like: torch.Tensor,
) -> torch.Tensor:
    """Forward-only twin of ``spmd_pipeline_scheduled_lanes`` over a
    ``forward_only`` lowering (``forward_timeline``): the activation ring
    and its stash, no cotangents, no gradients. ``work_fn(phase, stage,
    chunk, h_in) -> y`` runs one forward item. Returns the last stage's
    outputs ``(chunks, *wire)``."""
    _check_eval_latency(lowered)
    out = _stash(lowered.num_chunks, wire_like)
    columns = [_Column(lowered, d, wire_like) for d in range(lowered.num_devices)]
    _run_ticks(lowered, columns, _LaneRing(lowered.num_devices),
               _eval_tick(work_fn, lowered, out))
    return out[: lowered.num_chunks]


def _check_eval_latency(lowered: LoweredTimeline) -> None:
    if lowered.wire_latency != 1:
        raise ValueError(
            f"wire_latency {lowered.wire_latency}: the eval executor runs at wire latency 1"
        )


# ------------------------------------------------------------- the ring --


class _RingWires:
    """The wires of a rank on the ring: per tick one ``batch_isend_irecv``
    with the forward direction's ops first (``y`` to the next position,
    ``d_h`` to the previous), posted only where the lowering banks the value
    into a real slot at tick t+1, and waited on before that tick's banks.
    Receives land in preallocated buffers, two per direction, used by tick
    parity."""

    def __init__(self, lowered: LoweredTimeline, grid, wire_like: torch.Tensor):
        if lowered.num_devices != grid.D:
            raise ValueError(
                f"the lowered timeline rings {lowered.num_devices} positions, the rank "
                f"grid {grid.D}"
            )
        if lowered.wire_latency not in (1, 2):
            raise ValueError(f"unsupported wire_latency {lowered.wire_latency}")
        self.lw, self.grid = lowered, grid
        self.buf = [[torch.empty_like(wire_like) for _ in range(2)] for _ in range(2)]
        self._pending: tuple = ([], None, None)  # (works, forward buffer, backward buffer)

    def arrived(self, t: int, outs: list) -> list:
        works, wire_f, wire_b = self._pending
        for work in works:
            work.wait()
        self._pending = ([], None, None)
        return [(wire_f, wire_b)]

    def post(self, t: int, outs: list) -> None:
        import torch.distributed as dist

        lw, grid = self.lw, self.grid
        if t + 1 >= lw.num_ticks:
            return
        (y, d_h), = outs
        d, D, parity = grid.position, grid.D, t % 2
        ops, wire_f, wire_b = [], None, None
        for send, slots, sacrificial, tag, to, frm, buf in (
            (y, lw.in_fslot, lw.n_fslots, _TAG_F, (d + 1) % D, (d - 1) % D, self.buf[0][parity]),
            (d_h, lw.in_bslot, lw.n_bslots, _TAG_B, (d - 1) % D, (d + 1) % D, self.buf[1][parity]),
        ):
            if int(slots[t + 1, to]) != sacrificial:
                if send is None:
                    raise RuntimeError(f"tick {t + 1} banks a wire that carries no value")
                ops.append(dist.P2POp(dist.isend, send.contiguous(), grid.rank_at(to), tag=tag))
            if int(slots[t + 1, d]) != sacrificial:
                ops.append(dist.P2POp(dist.irecv, buf, grid.rank_at(frm), tag=tag))
                if tag == _TAG_F:
                    wire_f = buf
                else:
                    wire_b = buf
        works = dist.batch_isend_irecv(ops) if ops else []
        self._pending = (works, wire_f, wire_b)


def spmd_pipeline_scheduled(
    work_fn: Callable[..., tuple],
    lowered: LoweredTimeline,
    *,
    wire_like: torch.Tensor,
    grads_like: list,
    grid,
):
    """Run a lowered train timeline on a ring of ranks: this rank runs
    column ``grid.position`` of the global arrays, its neighbours the
    columns beside it (``repro_torch.core.ranks.RankGrid``). ``work_fn`` is
    the lanes executor's; the hop is point-to-point (module docstring), at
    wire latency 1 or 2.

    After the ticks, with a data axis (``grid.dp`` > 1: replica r runs the
    timeline over its contiguous chunk shard), the per-chunk gradient and
    loss rows are all-gathered over ``grid.data_group`` and summed in
    descending global chunk order (losses ascending). Then grads, loss and
    count are all-reduced over ``grid.stage_group``. Each (layer, chunk)
    gradient lives on one rank, so both only add zeros to it, and the
    result on every rank is bit-identical to the lanes executor's on one
    device. Returns ``(grads, loss, count)``."""
    import torch.distributed as dist

    wires = _RingWires(lowered, grid, wire_like)
    column = _Column(lowered, grid.position, wire_like)
    sink = _GradSink(grads_like, lowered.num_chunks, wire_like)
    _run_ticks(lowered, [column], wires, _train_tick(work_fn, sink))
    if grid.dp > 1:
        flat, loss, count = sink.gathered(grid.data_group, grid.dp)
    else:
        flat, loss, count = sink.local()
    totals = torch.stack([loss, count])
    dist.all_reduce(flat, group=grid.stage_group)
    dist.all_reduce(totals, group=grid.stage_group)
    return sink.unflatten(flat), totals[0], totals[1]


def spmd_pipeline_scheduled_eval(
    work_fn: Callable[..., torch.Tensor],
    lowered: LoweredTimeline,
    *,
    wire_like: torch.Tensor,
    grid,
) -> torch.Tensor:
    """Forward-only twin of ``spmd_pipeline_scheduled``: each rank runs its
    column of a ``forward_only`` lowering at wire latency 1, and the last
    stage's per-chunk outputs ``(chunks, *wire)`` are broadcast from the
    rank hosting it over ``grid.stage_group``, so every rank returns them
    (the reference psums them: one device writes each chunk)."""
    import torch.distributed as dist

    _check_eval_latency(lowered)
    wires = _RingWires(lowered, grid, wire_like)
    out = _stash(lowered.num_chunks, wire_like)
    column = _Column(lowered, grid.position, wire_like)
    _run_ticks(lowered, [column], wires, _eval_tick(work_fn, lowered, out))
    last = (lowered.phase == PHASE_FWD) & (lowered.stage == lowered.num_stages - 1)
    position = int(np.nonzero(last)[1][0])  # the ring position hosting the last stage
    dist.broadcast(out, src=grid.rank_at(position), group=grid.stage_group)
    return out[: lowered.num_chunks]


# --------------------------------------------------- the LM stage ring --


class StageRing:
    """The static tick arithmetic of ``spmd_pipeline`` and
    ``spmd_pipeline_interleaved`` (``repro.core.spmd_pipe:88,194``):
    ``num_devices`` ring positions D, ``num_virtual`` stages V on each
    (virtual stage k = v·D + d on position d = k mod D; fill-drain is V = 1)
    and ``num_micro`` micro-batches C. At tick t position d works on
    micro-batch (t - d) mod C of round v = (t - d) // C, virtual stage
    v·D + d; the V·C + D - 1 ticks hold every (stage, micro-batch) once.

    With ``grid`` (a ``core.ranks.RankGrid``) this process holds only
    position ``grid.position`` of its replica's ring, and a stage's output
    reaches the next position by point-to-point ops; without, it holds
    every position and a hop hands the value over. ``row_of(k)`` is virtual stage k's row
    of the stacked leaves this process holds: k itself in one process, its
    round v on a rank (the reference's ``circ`` rows)."""

    def __init__(self, num_devices: int, num_virtual: int, num_micro: int, grid=None):
        D, V, C = num_devices, num_virtual, num_micro
        if V > 1 and C < D:
            raise ValueError(f"interleaved pipeline needs num_micro ({C}) >= devices ({D})")
        if grid is not None and grid.D != D:
            raise ValueError(f"a ring of {D} positions on a rank grid of {grid.dp} x {grid.D}")
        self.D, self.V, self.C, self.grid = D, V, C, grid
        self.K = D * V
        self.num_ticks = V * C + D - 1
        self.positions = tuple(range(D)) if grid is None else (grid.position,)

    def item(self, t: int, d: int) -> tuple[int, int] | None:
        """``(virtual stage, micro-batch)`` of position d at tick t, or None
        on a fill or drain tick."""
        rel = t - d
        if not 0 <= rel < self.V * self.C:
            return None
        return (rel // self.C) * self.D + d, rel % self.C

    def stages(self, d: int) -> list[int]:
        """The virtual stages position d holds, in row order."""
        return [v * self.D + d for v in range(self.V)]

    def row_of(self, k: int) -> int:
        return k if self.grid is None else k // self.D

    def holds(self, k: int) -> bool:
        """Whether this process runs virtual stage k."""
        return k % self.D in self.positions

    @property
    def last(self) -> int:
        """The position of the last virtual stage."""
        return (self.K - 1) % self.D

    def order(self) -> list[tuple[int, int]]:
        """Every (virtual stage, micro-batch) this process runs, in tick order."""
        return [it for t in range(self.num_ticks) for d in self.positions
                if (it := self.item(t, d)) is not None]


class _Hops:
    """A ring's hops: per tick, what each position sent lands in ``inbox``
    under the key of the (stage, micro-batch) that reads it. In one process
    the tensor is handed over; on ranks one ``batch_isend_irecv`` per tick
    carries the sends of this position and the receives its neighbour's
    work at the same tick implies (both sides read the same arithmetic, so
    every send has its receive; an unpaired op would hang NCCL), waited on
    before the next tick."""

    def __init__(self, ring: StageRing, wire_shape: tuple, dtype, device, forward: bool):
        self.ring, self.forward = ring, forward
        self.wire = (tuple(wire_shape), dtype, device)

    def _peer(self, k: int) -> int | None:
        """The stage that reads stage k's hop, or None when nothing does."""
        nxt = k + 1 if self.forward else k - 1
        return nxt if 0 <= nxt < self.ring.K else None

    def post(self, t: int, sent: list, inbox: dict) -> None:
        """``sent``: ``(stage, micro-batch, value)`` of this tick's work."""
        ring = self.ring
        if ring.grid is None:
            for k, m, value in sent:
                inbox[(self._peer(k), m)] = value
            return
        import torch.distributed as dist

        d, D, grid = ring.grid.position, ring.D, ring.grid
        step = 1 if self.forward else -1
        tag = _TAG_F if self.forward else _TAG_B
        ops = [dist.P2POp(dist.isend, value.contiguous(), grid.rank_at(d + step), tag=tag)
               for k, m, value in sent]
        it = ring.item(t, (d - step) % D)  # the neighbour that sends to this position
        if it is not None and self._peer(it[0]) is not None:
            shape, dtype, device = self.wire
            buf = torch.empty(shape, dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, buf, grid.rank_at(d - step), tag=tag))
            inbox[(self._peer(it[0]), it[1])] = buf
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()


def _ring_walk(ring: StageRing, fn: Callable, first: Callable, hops: _Hops, ticks) -> dict:
    """Walk ``ticks``: each held position's item (k, m) reads what the
    stage before it (forward; after it, backward) sent, or ``first(m)``
    where no stage sends to it, runs ``fn(k, m, value)`` and hops the
    result on. Returns ``{m: result}`` of the items whose result no stage
    reads (the last stage forward, stage 0 backward)."""
    inbox, outs = {}, {}
    origin = 0 if hops.forward else ring.K - 1  # the stage no hop feeds
    for t in ticks:
        sent = []
        for d in ring.positions:
            it = ring.item(t, d)
            if it is None:
                continue
            k, m = it
            value = first(m) if k == origin else inbox.pop((k, m))
            out = fn(k, m, value)
            if hops._peer(k) is None:
                outs[m] = out
            else:
                sent.append((k, m, out))
        hops.post(t, sent, inbox)
    if inbox:
        raise RuntimeError(f"the ring left {sorted(inbox)} unread")
    return outs


def spmd_pipeline_interleaved(stage_fn: Callable, inputs, ring: StageRing, *, wire_shape,
                              dtype, device) -> dict:
    """The forward of ``repro.core.spmd_pipe.spmd_pipeline_interleaved``
    over ``ring`` (any V; C >= D when V > 1): at tick t each held position
    runs ``stage_fn(k, m, h)`` on its item, h being ``inputs[m]`` for
    stage 0 and otherwise what the previous position sent, and sends the
    output on; position 0 keeps what position D-1 sends until that
    micro-batch's next round (the reference's C-slot buffer, here keyed by
    (stage, micro-batch)). ``wire_shape``/``dtype``/``device`` are one
    hop's. Returns ``{m: last stage's output}`` on the position holding the
    last stage, ``{}`` elsewhere."""
    hops = _Hops(ring, wire_shape, dtype, device, forward=True)
    return _ring_walk(ring, stage_fn, lambda m: inputs[m], hops, range(ring.num_ticks))


def spmd_pipeline(stage_fn: Callable, inputs, ring: StageRing, *, wire_shape, dtype,
                  device) -> dict:
    """The fill-drain forward of ``repro.core.spmd_pipe.spmd_pipeline``:
    ``spmd_pipeline_interleaved`` at V = 1 (tick t runs stage d on
    micro-batch t - d). ``stage_fn`` writes its micro-batch's cache slice
    in place where it has one (the reference's stateful stage)."""
    if ring.V != 1:
        raise ValueError(f"spmd_pipeline is the fill-drain ring; {ring.V} virtual stages a "
                         "position run spmd_pipeline_interleaved")
    return spmd_pipeline_interleaved(stage_fn, inputs, ring, wire_shape=wire_shape,
                                     dtype=dtype, device=device)


def spmd_pipeline_backward(backward_fn: Callable, cotangents, ring: StageRing, *, wire_shape,
                           dtype, device) -> dict:
    """The backward pipeline of either forward, which autograd cannot run
    across point-to-point ops: the ticks in reverse, each held position's
    item (k, m) running ``backward_fn(k, m, g) -> d_input`` on its output's
    cotangent g (``cotangents[m]`` for the last stage, else what the next
    stage's position sent back), and sending the input's cotangent to the
    previous stage's position. Per stage the micro-batches run C-1 down to
    0, so each stage's parameter gradients sum in descending micro-batch
    order on every ring and in one process alike. Returns ``{m: stage 0's
    d_input}`` where stage 0 is held."""
    hops = _Hops(ring, wire_shape, dtype, device, forward=False)
    return _ring_walk(ring, backward_fn, lambda m: cotangents[m], hops,
                      reversed(range(ring.num_ticks)))
