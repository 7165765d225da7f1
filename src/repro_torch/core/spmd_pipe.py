"""Tick executors of the compiled engine on one device.

Counterpart of the one-device ("lanes") executors of ``repro.core.spmd_pipe``:
``spmd_pipeline_scheduled_lanes`` runs a train timeline and
``spmd_pipeline_scheduled_eval_lanes`` a forward-only one, both lowered to
the per-tick slot arrays of ``repro_torch.core.schedule.LoweredTimeline``.
The schedule's devices become *lanes*: every lane keeps its own preallocated
stashes, and the ring hop is a rotation of the lanes' outputs.

The slot arrays are numpy, so ticks, lanes, phases and slots are Python
ints while the program runs. Each tick therefore dispatches only its real
work items: an idle lane does nothing, and a value the lowering routes to a
sacrificial slot (fill/drain garbage) is never written. Run under a CUDA
graph capture (``repro_torch.core.cuda_graph``), the whole timeline becomes
one graph.

Wire latency (``lowered.wire_latency``, the reference's wire-parity rule):
at latency 1 a tick's outputs are banked by the neighbour lane at the next
tick, straight from the tensors the work produced. At latency 2 (a
timeline retimed by ``schedule.retime_timeline``) the train executor runs
the double-buffered dataflow: each direction of each lane holds two
preallocated wire buffers used by tick parity, and a tick

  1. banks the buffer that arrived (the outputs of tick t-2),
  2. posts the pending outputs of tick t-1 into the other parity's buffer
     of the neighbour lane,
  3. runs its work, and
  4. parks its own outputs as the next pending.

The post is the one-card image of the ring hop: a device copy on a wire
stream of its own, forked from the current stream after the tick's banks
and joined by an event before the next tick's banks, so the copy runs
beside the tick's work. On the CPU the same code runs on the one stream.
Banked values, stash traffic and the gradient order are the latency-1
ones, so the update is bit-identical. The eval executor takes latency 1
only, as the reference's eval lanes do.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.schedule import PHASE_FWD, PHASE_IDLE, LoweredTimeline


class _DoubleBufferedWires:
    """The latency-2 wires of ``spmd_pipeline_scheduled_lanes``: per
    direction and lane two preallocated buffers, used by tick parity. The
    post of tick t writes parity ``t % 2`` and the bank of tick t reads
    parity ``(t - 1) % 2``. With ``stream`` (a CUDA stream) the posts run
    there and the current stream waits on an event after each before the
    next banks; with None they run in line."""

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

    def arrived(self, t: int) -> list:
        """Per direction, per lane: the buffer tick ``t`` banks (the outputs
        of tick t-2), once the current stream has waited for its post."""
        if self._posted is not None:
            event, _held = self._posted
            torch.cuda.current_stream(self.stream.device).wait_event(event)
            self._posted = None
        parity = (t - 1) % 2
        return [[lane[parity] for lane in direction] for direction in self.buf]

    def post(self, t: int, ys: list, dhs: list) -> None:
        """Copy tick t-1's outputs ``ys`` (to lane d+1) and ``dhs`` (to lane
        d-1) into parity ``t % 2`` of the neighbours' buffers: only those
        that tick t+1 banks into a real stash slot."""
        lw, D, parity = self.lowered, self.lowered.num_devices, t % 2
        if t + 1 >= lw.num_ticks:
            return
        copies = []
        for e in range(D):
            for direction, slots, sacrificial, src in (
                (0, lw.in_fslot, lw.n_fslots, ys[(e - 1) % D]),
                (1, lw.in_bslot, lw.n_bslots, dhs[(e + 1) % D]),
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


def _stash(n_slots: int, wire_like: torch.Tensor) -> torch.Tensor:
    # slot n_slots is the lowering's sacrificial slot; it is allocated as in
    # the reference but nothing writes or reads it here
    return wire_like.new_zeros((n_slots + 1,) + tuple(wire_like.shape))


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

    Returns ``(grads, loss, count)``. Each (layer, chunk) gradient has
    exactly one producer, which writes it into the per-chunk buffer
    ``gbuf``; the chunks are then summed in descending order (the
    fill-drain drain order) and the losses in ascending chunk order, the
    host engine's order, so every schedule's floats are identical. Chunks
    the lowering skipped (``skip_chunks``) contribute nothing, as their
    exactly-zero gradients would."""
    if lowered.wire_latency not in (1, 2):
        raise ValueError(f"unsupported wire_latency {lowered.wire_latency}")
    C, T, D = lowered.num_chunks, lowered.num_ticks, lowered.num_devices
    n_f, n_b, n_w = lowered.n_fslots, lowered.n_bslots, lowered.n_wslots
    fstash = [_stash(n_f, wire_like) for _ in range(D)]
    bstash = [_stash(n_b, wire_like) for _ in range(D)]
    wstash = [(_stash(n_w, wire_like), _stash(n_w, wire_like)) if n_w else None for _ in range(D)]
    gbuf = [{k: v.new_zeros((C + 1,) + tuple(v.shape)) for k, v in p.items()} for p in grads_like]
    written: set[int] = set()
    losses: dict[int, tuple] = {}
    wires = None
    if lowered.wire_latency == 2:
        wires = _DoubleBufferedWires(lowered, wire_like, wire_stream)
    ys: list = [None] * D  # the last tick's outputs: at latency 2, the pending ones
    dhs: list = [None] * D

    def bank(stash, slot, sacrificial, value):
        if slot != sacrificial:
            if value is None:
                raise RuntimeError(f"slot {slot} banks a wire that carries no value")
            stash[slot].copy_(value)

    for t in range(T):
        if wires is None:
            # the ring hops: lane d's activation to lane d+1, its cotangent to d-1
            wire_f = [ys[(d - 1) % D] for d in range(D)]
            wire_b = [dhs[(d + 1) % D] for d in range(D)]
        else:
            wire_f, wire_b = wires.arrived(t)
        for d in range(D):
            bank(fstash[d], int(lowered.in_fslot[t, d]), n_f, wire_f[d])
            bank(bstash[d], int(lowered.in_bslot[t, d]), n_b, wire_b[d])
        if wires is not None:
            wires.post(t, ys, dhs)
        ys, dhs = [None] * D, [None] * D
        for d in range(D):
            phase = int(lowered.phase[t, d])
            if phase == PHASE_IDLE:
                continue
            stage, chunk = int(lowered.stage[t, d]), int(lowered.chunk[t, d])
            f_slot, b_slot = int(lowered.work_fslot[t, d]), int(lowered.work_bslot[t, d])
            w_slot = int(lowered.work_wslot[t, d])
            h_in = fstash[d][f_slot] if f_slot != n_f else None
            ct_in = bstash[d][b_slot] if b_slot != n_b else None
            w_res = None
            if n_w and w_slot != n_w:
                w_res = (wstash[d][0][w_slot], wstash[d][1][w_slot])
            y, d_h, w_out, grads, loss_sum, count = work_fn(
                phase, stage, chunk, h_in, ct_in, w_res
            )
            if w_out is not None:
                store = int(lowered.store_wslot[t, d])
                for buf, value in zip(wstash[d], w_out):
                    if value is not None:  # stage 0 banks no input
                        buf[store].copy_(value)
            if grads is not None:
                for layer, g in enumerate(grads):
                    for k, v in (g or {}).items():
                        gbuf[layer][k][chunk].copy_(v)
                written.add(chunk)
            if loss_sum is not None:
                losses[chunk] = (loss_sum, count)
            ys[d], dhs[d] = y, d_h

    grads = [{k: torch.zeros_like(v) for k, v in p.items()} for p in grads_like]
    for c in reversed(range(C)):  # canonical: the fill-drain drain order
        if c in written:
            grads = [{k: g[k] + gbuf[i][k][c] for k in g} for i, g in enumerate(grads)]
    loss = wire_like.new_zeros((), dtype=torch.float32)
    count = wire_like.new_zeros((), dtype=torch.float32)
    for c in sorted(losses):
        loss, count = loss + losses[c][0], count + losses[c][1]
    return grads, loss, count


def _eval_out_slot(lowered: LoweredTimeline) -> np.ndarray:
    """Per-tick output slot: last-stage forward ticks write their chunk's
    result, everything else routes to the sacrificial slot C."""
    last = (lowered.phase == PHASE_FWD) & (lowered.stage == lowered.num_stages - 1)
    return np.where(last, lowered.chunk, lowered.num_chunks).astype(np.int32)


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
    if lowered.wire_latency != 1:
        raise ValueError(
            f"wire_latency {lowered.wire_latency}: the eval executor runs at wire latency 1"
        )
    C, T, D = lowered.num_chunks, lowered.num_ticks, lowered.num_devices
    n_f = lowered.n_fslots
    out_slot = _eval_out_slot(lowered)
    fstash = [_stash(n_f, wire_like) for _ in range(D)]
    out = _stash(C, wire_like)
    wire_f: list = [None] * D
    for t in range(T):
        ys: list = [None] * D
        for d in range(D):
            slot = int(lowered.in_fslot[t, d])
            if slot != n_f:
                fstash[d][slot].copy_(wire_f[d])
            phase = int(lowered.phase[t, d])
            if phase == PHASE_IDLE:
                continue
            f_slot = int(lowered.work_fslot[t, d])
            h_in = fstash[d][f_slot] if f_slot != n_f else None
            y = work_fn(phase, int(lowered.stage[t, d]), int(lowered.chunk[t, d]), h_in)
            if int(out_slot[t, d]) != C:
                out[int(out_slot[t, d])].copy_(y)
            ys[d] = y
        wire_f = [ys[(d - 1) % D] for d in range(D)]
    return out[:C]
