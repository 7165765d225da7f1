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

Both executors take wire latency 1 only: the double-buffered latency-2
dataflow comes with ROADMAP queue 1, item 13.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.schedule import PHASE_FWD, PHASE_IDLE, LoweredTimeline


def _check_latency(lowered: LoweredTimeline) -> None:
    if lowered.wire_latency != 1:
        raise NotImplementedError(
            f"wire_latency {lowered.wire_latency}: the double-buffered wires are not "
            "ported to repro_torch yet (ROADMAP queue 1, item 13: overlap)"
        )


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

    Returns ``(grads, loss, count)``. Each (layer, chunk) gradient has
    exactly one producer, which writes it into the per-chunk buffer
    ``gbuf``; the chunks are then summed in descending order (the
    fill-drain drain order) and the losses in ascending chunk order, the
    host engine's order, so every schedule's floats are identical. Chunks
    the lowering skipped (``skip_chunks``) contribute nothing, as their
    exactly-zero gradients would."""
    _check_latency(lowered)
    C, T, D = lowered.num_chunks, lowered.num_ticks, lowered.num_devices
    n_f, n_b, n_w = lowered.n_fslots, lowered.n_bslots, lowered.n_wslots
    fstash = [_stash(n_f, wire_like) for _ in range(D)]
    bstash = [_stash(n_b, wire_like) for _ in range(D)]
    wstash = [(_stash(n_w, wire_like), _stash(n_w, wire_like)) if n_w else None for _ in range(D)]
    gbuf = [{k: v.new_zeros((C + 1,) + tuple(v.shape)) for k, v in p.items()} for p in grads_like]
    written: set[int] = set()
    losses: dict[int, tuple] = {}
    wire_f: list = [None] * D
    wire_b: list = [None] * D

    def bank(stash, slot, sacrificial, value):
        if slot != sacrificial:
            if value is None:
                raise RuntimeError(f"slot {slot} banks a wire that carries no value")
            stash[slot].copy_(value)

    for t in range(T):
        ys: list = [None] * D
        dhs: list = [None] * D
        for d in range(D):
            bank(fstash[d], int(lowered.in_fslot[t, d]), n_f, wire_f[d])
            bank(bstash[d], int(lowered.in_bslot[t, d]), n_b, wire_b[d])
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
        # the ring hops: lane d's activation to lane d+1, its cotangent to d-1
        wire_f = [ys[(d - 1) % D] for d in range(D)]
        wire_b = [dhs[(d + 1) % D] for d in range(D)]

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
    _check_latency(lowered)
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
