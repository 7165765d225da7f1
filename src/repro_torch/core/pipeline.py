"""Pipeline engines for GNNs: the host-driven GPipe loop and the compiled
single-program engine.

Counterpart of ``repro.core.pipeline``. ``PipelineEngine`` partitions a
sequential ``GNNModel`` into stages by a ``balance`` array (torchgpipe's
contract); ``GPipe`` is the host-driven engine:

  * the input is micro-batched into ``chunks`` (``core.microbatch``);
  * work runs in the order a pluggable ``Schedule`` timeline dictates
    (``core.schedule``: fill-drain, 1F1B, interleaved, zero-bubble);
    ``fwd`` items run a stage without autograd and save only its input;
    ``bwd`` items re-materialize the stage from that input and pull the
    cotangent back (GPipe's activation re-materialization); zero-bubble
    ``bwd_b``/``bwd_w`` items split that into the input and weight halves;
  * dropout keys depend on (step key, chunk, layer) alone, never on the
    order of execution, so a recomputed stage redraws the same masks;
  * per-chunk gradients are reduced per stage in descending chunk order and
    one synchronous optimizer update closes the step, so every schedule
    gives an update bit-identical to fill-drain.

``CompiledGNNPipeline`` runs the same timelines as one program: the
schedule is lowered to per-tick slot arrays (``schedule.lower_timeline``)
and executed by the tick executors of ``repro_torch.core.spmd_pipe``, the
optimizer update included. On a CUDA card each train step and each eval
call is one CUDA-graph replay (``repro_torch.core.cuda_graph``); on the CPU
the same program runs eagerly. Its updates are bit-identical to the host
engine's fill-drain update.

``compile_eval(params, graph) -> EvalProgram`` is the forward-only path the
serving frontend (``repro_torch.launch.serve_gnn``) and ``evaluate`` share.

Across cards: the host engine places stage s on ``config.devices`` (one
process, several cards; torchgpipe's layout), and the compiled engine,
run by one process per card (``repro_torch.core.ranks``), runs the ring
executors, one ring position per rank. Otherwise every stage runs on
``config.device`` and the schedule's device numbers only label the
timeline (the compiled engine's lanes).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.core import cuda_graph, ranks
from repro_torch.core.microbatch import MicroBatchPlan
from repro_torch.core.schedule import (
    PHASE_BWD,
    PHASE_BWD_B,
    PHASE_FWD,
    Placement,
    forward_timeline,
    get_schedule,
    lower_timeline,
    retime_timeline,
)
from repro_torch.core.spmd_pipe import (
    spmd_pipeline_scheduled,
    spmd_pipeline_scheduled_eval,
    spmd_pipeline_scheduled_eval_lanes,
    spmd_pipeline_scheduled_lanes,
)
from repro_torch.graphs.data import BucketedGraphBatch, GraphBatch
from repro_torch.graphs.partition import bucketize_stacked
from repro_torch.models.gnn.layers import canonical_backend
from repro_torch.models.gnn.net import (
    GNNModel,
    activation_widths,
    chunk_keys,
    fold_in,
    layer_keys,
    make_gnn_stage_slices,
    make_gnn_stage_slices_bw,
    narrow,
    stage_forward,
    stage_vjp,
    to_wire,
    travel_width,
)
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import synchronize


@dataclasses.dataclass(frozen=True)
class GPipeConfig:
    """What selects a pipeline: stage balance, chunking, the schedule and
    its placement, the engine, the aggregation layout and the device."""

    balance: tuple[int, ...]  # layers per stage; sums to len(model.layers)
    chunks: int
    # host engine: per-stage devices in one process (e.g. ("cuda:0", ...,
    # "cuda:3")); stage s runs on devices[p % len(devices)], p its ring
    # position mapped through the placement's device_order. None: every
    # stage on ``device``. The compiled engine reads its ranks instead.
    devices: tuple | None = None
    schedule: str = "fill_drain"  # any repro_torch.core.schedule.SCHEDULES name
    num_devices: int | None = None  # interleaved/zb-v: devices the timeline places stages on
    # stage -> device assignment overriding the schedule's default (ring
    # rotations); validated at engine construction, relabels the timeline
    placement: Placement | None = None
    engine: str = "host"  # "host" | "compiled"; consumed by make_engine
    # aggregation layout fed to the stages: "padded" and "dense" feed the
    # padded batches; "kernel" ("pallas") feeds the degree-bucketed layout
    # (``bucketize_stacked``). Must match the backend the model was built with.
    backend: str = "padded"
    device: str = "cuda"
    # graph data parallelism (compiled engine): replicas that each pipeline a
    # contiguous shard of the chunks, gradients reduced in the canonical
    # global chunk order, so the update is bit-identical to one replica.
    # Requires chunks % data_parallel == 0. The replicas split the chunks
    # on a world of data_parallel x ring ranks; one card, or a world of one
    # ring, runs the single-replica program over all chunks, as the
    # reference does with fewer devices than data_parallel x ring.
    data_parallel: int = 1
    # communication/compute overlap (compiled engine): "off" banks each
    # tick's outputs at the next tick; "double-buffer" retimes the timeline
    # to wire latency 2, so each tick posts the last tick's outputs on a
    # wire stream of their own before its work (``core.spmd_pipe``);
    # "async" runs the same program (the reference adds XLA scheduler flags,
    # which have no PyTorch counterpart). Updates stay bit-identical to "off".
    overlap: str = "off"

    @property
    def num_stages(self) -> int:
        """Pipeline stages (= entries in ``balance``)."""
        return len(self.balance)


def _eval_metric_head(logp, labels, masks) -> dict:
    """Masked means over the (chunks, n_pad) grid — padding rows and halo
    ghosts carry zero mask, so on a lossless plan these equal the
    full-batch numbers."""
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    hit = (torch.argmax(logp, dim=-1) == labels.long()).float()

    def masked_mean(x, mask):
        m = mask.float()
        return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)

    return {
        "train_loss": masked_mean(nll, masks["train"]),
        "train_acc": masked_mean(hit, masks["train"]),
        "val_acc": masked_mean(hit, masks["val"]),
        "test_acc": masked_mean(hit, masks["test"]),
    }


class EvalProgram:
    """Forward-only inference at one stacked-batch shape ``(chunks, n_pad,
    max_deg)`` — the unit of the serving engine's shape bucketing.

    ``bind(params)`` moves the params onto the program's device once (the
    same tree object is not moved again); ``__call__(graph)`` runs one
    stacked batch under ``torch.inference_mode()`` and returns per-chunk
    log-probabilities ``(chunks, n_pad, out_dim)`` on the device; its
    tensors never enter autograd. ``metrics`` is the metric head
    ``evaluate`` layers on top.
    """

    def __init__(self, forward, device: torch.device, key: tuple):
        self._forward = forward
        self.device = device
        self.key = key  # (chunks, n_pad, max_deg)
        self._bound = None  # (params as handed in, params on the device)

    def bind(self, params: list) -> "EvalProgram":
        """Place ``params`` on the device unless this tree is already bound."""
        if self._bound is None or self._bound[0] is not params:
            placed = [{k: v.to(self.device) for k, v in p.items()} for p in params]
            self._bound = (params, placed)
        return self

    def __call__(self, graph: GraphBatch) -> torch.Tensor:
        """Run one stacked batch -> logp ``(chunks, n_pad, out_dim)``."""
        if self._bound is None:
            raise ValueError("EvalProgram: call bind(params) before __call__")
        if tuple(graph.neighbors.shape) != self.key:
            raise ValueError(f"batch shape {tuple(graph.neighbors.shape)} != program {self.key}")
        with torch.inference_mode():
            return self._forward(self._bound[1], graph.to(self.device))

    def metrics(self, graph, core_mask: torch.Tensor) -> dict:
        """The ``make_eval`` metric dict over the batch's core nodes."""
        core_mask = core_mask.to(self.device)
        masks = {
            "train": graph.train_mask & core_mask,
            "val": graph.val_mask & core_mask,
            "test": graph.test_mask & core_mask,
        }
        with torch.inference_mode():
            return _eval_metric_head(self(graph), graph.labels, masks)


class PipelineEngine:
    """Contract of the pipeline engines: a sequential ``GNNModel`` split
    into stages by ``config.balance``, trained by synchronous pipeline
    steps over a ``MicroBatchPlan``."""

    name = "base"

    def __init__(self, model: GNNModel, config: GPipeConfig):
        if sum(config.balance) != len(model.layers):
            raise ValueError(
                f"balance {config.balance} must sum to {len(model.layers)} layers"
            )
        if any(b < 1 for b in config.balance):
            raise ValueError(f"every stage needs at least one layer, got {config.balance}")
        if config.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {config.chunks}")
        if config.data_parallel < 1:
            raise ValueError(f"data_parallel must be >= 1, got {config.data_parallel}")
        if config.overlap not in ("off", "double-buffer", "async"):
            raise ValueError(
                f"overlap must be 'off', 'double-buffer' or 'async', got {config.overlap!r}"
            )
        self.model = model
        self.config = config
        # set when the compiled engine lowers a step: True only when
        # replicas really split the chunks (a data_parallel x ring world)
        self._data_parallel_active = False
        self.device = torch.device(config.device)
        self.backend = canonical_backend(config.backend)
        self.schedule = get_schedule(config.schedule, num_devices=config.num_devices)
        self.placement = config.placement
        if self.placement is not None:
            self.placement.validate(config.num_stages)
            want = self.schedule.num_devices(config.num_stages)
            if self.placement.num_devices != want:
                raise ValueError(
                    f"placement spans {self.placement.num_devices} devices "
                    f"but schedule {config.schedule!r} places "
                    f"{config.num_stages} stages on {want}"
                )
        self._bounds: list[tuple[int, int]] = []
        lo = 0
        for b in config.balance:
            self._bounds.append((lo, lo + b))
            lo += b
        # graph or plan -> its layout on the device, keyed by id(); entries
        # retain the key object so a recycled id() never serves a stale layout
        self._layout_cache: dict = {}

    def stage_params(self, params: list, s: int) -> list:
        """The slice of per-layer params owned by stage ``s``."""
        lo, hi = self._bounds[s]
        return params[lo:hi]

    def init_params(self, seed: int = 0) -> list:
        """Fresh per-layer params from the wrapped model, on the device."""
        return self.model.init_params(seed, device=self.device)

    def train_step(self, params, opt_state, plan, rng, optimizer, *, record=None, stats=None):
        """One optimizer step over the plan's chunks; returns
        ``(params, opt_state, mean_loss)``."""
        raise NotImplementedError

    def compile_eval(self, params: list, graph) -> EvalProgram:
        """The forward-only program for ``graph``'s stacked shape, with
        ``params`` bound."""
        raise NotImplementedError

    def _cached(self, key_obj, build):
        cached = self._layout_cache.get(id(key_obj))
        if cached is not None and cached[0] is key_obj:
            return cached[1]
        value = build()
        self._layout_cache[id(key_obj)] = (key_obj, value)
        return value

    def layout(self, graph):
        """The aggregation layout this engine's stages consume for a
        chunk-stacked ``graph``, on the device: the padded batch itself, or
        its degree-bucketed wrapper (``bucketize_stacked``) under the kernel
        backend. The wrapper delegates every padded-batch attribute, so loss
        masks, metric heads and shape keys are layout-blind."""
        if self.backend != "kernel" or isinstance(graph, BucketedGraphBatch):
            return graph.to(self.device)
        return self._cached(graph, lambda: bucketize_stacked(graph).to(self.device))

    def _chunk_graphs(self, plan: MicroBatchPlan, device=None) -> tuple[list, list]:
        """Per-chunk graphs the stages consume, on ``device`` (the engine's
        by default), and each chunk's loss mask (``train_mask &
        core_mask``): the plan's padded batches as they are, or under the
        kernel backend one shared bucketed layout of the stacked plan
        (``bucketize_stacked``, one set of bucket capacities) sliced back
        per chunk. Built once per plan and device."""
        device = self.device if device is None else torch.device(device)

        def build():
            if self.backend == "kernel":
                stacked = plan.stacked()
                layout = self.layout(stacked.graph).to(device)
                graphs = [layout.chunk(c) for c in range(plan.chunks)]
                cores = [stacked.core_mask[c] for c in range(plan.chunks)]
            else:
                graphs = [mb.graph.to(device) for mb in plan.batches]
                cores = [mb.core_mask for mb in plan.batches]
            masks = [g.train_mask & core.to(device) for g, core in zip(graphs, cores)]
            return graphs, masks

        per_device = self._cached(plan, dict)
        if device not in per_device:
            per_device[device] = build()
        return per_device[device]

    def evaluate(self, params: list, plan: MicroBatchPlan) -> dict:
        """Forward-only inference over the plan's chunks: the same metric
        dict as ``repro_torch.train.loop.make_eval``, over each chunk's core
        nodes (equal to the full-batch numbers on a lossless plan)."""
        stacked = plan.stacked()
        graph = self.layout(stacked.graph)
        return self.compile_eval(params, graph).metrics(graph, stacked.core_mask)

    def describe(self) -> dict:
        """Engine + schedule metadata for logs and benchmark tables."""
        d = self.schedule.describe(self.config.num_stages, self.config.chunks)
        d.update(
            {
                "engine": self.name,
                "balance": list(self.config.balance),
                "chunks": self.config.chunks,
                "layers": [layer.name for layer in self.model.layers],
            }
        )
        if self.placement is not None:
            d["placement"] = list(self.placement.stage_to_device)
        if self.config.devices:
            d["devices"] = [str(x) for x in self.config.devices]
        if self.config.data_parallel > 1:
            d["data_parallel"] = self.config.data_parallel
        return d


def _chunk_loss_sum(log_probs, labels, mask):
    """(Σ nll·mask, Σ mask) — the summed form, so accumulating over chunks
    and dividing once equals the full-batch masked mean."""
    nll = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    m = mask.float()
    return torch.sum(nll * m), torch.sum(m)


class GPipe(PipelineEngine):
    """Host-driven pipeline-parallel wrapper around a sequential ``GNNModel``
    (the paper's §6 torchgpipe analogue; schedules are pluggable).

    With ``config.devices`` each stage lives on a card of its own, in one
    process: ``init_params`` places each layer on its stage's card, each
    stage's chunk graphs are copied there once per plan, an activation or
    cotangent moves to the consuming stage's card as it is produced
    (``.to(device)``, a peer copy), and the loss scale and the optimizer
    update follow each layer's card. The update is bit-identical to the
    one-card fill-drain's (under deterministic algorithms)."""

    name = "host"

    def __init__(self, model: GNNModel, config: GPipeConfig):
        super().__init__(model, config)
        self._stage_devices = [self._device_of_stage(s) for s in range(config.num_stages)]
        if config.data_parallel > 1:
            raise ValueError(
                "data_parallel > 1 needs the compiled engine's data axis; the host "
                "queue loop has none"
            )
        if config.overlap != "off":
            raise ValueError(
                "overlap needs the compiled engine's wire buffers; the host queue "
                "loop has no wires to double-buffer"
            )
        self._evals: dict = {}  # (chunks, n_pad, max_deg) -> EvalProgram
        self._timelines: dict = {}  # chunks -> the (placed) timeline

    def _device_of_stage(self, s: int) -> torch.device:
        """Stage ``s``'s device: ``devices[p % len(devices)]`` for its ring
        position p mapped through the placement's ``device_order`` (the
        reference's ``GPipe._place``), or the engine's device."""
        devs = self.config.devices
        if not devs:
            return self.device
        if self.placement is not None:
            pos = self.placement.stage_to_device[s]
            order = self.placement.device_order
            phys = order[pos] if order is not None else pos
        else:
            phys = self.schedule.device_of(s, self.config.num_stages)
        return torch.device(devs[phys % len(devs)])

    def _layer_device(self, i: int) -> torch.device:
        s = next(s for s, (lo, hi) in enumerate(self._bounds) if lo <= i < hi)
        return self._stage_devices[s]

    def init_params(self, seed: int = 0) -> list:
        """Fresh per-layer params from the wrapped model, each layer on its
        stage's device."""
        params = super().init_params(seed)
        return [{k: v.to(self._layer_device(i)) for k, v in p.items()}
                for i, p in enumerate(params)]

    def compile_eval(self, params: list, graph) -> EvalProgram:
        """A loop over the stacked chunks applying the full layer stack to
        each (eval needs no pipelining: there is no queue to keep busy)."""
        key = tuple(graph.neighbors.shape)
        prog = self._evals.get(key)
        if prog is None:
            model = self.model

            def forward(params, g):
                return torch.stack(
                    [model.apply(params, g.chunk(c), train=False) for c in range(key[0])]
                )

            prog = EvalProgram(forward, self.device, key)
            self._evals[key] = prog
        return prog.bind(params)

    # ------------------------------------------------------------ stages --

    def _stage_apply(self, s: int, stage_params: list, g, h, keys, train: bool):
        lo, hi = self._bounds[s]
        for i, layer in enumerate(self.model.layers[lo:hi]):
            h = layer.apply(stage_params[i], g, h, keys[i], train)
        return h

    def _layer_rngs(self, rng: int | None, chunk: int) -> list:
        n_layers = len(self.model.layers)
        return layer_keys(None if rng is None else fold_in(rng, chunk), n_layers)

    def _stage_vjp(self, s, params, g, h_in, keys, ct, *, want_params, want_input):
        """Re-materialize stage ``s`` from its saved input and pull ``ct``
        back: ``(d_params or None, d_h or None)``."""
        leaves = [
            {k: v.detach().requires_grad_(want_params) for k, v in p.items()}
            for p in self.stage_params(params, s)
        ]
        h = h_in.detach().requires_grad_(want_input)
        flat = opt_lib.tree_leaves(leaves) if want_params else []
        inputs = flat + ([h] if want_input else [])
        if not inputs:  # a parameter-free stage's weight half
            return leaves, None
        with torch.enable_grad():
            out = self._stage_apply(s, leaves, g, h, keys, True)
            grads = torch.autograd.grad(out, inputs, ct, allow_unused=True)
        d_params = opt_lib.fill_grads(leaves, grads[: len(flat)]) if want_params else None
        return d_params, (grads[-1] if want_input else None)

    def _timeline(self, chunks: int) -> list:
        if chunks not in self._timelines:
            timeline = self.schedule.timeline(self.config.num_stages, chunks)
            if self.placement is not None:
                # re-device the items (ticks and order untouched)
                timeline = self.placement.apply(timeline)
            self._timelines[chunks] = timeline
        return self._timelines[chunks]

    # -------------------------------------------------------------- step --

    def train_step(
        self,
        params: list,
        opt_state,
        plan: MicroBatchPlan,
        rng: int | None,
        optimizer: opt_lib.Optimizer,
        *,
        record: list | None = None,
        stats: dict | None = None,
    ):
        """One synchronous pipeline step under ``config.schedule``: the
        timeline's work items execute in order, then one optimizer update
        closes the step. ``rng`` is the step's dropout key. ``record`` (if
        given) receives ``(phase, tick, stage, chunk, seconds)`` per item,
        each timed to a device synchronize; ``stats`` receives the
        schedule's accounting and the measured peak live activations.
        With ``config.devices``, ``params`` and ``opt_state`` live on the
        stages' devices (``init_params``)."""
        S, C = self.config.num_stages, plan.chunks
        devs = self._stage_devices
        stage_graphs = [self._chunk_graphs(plan, dev)[0] for dev in devs]
        loss_masks = self._chunk_graphs(plan, devs[-1])[1]

        saved: dict[tuple[int, int], Any] = {}
        outs: dict[int, Any] = {}
        cts: dict[int, Any] = {}
        residuals: dict[tuple[int, int], Any] = {}  # zb: (h_in, ct) per B half
        chunk_losses: list[Any] = [None] * C
        chunk_grads: list[list[Any]] = [[None] * C for _ in range(S)]
        peak_live = 0
        peak_residuals = 0

        for it in self._timeline(C):
            s, c = it.stage, it.chunk
            g = stage_graphs[s][c]
            lo, hi = self._bounds[s]
            keys = self._layer_rngs(rng, c)[lo:hi]
            t0 = time.perf_counter()
            if it.phase == "fwd":
                h = g.features if s == 0 else saved[(s, c)]
                with torch.no_grad():
                    h_out = self._stage_apply(s, self.stage_params(params, s), g, h, keys, True)
                if s == 0:
                    saved[(0, c)] = g.features
                if s + 1 < S:
                    saved[(s + 1, c)] = h_out.to(devs[s + 1])  # the hop to the next card
                else:
                    outs[c] = h_out
                peak_live = max(peak_live, len(saved))
            else:
                if s == S - 1 and it.phase in ("bwd", "bwd_b"):
                    # the chunk's loss cotangent, computed once its fwd completes
                    chunk_losses[c], cts[c] = _loss_grad(outs.pop(c), g.labels, loss_masks[c])
                if it.phase == "bwd":
                    d_params, d_h = self._stage_vjp(
                        s, params, g, saved.pop((s, c)), keys, cts[c],
                        want_params=True, want_input=s > 0,
                    )
                    cts[c] = None if d_h is None else d_h.to(devs[s - 1])
                    chunk_grads[s][c] = d_params
                elif it.phase == "bwd_b":
                    # B: emit the upstream cotangent now, defer the weight
                    # grad; the stage input moves into the W residual. Stage
                    # 0's input is the features: no cotangent to emit.
                    h_in = saved.pop((s, c))
                    residuals[(s, c)] = (h_in, cts[c])
                    peak_residuals = max(peak_residuals, len(residuals))
                    d_h = None
                    if s > 0:
                        _, d_h = self._stage_vjp(
                            s, params, g, h_in, keys, cts[c],
                            want_params=False, want_input=True,
                        )
                        d_h = d_h.to(devs[s - 1])
                    cts[c] = d_h
                else:  # "bwd_w": consume the residual, produce the weight grad
                    h_in, ct = residuals.pop((s, c))
                    chunk_grads[s][c], _ = self._stage_vjp(
                        s, params, g, h_in, keys, ct, want_params=True, want_input=False
                    )
            if record is not None:
                synchronize(devs[s])
                record.append((it.phase, it.tick, s, c, time.perf_counter() - t0))

        # canonical reduction — per stage, chunks in descending order (the
        # fill-drain drain order), so the accumulated floats are identical
        # whichever schedule produced the per-chunk gradients
        grads = opt_lib.tree_map(torch.zeros_like, params)
        for s in range(S):
            lo, _ = self._bounds[s]
            for c in reversed(range(C)):
                for i, g in enumerate(chunk_grads[s][c]):
                    grads[lo + i] = {k: grads[lo + i][k] + v for k, v in g.items()}
        # the losses live on the last stage's device
        total_loss = torch.zeros((), dtype=torch.float32, device=devs[-1])
        total_count = torch.zeros((), dtype=torch.float32, device=devs[-1])
        for loss_sum, count in chunk_losses:
            total_loss = total_loss + loss_sum
            total_count = total_count + count

        if stats is not None:
            stats.update(self.schedule.describe(S, C))
            stats["measured_peak_live_activations"] = peak_live
            stats["measured_peak_w_residuals"] = peak_residuals

        scale = 1.0 / torch.clamp(total_count, min=1.0)
        grads = opt_lib.tree_map(lambda g: g * scale.to(g.device), grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = opt_lib.apply_updates(params, updates)
        loss = total_loss / torch.clamp(total_count, min=1.0)
        return params, opt_state, loss


def _loss_grad(logp, labels, mask):
    """((Σ nll·mask, Σ mask), d(Σ nll·mask)/d logp) for one chunk."""
    leaf = logp.detach().requires_grad_(True)
    with torch.enable_grad():
        loss_sum, count = _chunk_loss_sum(leaf, labels, mask)
        (d_h,) = torch.autograd.grad(loss_sum, leaf)
    return (loss_sum.detach(), count), d_h


class _StepProgram:
    """One compiled train step for one lowered timeline and optimizer:
    ``__call__(params, opt_state, graphs, loss_masks, keys)`` runs it eagerly
    (the CPU path); ``captures`` holds its CUDA graphs, one per plan and
    keyed-or-not step."""

    def __init__(self, step, optimizer: opt_lib.Optimizer, lowered, on_ranks: bool = False):
        self.step = step
        self.optimizer = optimizer  # retained: the cache is keyed by its id()
        self.lowered = lowered
        self.on_ranks = on_ranks  # runs the ring executors: eager, never captured
        self.captures: dict = {}  # (id(plan), keyed) -> (plan, CapturedStep)

    def __call__(self, params, opt_state, graphs, loss_masks, keys):
        return self.step(params, opt_state, graphs, loss_masks, keys)


class CompiledGNNPipeline(PipelineEngine):
    """Compiled single-program engine: one device, or one ring position per
    rank.

    Every schedule, fill-drain included, is lowered to per-tick slot arrays
    (``lower_timeline``, with the placement's relabelling) and run by the
    tick executors of ``core.spmd_pipe``: each work item is an explicit
    stage forward or vjp over the params-explicit stage slices
    (``make_gnn_stage_slices``, ``make_gnn_stage_slices_bw``), and one
    optimizer update closes the step. Per-chunk gradients are reduced in
    descending chunk order and dropout keys are derived per (step key,
    global chunk, layer) as the host engine derives them, so every schedule,
    placement and data-parallel width gives an update bit-identical to the
    host engine's fill-drain.

    Like the reference, the engine reads how many devices it has. With no
    process group (one card or the CPU), the schedule's devices are lanes
    of one program (``spmd_pipeline_scheduled_lanes``); on a CUDA card the
    step is captured once per (plan, optimizer, shape) as a CUDA graph
    (``cuda_graph.CapturedStep``) and each ``train_step`` is one replay,
    which returns the graph's static param and optimizer-state buffers (the
    next replay overwrites them). Each eval program (``compile_eval``, one
    per stacked shape) is likewise one graph (``cuda_graph.GraphedForward``).
    On the CPU the same programs run eagerly. ``graphs_captured`` counts
    the graphs this engine holds.

    With a process group of ``D`` ranks (the schedule's ring) or ``dp·D``
    (``data_parallel`` replicas of it; ``core.ranks.RankGrid``), each rank
    runs its own ring position through ``spmd_pipeline_scheduled`` and the
    eval through ``spmd_pipeline_scheduled_eval``; the placement's
    ``device_order`` picks which rank holds which position. On a grid each
    replica takes its contiguous chunk shard, its dropout keys folding the
    global chunk id. Every rank holds the full params and applies the same
    update. On ranks the step and the eval run eagerly: capturing NCCL's
    point-to-point ops in a CUDA graph is not done yet (``graphs_captured``
    is 0 there).

    ``overlap`` other than "off" lowers the train timeline retimed to wire
    latency 2 (the double-buffered wires: their posts on ``wire_stream``
    on a card, on NCCL's stream on ranks); eval programs stay at latency 1,
    as the reference's do.

    Not ported: the reference's single-device fused chunk scan
    (``_build_step``/``_make_scan_loss``, which exists because a
    ``vmap``-emulated ring computes every ``lax.switch`` branch; a
    host-unrolled tick program dispatches only real items)."""

    name = "compiled"

    def __init__(self, model: GNNModel, config: GPipeConfig):
        super().__init__(model, config)
        if config.devices:
            raise ValueError(
                "devices places the host engine's stages in one process; the compiled "
                "engine takes one rank per device (core.ranks)"
            )
        self._grid = None  # the RankGrid, made with the first program on ranks
        # the stream the double-buffered wires post on (a card, overlap on),
        # made with the first step program: one per engine
        self.wire_stream: torch.cuda.Stream | None = None
        self._widths: list[int] | None = None
        # (chunks, n_pad, max_deg, id(optimizer), skip) -> _StepProgram
        self._steps: dict = {}
        self._evals: dict = {}  # (chunks, n_pad, max_deg) -> EvalProgram
        self._plans: dict = {}  # id(plan) -> (plan, (graphs, loss_masks, skip, key))

    @property
    def graphs_captured(self) -> int:
        """CUDA graphs this engine holds: train steps and eval programs."""
        steps = sum(len(program.captures) for program in self._steps.values())
        evals = sum(getattr(prog._forward, "captured", None) is not None
                    for prog in self._evals.values())
        return steps + evals

    # ------------------------------------------------------------ program --

    def _plan_inputs(self, plan: MicroBatchPlan):
        """(per-chunk graphs, loss masks, loss-free chunks, shape key) for a
        plan, built once. The graphs are the host engine's, so both engines
        multiply the same tensors; a plan whose chunks differ in node count
        uses its stacked chunks instead, since the wires need one."""
        cached = self._plans.get(id(plan))
        if cached is not None and cached[0] is plan:
            return cached[1]
        stacked = plan.stacked()
        graphs, masks = self._chunk_graphs(plan)
        if len({g.num_nodes for g in graphs}) > 1:
            layout = self.layout(stacked.graph)
            graphs = [layout.chunk(c) for c in range(plan.chunks)]
            masks = [
                g.train_mask & stacked.core_mask[c].to(self.device)
                for c, g in enumerate(graphs)
            ]
        # chunks with no loss rows (ragged plans pad with empty microbatches)
        # contribute exactly-zero gradients and loss: the lowering drops them
        # and their dead ticks. Read from the host copy: no device sync.
        # data_parallel > 1 keeps the full grid, as the reference's replicas
        # cannot carry per-replica tick counts.
        skip: tuple = ()
        if self.config.data_parallel == 1:
            live = (stacked.graph.train_mask & stacked.core_mask).any(dim=1)
            skip = tuple(int(c) for c in torch.nonzero(~live).flatten())
        value = (graphs, masks, skip, (plan.chunks, stacked.n_pad, stacked.max_deg))
        self._plans[id(plan)] = (plan, value)
        return value

    def _rank_grid(self):
        """The ``RankGrid`` of the joined process group, made once (on
        every rank, in the same order); None without a group."""
        if not ranks.active():
            return None
        if self._grid is None:
            p = self.placement
            self._grid = ranks.RankGrid(
                self.config.data_parallel, self.schedule.num_devices(self.config.num_stages),
                p.device_order if p is not None else None,
            )
        return self._grid

    def _lower_for(self, chunks: int, skip_chunks: tuple = ()):
        """The configured schedule's timeline for ``chunks`` chunks, placed
        and lowered (the lowering's ring check rejects what the executor
        could not route). With ``overlap`` on, the timeline is first retimed
        to wire latency 2 for the double-buffered wires; ``skip_chunks``
        drops loss-free chunks and their dead ticks."""
        S = self.config.num_stages
        timeline = self.schedule.timeline(S, chunks)  # raises on a bad (S, C)
        if self.placement is not None:
            timeline = self.placement.apply(timeline)
        latency = 1 if self.config.overlap == "off" else 2
        if latency != 1:
            timeline = retime_timeline(timeline, S, chunks, wire_latency=latency)
        return lower_timeline(timeline, S, chunks, wire_latency=latency,
                              skip_chunks=skip_chunks)

    def _make_work_fn(self, widths, params, graphs, loss_masks, keys):
        """The per-tick work dispatcher of the tick executors:
        fwd, fused bwd, split B and split W items of every stage. The last
        stage derives its cotangent from the same summed masked NLL the host
        engine differentiates (``_chunk_loss_sum``), in its fused bwd or B
        half, from its re-materialized output."""
        model, bounds = self.model, self._bounds
        S, n_layers = self.config.num_stages, len(model.layers)
        d_travel = travel_width(bounds, widths)
        slices = make_gnn_stage_slices(model, bounds, widths, graphs, keys)
        runs = [stage_forward(model, bounds, graphs, keys, True, s) for s in range(S)]

        def loss_ct(y, chunk):
            (loss_sum, count), ct = _loss_grad(y, graphs[chunk].labels, loss_masks[chunk])
            return ct, loss_sum, count

        b_fns, w_fns = make_gnn_stage_slices_bw(
            model, bounds, widths, graphs, keys, loss_ct=loss_ct
        )

        def full(d_params, s):  # the stage's layer grads, placed in the full layer list
            lo, hi = bounds[s]
            return [None] * lo + d_params + [None] * (n_layers - hi)

        def work_fn(phase, s, c, h_in, ct, w_res):
            lo, hi = bounds[s]
            if phase == PHASE_FWD:
                return slices[s](params, c, h_in), None, None, None, None, None
            if phase == PHASE_BWD:
                if s == S - 1:
                    def ct_of(y):
                        return loss_ct(y, c)
                else:
                    ct_true = narrow(ct, widths[hi])

                    def ct_of(y):
                        return ct_true, None, None
                h = None if lo == 0 else narrow(h_in, widths[lo])
                d_params, d_h, loss_sum, count = stage_vjp(
                    runs[s], params, lo, hi, c, h, ct_of, "bwd",
                    want_params=True, want_input=lo > 0,
                )
                d_h = None if d_h is None else to_wire(d_h, d_travel)
                return None, d_h, None, full(d_params, s), loss_sum, count
            if phase == PHASE_BWD_B:
                d_h, residual, loss_sum, count = b_fns[s](params, c, h_in, ct)
                return None, d_h, residual, None, loss_sum, count
            return None, None, None, full(w_fns[s](params, c, w_res), s), None, None

        return work_fn

    def _build_step_scheduled(self, widths, chunks, optimizer, skip_chunks):
        """The train step over the configured timeline: the tick executor,
        the gradient scaling and one optimizer update, as one function of
        ``(params, opt_state, graphs, loss_masks, keys)``. With
        ``data_parallel`` > 1 the chunks must split evenly across the
        replicas. On a grid of ranks replica r lowers the timeline over its
        contiguous shard ``[r·C/dp, (r+1)·C/dp)`` and folds the global chunk
        id into its dropout keys (the reference's ``chunk_offset``); one
        card, or one ring, lowers it over all of them."""
        dp = self.config.data_parallel
        if dp > 1 and chunks % dp:
            raise ValueError(
                f"chunks {chunks} must split evenly across data_parallel={dp} replicas"
            )
        grid = self._rank_grid()
        dp_active = grid is not None and grid.dp > 1
        local = chunks // dp if dp_active else chunks
        offset = grid.replica * local if dp_active else 0
        lowered = self._lower_for(local, skip_chunks)
        if (grid is None and lowered.wire_latency == 2 and self.device.type == "cuda"
                and self.wire_stream is None):
            self.wire_stream = torch.cuda.Stream(device=self.device)
        self._data_parallel_active = dp_active
        d_travel = travel_width(self._bounds, widths)

        def step(params, opt_state, graphs, loss_masks, keys):
            if dp_active:  # this replica's shard, indexed by local chunk id
                graphs = graphs[offset:offset + local]
                loss_masks = loss_masks[offset:offset + local]
                keys = _shifted_keys(keys, offset)
            work_fn = self._make_work_fn(widths, params, graphs, loss_masks, keys)
            f = graphs[0].features
            wire_like = torch.zeros((f.shape[0], d_travel), dtype=f.dtype, device=f.device)
            if grid is None:
                grads, loss_sum, count = spmd_pipeline_scheduled_lanes(
                    work_fn, lowered, wire_like=wire_like, grads_like=params,
                    wire_stream=self.wire_stream,
                )
            else:
                grads, loss_sum, count = spmd_pipeline_scheduled(
                    work_fn, lowered, wire_like=wire_like, grads_like=params, grid=grid,
                )
            scale = 1.0 / torch.clamp(count, min=1.0)
            grads = opt_lib.tree_map(lambda g: g * scale, grads)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = opt_lib.apply_updates(params, updates)
            return params, opt_state, loss_sum / torch.clamp(count, min=1.0)

        return _StepProgram(step, optimizer, lowered, on_ranks=grid is not None)

    def step_program(self, params, plan: MicroBatchPlan, optimizer) -> tuple:
        """``(program, graphs, loss_masks)`` for a plan: the compiled step
        as a plain function (``program(params, opt_state, graphs,
        loss_masks, keys)``, keys from ``net.chunk_keys``), the one that
        ``train_step`` runs eagerly on the CPU and on ranks, and captures
        on a card."""
        graphs, masks, skip, shape = self._plan_inputs(plan)
        if self._widths is None:
            self._widths = activation_widths(self.model, params, graphs[0])
        key = (*shape, id(optimizer), skip)
        program = self._steps.get(key)
        if program is None or program.optimizer is not optimizer:
            program = self._build_step_scheduled(self._widths, plan.chunks, optimizer, skip)
            self._steps[key] = program
        return program, graphs, masks

    def _build_eval_forward(self, widths, chunks: int):
        """``forward(params, graph) -> logp`` over a stacked batch: the
        fill-drain forward wave (``forward_timeline``) lowered forward-only
        and run by ``spmd_pipeline_scheduled_eval_lanes``, or on ranks by
        ``spmd_pipeline_scheduled_eval`` (each replica of a grid runs it
        over every chunk)."""
        S = self.config.num_stages
        grid = self._rank_grid()
        if grid is not None and grid.D < S:
            # an interleaved ring of D < S ranks: the fill-drain wave would
            # double-book them, so eval runs the schedule's own forwards
            timeline = self.schedule.timeline(S, chunks)
            if self.placement is not None:
                timeline = self.placement.apply(timeline)
            items = [it for it in timeline if it.phase == "fwd"]
        else:
            items = forward_timeline(S, chunks)
            if self.placement is not None and self.placement.num_devices == S:
                # a one-stage-per-device ring re-devices the eval wave too; an
                # interleaved placement (D < S) would double-book devices on
                # the fill-drain wave, so one card keeps an S-lane identity ring
                items = self.placement.apply(items)
        lowered = lower_timeline(items, S, chunks, forward_only=True)
        model, bounds = self.model, self._bounds
        d_travel = travel_width(bounds, widths)
        no_keys = chunk_keys(None, len(model.layers))

        def forward(params, g):
            graphs = [g.chunk(c) for c in range(chunks)]
            slices = make_gnn_stage_slices(model, bounds, widths, graphs, no_keys, train=False)
            f = g.features
            wire_like = torch.zeros((f.shape[1], d_travel), dtype=f.dtype, device=f.device)

            def work(phase, s, c, h_in):
                return slices[s](params, c, h_in)

            if grid is None:
                out = spmd_pipeline_scheduled_eval_lanes(work, lowered, wire_like=wire_like)
            else:
                out = spmd_pipeline_scheduled_eval(work, lowered, wire_like=wire_like, grid=grid)
            return out[..., : model.out_dim].contiguous()

        return forward

    def compile_eval(self, params: list, graph) -> EvalProgram:
        """The forward-only program for ``graph``'s stacked shape, with
        ``params`` bound: one CUDA graph per ``(chunks, n_pad, max_deg)``
        on a card, captured at its first call; eager on ranks."""
        if self._widths is None:
            self._widths = activation_widths(self.model, params, graph)
        key = tuple(graph.neighbors.shape)
        prog = self._evals.get(key)
        if prog is None:
            forward = self._build_eval_forward(self._widths, key[0])
            if self.device.type == "cuda" and self._rank_grid() is None:
                forward = cuda_graph.GraphedForward(forward)
            prog = EvalProgram(forward, self.device, key)
            self._evals[key] = prog
        return prog.bind(params)

    def describe(self) -> dict:
        """The base description, and on ranks the grid (``ranks``)."""
        d = super().describe()
        if self._grid is not None:
            d["ranks"] = self._grid.describe()
        return d

    # -------------------------------------------------------------- step --

    def train_step(
        self,
        params: list,
        opt_state,
        plan: MicroBatchPlan,
        rng: int | None,
        optimizer: opt_lib.Optimizer,
        *,
        record: list | None = None,  # per-item timings do not exist in one program
        stats: dict | None = None,
    ):
        """One step over the plan as one program; returns ``(params,
        opt_state, mean_loss)``. On a card without ranks it is one
        CUDA-graph replay and the returned params and state are the graph's
        static buffers: the next step overwrites them. ``stats`` receives
        the schedule's accounting and the lowered stash's."""
        program, graphs, masks = self.step_program(params, plan, optimizer)
        if stats is not None:
            lowered = program.lowered
            stats.update(self.describe())
            # stage-0 inputs are read from the features by chunk id, never stashed
            stats["measured_peak_live_activations"] = lowered.peak_live_stash
            stats["stash_slots_per_device"] = lowered.n_fslots
            stats["w_slots_per_device"] = lowered.n_wslots
            stats["num_ticks"] = lowered.num_ticks
            stats["wire_latency"] = lowered.wire_latency
        n_layers = len(self.model.layers)
        if self.device.type != "cuda" or program.on_ranks:
            return program(params, opt_state, graphs, masks, chunk_keys(rng, n_layers))
        ckey = (id(plan), rng is not None)
        entry = program.captures.get(ckey)
        if entry is None or entry[0] is not plan:
            captured = cuda_graph.CapturedStep(
                lambda p, o, keys: program(p, o, graphs, masks, keys),
                params, opt_state, n_layers, rng is not None, self.device,
            )
            entry = (plan, captured)
            program.captures[ckey] = entry
        return entry[1](params, opt_state, rng)


def _shifted_keys(keys, offset: int):
    """``keys`` (``net.chunk_keys``) at global chunk ``c + offset`` for a
    replica's local chunk c."""

    def shifted(chunk: int, site: str) -> list:
        return keys(chunk + offset, site)

    return shifted


ENGINES = {"host": GPipe, "compiled": CompiledGNNPipeline}


def make_engine(model: GNNModel, config) -> PipelineEngine:
    """Engine factory, selected by ``config.engine``: ``host`` (the GPipe
    queue loop) or ``compiled`` (one program per step; one CUDA-graph replay
    on a card). ``config`` is a ``GPipeConfig`` or a planner
    ``PipelinePlan`` (``repro_torch.core.autotune``), which converts through
    its own ``to_config()``, so an ``--auto`` pick replays on either
    engine."""
    from repro_torch.core.autotune import PipelinePlan  # autotune imports this module

    if isinstance(config, PipelinePlan):
        config = config.to_config()
    if not isinstance(config, GPipeConfig):
        raise TypeError(
            f"make_engine(model, config) expects a GPipeConfig or a PipelinePlan, "
            f"got {type(config).__name__}"
        )
    try:
        cls = ENGINES[config.engine]
    except KeyError:
        raise KeyError(f"unknown engine {config.engine!r}; have {tuple(ENGINES)}") from None
    return cls(model, config)
