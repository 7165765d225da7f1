"""Pipeline engine for GNNs: the host-driven GPipe loop.

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

``compile_eval(params, graph) -> EvalProgram`` is the forward-only path the
serving frontend (``repro_torch.launch.serve_gnn``) and ``evaluate`` share.
Every stage runs on ``config.device`` (one card); the schedule's device
numbers only label the timeline. The compiled single-program engine comes
with a later slice (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.core.microbatch import MicroBatchPlan
from repro_torch.core.schedule import Placement, get_schedule
from repro_torch.graphs.data import BucketedGraphBatch, GraphBatch
from repro_torch.graphs.partition import bucketize_stacked
from repro_torch.models.gnn.layers import canonical_backend
from repro_torch.models.gnn.net import GNNModel, fold_in, layer_keys
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import synchronize


@dataclasses.dataclass(frozen=True)
class GPipeConfig:
    """What selects a pipeline: stage balance, chunking, the schedule and
    its placement, the engine, the aggregation layout and the device."""

    balance: tuple[int, ...]  # layers per stage; sums to len(model.layers)
    chunks: int
    schedule: str = "fill_drain"  # any repro_torch.core.schedule.SCHEDULES name
    num_devices: int | None = None  # interleaved/zb-v: devices the timeline places stages on
    # stage -> device assignment overriding the schedule's default (ring
    # rotations); validated at engine construction, relabels the timeline
    placement: Placement | None = None
    engine: str = "host"  # "host"; "compiled" comes with a later slice
    # aggregation layout fed to the stages: "padded" feeds the padded
    # batches; "kernel" ("pallas") feeds the degree-bucketed layout
    # (``bucketize_stacked``). Must match the backend the model was built with.
    backend: str = "padded"
    device: str = "cuda"

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
        self.model = model
        self.config = config
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
        return d


def _chunk_loss_sum(log_probs, labels, mask):
    """(Σ nll·mask, Σ mask) — the summed form, so accumulating over chunks
    and dividing once equals the full-batch masked mean."""
    nll = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    m = mask.float()
    return torch.sum(nll * m), torch.sum(m)


class GPipe(PipelineEngine):
    """Host-driven pipeline-parallel wrapper around a sequential ``GNNModel``
    (the paper's §6 torchgpipe analogue; schedules are pluggable)."""

    name = "host"

    def __init__(self, model: GNNModel, config: GPipeConfig):
        super().__init__(model, config)
        self._evals: dict = {}  # (chunks, n_pad, max_deg) -> EvalProgram
        self._timelines: dict = {}  # chunks -> the (placed) timeline

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

    def _chunk_graphs(self, plan: MicroBatchPlan) -> tuple[list, list]:
        """Per-chunk graphs the stages consume, on the device, and each
        chunk's loss mask (``train_mask & core_mask``): the plan's padded
        batches as they are, or under the kernel backend one shared
        bucketed layout of the stacked plan (``bucketize_stacked``, one set
        of bucket capacities) sliced back per chunk. Built once per plan."""

        def build():
            if self.backend == "kernel":
                stacked = plan.stacked()
                layout = self.layout(stacked.graph)
                graphs = [layout.chunk(c) for c in range(plan.chunks)]
                cores = [stacked.core_mask[c] for c in range(plan.chunks)]
            else:
                graphs = [mb.graph.to(self.device) for mb in plan.batches]
                cores = [mb.core_mask for mb in plan.batches]
            masks = [g.train_mask & core.to(self.device) for g, core in zip(graphs, cores)]
            return graphs, masks

        return self._cached(plan, build)

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
        schedule's accounting and the measured peak live activations."""
        S, C = self.config.num_stages, plan.chunks
        graphs, loss_masks = self._chunk_graphs(plan)

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
            g = graphs[c]
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
                    saved[(s + 1, c)] = h_out
                else:
                    outs[c] = h_out
                peak_live = max(peak_live, len(saved))
            else:
                if s == S - 1 and it.phase in ("bwd", "bwd_b"):
                    # the chunk's loss cotangent, computed once its fwd completes
                    chunk_losses[c], cts[c] = self._loss_grad(outs.pop(c), g.labels, loss_masks[c])
                if it.phase == "bwd":
                    d_params, d_h = self._stage_vjp(
                        s, params, g, saved.pop((s, c)), keys, cts[c],
                        want_params=True, want_input=s > 0,
                    )
                    cts[c] = d_h
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
                    cts[c] = d_h
                else:  # "bwd_w": consume the residual, produce the weight grad
                    h_in, ct = residuals.pop((s, c))
                    chunk_grads[s][c], _ = self._stage_vjp(
                        s, params, g, h_in, keys, ct, want_params=True, want_input=False
                    )
            if record is not None:
                synchronize(self.device)
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
        total_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        total_count = torch.zeros((), dtype=torch.float32, device=self.device)
        for loss_sum, count in chunk_losses:
            total_loss = total_loss + loss_sum
            total_count = total_count + count

        if stats is not None:
            stats.update(self.schedule.describe(S, C))
            stats["measured_peak_live_activations"] = peak_live
            stats["measured_peak_w_residuals"] = peak_residuals

        scale = 1.0 / torch.clamp(total_count, min=1.0)
        grads = opt_lib.tree_map(lambda g: g * scale, grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = opt_lib.apply_updates(params, updates)
        loss = total_loss / torch.clamp(total_count, min=1.0)
        return params, opt_state, loss

    @staticmethod
    def _loss_grad(logp, labels, mask):
        """((Σ nll·mask, Σ mask), d(Σ nll·mask)/d logp) for one chunk."""
        leaf = logp.detach().requires_grad_(True)
        with torch.enable_grad():
            loss_sum, count = _chunk_loss_sum(leaf, labels, mask)
            (d_h,) = torch.autograd.grad(loss_sum, leaf)
        return (loss_sum.detach(), count), d_h


ENGINES = {"host": GPipe}


def make_engine(model: GNNModel, config: GPipeConfig) -> PipelineEngine:
    """Engine factory, selected by ``config.engine``."""
    if not isinstance(config, GPipeConfig):
        raise TypeError(f"make_engine(model, config) expects a GPipeConfig, got {type(config).__name__}")
    if config.engine == "compiled":
        raise NotImplementedError(
            "engine 'compiled' comes with a later slice (ROADMAP queue 1, item 9: "
            "compiled single-program engine); use engine 'host'"
        )
    try:
        cls = ENGINES[config.engine]
    except KeyError:
        raise KeyError(f"unknown engine {config.engine!r}; have {tuple(ENGINES)}") from None
    return cls(model, config)
