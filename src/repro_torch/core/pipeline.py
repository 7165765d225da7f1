"""Pipeline engine for GNNs — the serving slice.

Counterpart of ``repro.core.pipeline``. ``PipelineEngine`` partitions a
sequential ``GNNModel`` into stages by a ``balance`` array (torchgpipe's
contract); ``GPipe`` is the host-driven engine. This slice ports its
forward-only eval path, ``compile_eval(params, graph) -> EvalProgram``,
which the serving frontend (``repro_torch.launch.serve_gnn``) drives. The
train step (``GPipe.train_step``) and the compiled single-program engine
come with later slices and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.graphs.data import GraphBatch
from repro_torch.models.gnn.net import GNNModel


@dataclasses.dataclass(frozen=True)
class GPipeConfig:
    """What selects a pipeline in this slice: stage balance, chunking, the
    engine and the device. (The aggregation backend is the model's: it is
    fixed when ``build_paper_gat`` builds the layers.)"""

    balance: tuple[int, ...]  # layers per stage; sums to len(model.layers)
    chunks: int
    engine: str = "host"  # "host"; "compiled" comes with a later slice
    device: str = "cuda"

    @property
    def num_stages(self) -> int:
        """Pipeline stages (= entries in ``balance``)."""
        return len(self.balance)


class EvalProgram:
    """Forward-only inference at one stacked-batch shape ``(chunks, n_pad,
    max_deg)`` — the unit of the serving engine's shape bucketing.

    ``bind(params)`` moves the params onto the program's device once (the
    same tree object is not moved again); ``__call__(graph)`` runs one
    stacked batch under ``torch.inference_mode()`` and returns per-chunk
    log-probabilities ``(chunks, n_pad, out_dim)`` on the device.
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


class PipelineEngine:
    """Contract of the pipeline engines: a sequential ``GNNModel`` split
    into stages by ``config.balance``."""

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
        self._bounds: list[tuple[int, int]] = []
        lo = 0
        for b in config.balance:
            self._bounds.append((lo, lo + b))
            lo += b

    def stage_params(self, params: list, s: int) -> list:
        """The slice of per-layer params owned by stage ``s``."""
        lo, hi = self._bounds[s]
        return params[lo:hi]

    def train_step(self, *args, **kwargs):
        """One optimizer step over a micro-batch plan (training slice)."""
        raise NotImplementedError(
            "the train step comes with the training slice (ROADMAP queue 1, "
            "item 7: host GPipe engine)"
        )

    def compile_eval(self, params: list, graph: GraphBatch) -> EvalProgram:
        """The forward-only program for ``graph``'s stacked shape, with
        ``params`` bound."""
        raise NotImplementedError


class GPipe(PipelineEngine):
    """Host-driven pipeline-parallel wrapper around a sequential ``GNNModel``
    (the paper's §6 torchgpipe analogue)."""

    name = "host"

    def __init__(self, model: GNNModel, config: GPipeConfig):
        super().__init__(model, config)
        self._evals: dict = {}  # (chunks, n_pad, max_deg) -> EvalProgram

    def compile_eval(self, params: list, graph: GraphBatch) -> EvalProgram:
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
