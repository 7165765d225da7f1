"""The paper's sequential GAT network (§6), as a stage-able layer sequence.

Counterpart of ``repro.models.gnn.net`` (``SeqLayer``, ``GNNModel``,
``build_paper_gat``; the stage slices come with the training slice):

    dropout(0.6) -> GAT(8 heads, concat, attn-dropout 0.6) -> ELU
    -> dropout(0.6) -> GAT(8 heads, average, attn-dropout 0.6) -> log_softmax

Params are a list with one dict of tensors per layer, like the JAX
package's pytree, so a ``balance`` array partitions model and params alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.graphs.data import GraphBatch
from repro_torch.models.gnn import layers as L


@dataclasses.dataclass(frozen=True)
class SeqLayer:
    """One element of a sequential model: ``init(generator) -> params`` and
    ``apply(params, graph, h, generator, train) -> h``."""

    name: str
    init: Callable[[torch.Generator | None], Any]
    apply: Callable[[Any, GraphBatch, torch.Tensor, torch.Generator | None, bool], torch.Tensor]


def _no_params(generator):
    return {}


def _dropout_layer(rate: float, name: str) -> SeqLayer:
    return SeqLayer(
        name, _no_params, lambda p, g, h, gen, train: L.dropout(h, rate, gen, train)
    )


def _elu_layer() -> SeqLayer:
    return SeqLayer(
        "elu", _no_params, lambda p, g, h, gen, train: torch.nn.functional.elu(h)
    )


def _log_softmax_layer() -> SeqLayer:
    return SeqLayer(
        "log_softmax", _no_params, lambda p, g, h, gen, train: torch.log_softmax(h, dim=-1)
    )


def _gat_seq_layer(
    name: str,
    in_dim: int,
    out_dim: int,
    *,
    heads: int,
    concat: bool,
    attn_dropout: float,
    backend: str,
) -> SeqLayer:
    def apply(p, g, h, gen, train):
        return L.gat_layer(
            p, g, h, concat=concat, attn_dropout=attn_dropout, generator=gen,
            train=train, backend=backend,
        )

    return SeqLayer(
        name, lambda gen: L.init_gat(in_dim, out_dim, heads=heads, generator=gen), apply
    )


@dataclasses.dataclass(frozen=True)
class GNNModel:
    """A sequential GNN: its layers and the model's input/output widths."""

    layers: tuple[SeqLayer, ...]
    in_dim: int
    out_dim: int

    def init_params(self, seed: int = 0, *, device="cpu") -> list[dict]:
        """Fresh per-layer params from a seeded ``torch.Generator`` (not the
        JAX package's random bits; ``convert.params_from_jax`` carries those
        across)."""
        gen = torch.Generator().manual_seed(seed)
        return [
            {k: v.to(device) for k, v in layer.init(gen).items()} for layer in self.layers
        ]

    def apply(
        self,
        params: list,
        g: GraphBatch,
        h: torch.Tensor | None = None,
        *,
        generator: torch.Generator | None = None,
        train: bool = False,
    ) -> torch.Tensor:
        """Run every layer; dropout draws from ``generator`` when training."""
        h = g.features if h is None else h
        for layer, p in zip(self.layers, params):
            h = layer.apply(p, g, h, generator, train)
        return h


def build_paper_gat(
    num_features: int,
    num_classes: int,
    *,
    hidden_per_head: int = 8,
    heads: int = 8,
    feat_dropout: float = 0.6,
    attn_dropout: float = 0.6,
    backend: str = "padded",
) -> GNNModel:
    """The exact model of paper §6 (GAT defaults of Veličković et al.)."""
    L.canonical_backend(backend)
    layers = (
        _dropout_layer(feat_dropout, "dropout_0"),
        _gat_seq_layer(
            "gat_0", num_features, hidden_per_head, heads=heads, concat=True,
            attn_dropout=attn_dropout, backend=backend,
        ),
        _elu_layer(),
        _dropout_layer(feat_dropout, "dropout_1"),
        _gat_seq_layer(
            "gat_1", hidden_per_head * heads, num_classes, heads=heads, concat=False,
            attn_dropout=attn_dropout, backend=backend,
        ),
        _log_softmax_layer(),
    )
    return GNNModel(layers=layers, in_dim=num_features, out_dim=num_classes)
