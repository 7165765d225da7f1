"""Sequential GNN models (the paper's GAT, the GCN family), as stage-able
layer sequences.

Counterpart of ``repro.models.gnn.net`` (``SeqLayer``, ``GNNModel``,
``build_paper_gat``, ``build_gnn`` for ``gat``/``gcn`` and
``build_imbalanced_gcn``; the compiled engine's stage slices come with a
later slice). The paper model (§6):

    dropout(0.6) -> GAT(8 heads, concat, attn-dropout 0.6) -> ELU
    -> dropout(0.6) -> GAT(8 heads, average, attn-dropout 0.6) -> log_softmax

Params are a list with one dict of tensors per layer, like the JAX
package's pytree, so a ``balance`` array partitions model and params alike.

Randomness is keyed, never drawn from shared state: ``apply`` takes an
integer key, ``fold_in`` derives one key per layer from it, and a dropout
layer seeds a fresh counter-based generator from its key on the device of
its input. The same key therefore redraws the same masks, which is what
lets the pipeline engine re-materialize a stage in its backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.graphs.data import GraphBatch
from repro_torch.models.gnn import layers as L


_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new non-negative 63-bit key from ``key`` and ``data`` (the role of
    ``jax.random.fold_in``; a splitmix64 finalizer, not JAX's bits). The same
    pair always gives the same key."""
    z = (key + (data + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def layer_keys(key: int | None, n_layers: int) -> list[int | None]:
    """One key per layer (``fold_in(key, layer)``), or Nones without a key."""
    if key is None:
        return [None] * n_layers
    return [fold_in(key, i) for i in range(n_layers)]


def _generator(key: int | None, x: torch.Tensor, active: bool) -> torch.Generator | None:
    """A fresh generator seeded from ``key`` on ``x``'s device, only where a
    draw will happen (training with a positive rate)."""
    if key is None or not active:
        return None
    return torch.Generator(device=x.device).manual_seed(key)


@dataclasses.dataclass(frozen=True)
class SeqLayer:
    """One element of a sequential model: ``init(generator) -> params`` and
    ``apply(params, graph, h, key, train) -> h`` (``key`` an int or None)."""

    name: str
    init: Callable[[torch.Generator | None], Any]
    apply: Callable[[Any, GraphBatch, torch.Tensor, int | None, bool], torch.Tensor]


def _no_params(generator):
    return {}


def _dropout_layer(rate: float, name: str) -> SeqLayer:
    def apply(p, g, h, key, train):
        return L.dropout(h, rate, _generator(key, h, train and rate > 0.0), train)

    return SeqLayer(name, _no_params, apply)


def _elu_layer() -> SeqLayer:
    return SeqLayer(
        "elu", _no_params, lambda p, g, h, key, train: torch.nn.functional.elu(h)
    )


def _log_softmax_layer() -> SeqLayer:
    return SeqLayer(
        "log_softmax", _no_params, lambda p, g, h, key, train: torch.log_softmax(h, dim=-1)
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
    def apply(p, g, h, key, train):
        return L.gat_layer(
            p, g, h, concat=concat, attn_dropout=attn_dropout,
            generator=_generator(key, h, train and attn_dropout > 0.0),
            train=train, backend=backend,
        )

    return SeqLayer(
        name, lambda gen: L.init_gat(in_dim, out_dim, heads=heads, generator=gen), apply
    )


def _gcn_seq_layer(name: str, in_dim: int, out_dim: int, *, backend: str) -> SeqLayer:
    return SeqLayer(
        name,
        lambda gen: L.init_gcn(in_dim, out_dim, generator=gen),
        lambda p, g, h, key, train: L.gcn_layer(p, g, h, backend=backend),
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
        rng: int | None = None,
        train: bool = False,
    ) -> torch.Tensor:
        """Run every layer; when training, layer i's dropout draws from
        ``fold_in(rng, i)``."""
        h = g.features if h is None else h
        for layer, p, key in zip(self.layers, params, layer_keys(rng, len(self.layers))):
            h = layer.apply(p, g, h, key, train)
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


def build_imbalanced_gcn(
    num_features: int,
    num_classes: int,
    *,
    hidden: tuple[int, ...] = (256, 256, 32, 32, 32, 32),
    backend: str = "padded",
) -> GNNModel:
    """A deliberately cost-imbalanced GCN stack — the partitioner's benchmark
    and test fixture: the leading layers are an order of magnitude wider
    than the tail, so a layer-count-uniform ``balance`` packs the heavy
    layers into one stage."""
    L.canonical_backend(backend)
    dims = [num_features, *hidden, num_classes]
    layers = tuple(
        _gcn_seq_layer(f"gcn_{i}", dims[i], dims[i + 1], backend=backend)
        for i in range(len(dims) - 1)
    ) + (_log_softmax_layer(),)
    return GNNModel(layers=layers, in_dim=num_features, out_dim=num_classes)


def build_gnn(
    kind: str,
    num_features: int,
    num_classes: int,
    *,
    hidden: int = 64,
    depth: int = 2,
    backend: str = "padded",
) -> GNNModel:
    """Generic builder in the same sequential form: ``gat`` (the paper
    model) and ``gcn`` (``depth`` GCN layers of width ``hidden`` with ELU
    between them). GraphConv and GatedGraphConv are not ported yet."""
    if kind == "gat":
        return build_paper_gat(num_features, num_classes, backend=backend)
    if kind in ("graphconv", "gatedgraphconv"):
        raise NotImplementedError(
            f"GNN kind {kind!r} is not ported to repro_torch yet (ROADMAP queue 1, item 5)"
        )
    if kind != "gcn":
        raise KeyError(f"unknown GNN kind {kind!r}")
    L.canonical_backend(backend)
    layers: list[SeqLayer] = []
    dims = [num_features] + [hidden] * (depth - 1) + [num_classes]
    for i in range(depth):
        layers.append(_gcn_seq_layer(f"gcn_{i}", dims[i], dims[i + 1], backend=backend))
        if i < depth - 1:
            layers.append(_elu_layer())
    layers.append(_log_softmax_layer())
    return GNNModel(layers=tuple(layers), in_dim=num_features, out_dim=num_classes)
