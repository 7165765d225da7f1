"""SIGN — Scalable Inception Graph Networks (Frasca et al. 2020).

Counterpart of ``repro.graphs.sign``. The paper's §8 names SIGN as the
batching approach that suits pipelined GNNs: the r-hop diffusion operators
are precomputed once, after which the model is a plain MLP over the
concatenated diffused features, so micro-batching is exact (no graph
structure rides through the pipeline).

``sign_features``: X ↦ [X, ÂX, Â²X, …, ÂʳX]  (Â = sym-normalized adjacency)
``build_sign_mlp``: the inception-style classifier, as a ``GNNModel`` so the
pipeline engines drive it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.graphs.data import GraphBatch
from repro_torch.models.gnn import layers as L
from repro_torch.models.gnn.net import GNNModel, SeqLayer, _dropout_layer, _log_softmax_layer


def diffuse(g: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    """One Â·h step over the padded-neighbor layout."""
    return torch.einsum("nd,ndf->nf", g.norm, h[g.neighbors.long()])


def sign_features(g: GraphBatch, *, hops: int = 2) -> torch.Tensor:
    """(n, (hops+1)·d) concatenated diffusion features, precomputed once."""
    feats = [g.features]
    h = g.features
    for _ in range(hops):
        h = diffuse(g, h)
        feats.append(h)
    return torch.cat(feats, dim=-1)


def build_sign_mlp(
    in_dim: int, num_classes: int, *, hidden: int = 64, dropout: float = 0.5
) -> GNNModel:
    """Inception MLP over precomputed features. Structure-free: every layer
    ignores the graph, so any micro-batching strategy is exact."""

    def dense(name, din, dout, act):
        def init(generator):
            return {"w": L.glorot((din, dout), generator), "b": torch.zeros((dout,))}

        def apply(p, g, h, key, train):
            out = h @ p["w"] + p["b"]
            return act(out) if act is not None else out

        return SeqLayer(name, init, apply)

    layers = (
        dense("sign_fc0", in_dim, hidden, torch.relu),
        _dropout_layer(dropout, "dropout"),
        dense("sign_fc1", hidden, num_classes, None),
        _log_softmax_layer(),
    )
    return GNNModel(layers=layers, in_dim=in_dim, out_dim=num_classes)


def as_sign_graph(g: GraphBatch, *, hops: int = 2) -> GraphBatch:
    """The graph with SIGN-diffused features and its edges dropped
    (self-loops only): downstream exactness needs no structure, so it plugs
    into the pipeline engines under any chunking."""
    feats = sign_features(g, hops=hops)
    n, dev = g.num_nodes, feats.device
    return dataclasses.replace(
        g,
        features=feats,
        neighbors=torch.arange(n, dtype=torch.int32, device=dev)[:, None],
        mask=torch.ones((n, 1), dtype=torch.bool, device=dev),
        norm=torch.ones((n, 1), dtype=feats.dtype, device=dev),
    )
