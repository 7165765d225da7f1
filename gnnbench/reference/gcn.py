"""Plain reference of the GCN of Kipf & Welling (ICLR 2017, §5.2), at the
configuration's depth and width:

    GCN(in -> hidden) -> act -> ... -> GCN(hidden -> classes) -> log_softmax

One layer: ``out_i = Σ_j norm_ij (h W)_j + b`` over node i's neighbors j
(itself included), ``norm_ij = 1/sqrt((d_i+1)(d_j+1))``, with the
configuration's activation between layers (ELU, where the paper has ReLU)
and no dropout (the paper's 0.5): its departures. Weights are laid
out as the program takes them: one dict per layer of the sequence above.

``work`` counts, from the shapes and the live slots alone, what one forward
pass over every chunk needs (``gnnbench.costs``): per layer (width F, n
nodes, E live slots) the transform ``2·n·d_in·F`` FLOPs and the
aggregation's ``2·E·F`` operations (a multiply-add per feature of each live
slot) and bytes (the transformed features read once, an int32 index and a
float32 norm per live slot, the output rows written once).
"""

from __future__ import annotations

import torch

from gnnbench.costs import F32, add
from gnnbench.reference.common import Precision, glorot


def _dims(cfg: dict) -> list[int]:
    return [cfg["num_features"]] + [cfg["hidden"]] * (cfg["depth"] - 1) + [cfg["num_classes"]]


def make_params(cfg: dict, seed: int, device) -> list[dict]:
    """The weights of a run, drawn on ``device`` from ``seed``: Glorot-uniform
    ``w`` (in, out), zero ``b``; empty dicts for the activations and the
    log-softmax."""
    dims = _dims(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: list[dict] = []
    for i in range(len(dims) - 1):
        params.append({"w": glorot(gen, (dims[i], dims[i + 1]), dims[i], dims[i + 1], device),
                       "b": torch.zeros((dims[i + 1],), device=device)})
        params.append({})  # the activation after it, or the final log-softmax
    return params


def forward(cfg: dict, p: dict, g, precision: Precision, keys=None) -> torch.Tensor:
    """Log-probabilities of chunk ``g``; ``p`` maps ``"<layer>.<name>"`` to
    each weight. The model draws no dropout, so ``keys`` is unused."""
    if cfg["dropout"] != 0.0:
        raise ValueError("the reference draws no dropout")
    act = {"elu": torch.nn.functional.elu, "relu": torch.nn.functional.relu}[cfg["activation"]]
    depth = cfg["depth"]
    h = g.features
    for i in range(depth):
        hw = precision.mm(h, p[f"{2 * i}.w"])
        msg = g.norm[:, None] * hw.index_select(0, g.cols)
        h = torch.zeros((h.shape[0], hw.shape[1]), device=h.device).index_add(0, g.rows, msg)
        h = h + p[f"{2 * i}.b"]
        if i < depth - 1:
            h = act(h)
    return torch.log_softmax(h, dim=-1)


def work(cfg: dict, graphs) -> dict:
    """What one forward pass over ``graphs`` (objects with ``num_nodes`` and
    ``live``) needs: ``{"spmm_agg": (operations, bytes, calls), "model_fwd":
    FLOPs}``, ``calls`` the aggregations it makes (a chunk's layer each)."""
    dims = _dims(cfg)
    total: dict = {}
    for g in graphs:
        n, live = g.num_nodes, g.live
        for d_in, f in zip(dims, dims[1:]):
            ops = 2 * live * f
            add(total, {"spmm_agg": (ops, F32 * (n * f + 2 * live + n * f), 1),
                        "model_fwd": 2 * n * d_in * f + ops})
    return total
