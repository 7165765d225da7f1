"""Plain reference of the paper's GAT (Veličković et al., ICLR 2018, §3.3):

    dropout(p) -> GAT(heads x hidden, concat) -> ELU -> dropout(p)
    -> GAT(output_heads x classes, head average) -> log_softmax

One GAT layer, per head: ``Wh = h W``, ``e_ij = LeakyReLU(a_src·Wh_i +
a_dst·Wh_j)`` over node i's neighbors j (itself included), ``alpha_i =
softmax_j(e_ij)``, ``out_i = Σ_j alpha_ij Wh_j + b``. No attention dropout
(the configuration's departure). Weights are laid out as the program takes
them: a list with one dict per layer of the sequence above.

``work`` counts, from the shapes and the live slots alone, what one forward
pass over every chunk needs (``gnnbench.costs``): per GAT layer (heads H,
width F, n nodes, E live slots: kept neighbors and self-loops) the transform
``2·n·d_in·H·F`` and score projections ``4·n·H·F`` FLOPs, and the
aggregation's operations (per live slot and head an add, LeakyReLU, max,
subtract, exp, sum and divide, 7, and F multiply-adds, ``2F``) and bytes
(the transformed features and both score vectors of every node read once,
one int32 neighbor index per live slot, the output rows written once).
"""

from __future__ import annotations

import torch

from gnnbench.costs import F32, add
from gnnbench.reference.common import Precision, dropout, glorot, segment_softmax

DROPOUT_LAYERS = (0, 3)  # positions of the two dropouts in the layer sequence
GAT_LAYERS = (1, 4)


def _layers(cfg: dict) -> list[tuple[int, int, int, int]]:
    """(position, heads, d_in, d_out) of each GAT layer."""
    heads, hidden = cfg["heads"], cfg["hidden_per_head"]
    return [(GAT_LAYERS[0], heads, cfg["num_features"], hidden),
            (GAT_LAYERS[1], cfg["output_heads"], heads * hidden, cfg["num_classes"])]


def make_params(cfg: dict, seed: int, device) -> list[dict]:
    """The weights of a run, drawn on ``device`` from ``seed``: Glorot-uniform
    ``w`` (heads, in, out) and ``a_src``/``a_dst`` (heads, out), zero ``b``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params: list[dict] = [{} for _ in range(6)]
    for layer, heads, d_in, d_out in _layers(cfg):
        params[layer] = {
            "w": glorot(gen, (heads, d_in, d_out), d_in, d_out, device),
            "a_src": glorot(gen, (heads, d_out), d_out, 1, device),
            "a_dst": glorot(gen, (heads, d_out), d_out, 1, device),
            "b": torch.zeros((heads, d_out), device=device),
        }
    return params


def _gat(p: dict, layer: int, g, h, precision: Precision, *, concat: bool, slope: float):
    w = p[f"{layer}.w"]
    heads, d_in, d_out = w.shape
    n = h.shape[0]
    hw = precision.mm(h, w.permute(1, 0, 2).reshape(d_in, heads * d_out)).view(n, heads, d_out)
    s_src = (hw * p[f"{layer}.a_src"]).sum(-1)
    s_dst = (hw * p[f"{layer}.a_dst"]).sum(-1)
    scores = torch.nn.functional.leaky_relu(
        s_src.index_select(0, g.rows) + s_dst.index_select(0, g.cols), slope)
    alpha = segment_softmax(scores, g.rows, n)
    msg = alpha[..., None] * hw.index_select(0, g.cols)
    out = torch.zeros((n, heads, d_out), device=h.device).index_add(0, g.rows, msg)
    out = out + p[f"{layer}.b"]
    return out.reshape(n, heads * d_out) if concat else out.mean(dim=1)


def forward(cfg: dict, p: dict, g, precision: Precision, keys=None) -> torch.Tensor:
    """Log-probabilities of chunk ``g``; ``p`` maps ``"<layer>.<name>"`` to
    each weight; ``keys(layer)`` gives a dropout layer's key (None: eval)."""
    if cfg["attn_dropout"] != 0.0:
        raise ValueError("the reference draws no attention dropout")
    rate, slope = cfg["feat_dropout"], cfg["negative_slope"]
    h = dropout(g.features, rate, None if keys is None else keys(DROPOUT_LAYERS[0]))
    h = _gat(p, GAT_LAYERS[0], g, h, precision, concat=True, slope=slope)
    h = torch.nn.functional.elu(h)
    h = dropout(h, rate, None if keys is None else keys(DROPOUT_LAYERS[1]))
    h = _gat(p, GAT_LAYERS[1], g, h, precision, concat=False, slope=slope)
    return torch.log_softmax(h, dim=-1)


def work(cfg: dict, graphs) -> dict:
    """What one forward pass over ``graphs`` (objects with ``num_nodes`` and
    ``live``) needs: ``{"gat_agg": (operations, bytes, calls), "model_fwd":
    FLOPs}``, ``calls`` the aggregations it makes (a chunk's layer each)."""
    total: dict = {}
    for g in graphs:
        n, live = g.num_nodes, g.live
        for _, heads, d_in, f in _layers(cfg):
            ops = live * heads * (7 + 2 * f)
            nbytes = F32 * (n * heads * f + 2 * n * heads + live + n * heads * f)
            add(total, {"gat_agg": (ops, nbytes, 1),
                        "model_fwd": 2 * n * d_in * heads * f + 4 * n * heads * f + ops})
    return total
