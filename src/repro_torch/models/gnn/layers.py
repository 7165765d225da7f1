"""GCN and GAT layers over the padded-neighbor layout, with two aggregation
backends.

Counterpart of ``repro.models.gnn.layers`` (GCN and GAT; GraphConv,
GatedGraphConv and the ``dense`` backend are queued in ROADMAP queue 1,
item 5). Layers are an ``init_*`` returning a dict of tensors plus a plain
``*_layer`` function:

  * ``padded`` — gather neighbors along the (n, max_deg) layout with plain
    tensor ops (the reference semantics);
  * ``kernel`` — the hand-written CUDA aggregation kernels through
    ``repro_torch.kernels.gat_edge.ops`` (GAT) and
    ``repro_torch.kernels.spmm.ops`` (GCN): padded layout, or the
    degree-bucketed one when the graph is a ``BucketedGraphBatch``.
    ``pallas`` is accepted as its alias so the JAX command lines carry over.

The GAT layer follows the paper §2.1 / Veličković et al.: ``alpha_ij ∝
exp(LeakyReLU(a^T [Wh_i || Wh_j]))`` with multi-head concat or average,
attention dropout, masked softmax over the neighborhood.
"""

from __future__ import annotations

import math

import torch

from repro_torch.graphs.data import BucketedGraphBatch, GraphBatch

_NEG_INF = -1e9

BACKEND_ALIASES = {"padded": "padded", "kernel": "kernel", "pallas": "kernel"}


def canonical_backend(backend: str) -> str:
    """``padded`` or ``kernel`` (``pallas`` is an alias of ``kernel``)."""
    try:
        return BACKEND_ALIASES[backend]
    except KeyError:
        raise ValueError(
            f"unknown GAT backend {backend!r}; have {sorted(BACKEND_ALIASES)}"
        ) from None


def glorot(
    shape: tuple[int, ...], generator: torch.Generator | None = None
) -> torch.Tensor:
    """Glorot-uniform init over the last two axes (fan_in, fan_out)."""
    fan_in, fan_out = shape[-2], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * lim


def dropout(
    x: torch.Tensor, rate: float, generator: torch.Generator | None, train: bool
) -> torch.Tensor:
    """Inverted dropout drawn from ``generator``; identity unless training
    with a positive rate and a generator."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=generator.device) >= rate
    return torch.where(keep.to(x.device), x / (1.0 - rate), torch.zeros_like(x))


def init_gcn(in_dim: int, out_dim: int, *, generator: torch.Generator | None = None) -> dict:
    """Params with the JAX package's shapes: ``w`` (in, out), ``b`` (out,)."""
    return {"w": glorot((in_dim, out_dim), generator), "b": torch.zeros((out_dim,))}


def gcn_layer(
    params: dict, g: GraphBatch, h: torch.Tensor, *, backend: str = "padded"
) -> torch.Tensor:
    """H' = Â H W + b with symmetric normalization (Kipf & Welling)."""
    backend = canonical_backend(backend)
    hw = h @ params["w"]
    if backend == "kernel":
        from repro_torch.kernels.spmm.ops import bucketed_spmm, padded_spmm

        if isinstance(g, BucketedGraphBatch):
            nbrs = tuple(b.neighbors for b in g.buckets)
            nrms = tuple(b.norm for b in g.buckets)
            agg = bucketed_spmm(hw, nbrs, nrms, g.gather_rows)
        else:
            agg = padded_spmm(hw, g.neighbors, g.norm)
    else:
        agg = torch.einsum("nd,ndo->no", g.norm, hw[g.neighbors.long()])
    return agg + params["b"]


def init_gat(
    in_dim: int, out_dim: int, *, heads: int = 8, generator: torch.Generator | None = None
) -> dict:
    """Params with the JAX package's shapes: ``w`` (H, in, out),
    ``a_src``/``a_dst`` (H, out), ``b`` (H, out)."""
    return {
        "w": glorot((heads, in_dim, out_dim), generator),
        "a_src": glorot((heads, out_dim, 1), generator)[..., 0],
        "a_dst": glorot((heads, out_dim, 1), generator)[..., 0],
        "b": torch.zeros((heads, out_dim)),
    }


def _bucket_fields(g: BucketedGraphBatch):
    return (
        tuple(b.neighbors for b in g.buckets),
        tuple(b.mask for b in g.buckets),
        tuple(b.row_node for b in g.buckets),
    )


def gat_layer(
    params: dict,
    g: GraphBatch,
    h: torch.Tensor,
    *,
    concat: bool = True,
    attn_dropout: float = 0.0,
    negative_slope: float = 0.2,
    generator: torch.Generator | None = None,
    train: bool = False,
    backend: str = "padded",
) -> torch.Tensor:
    """Multi-head GAT layer (paper eq. 3–4). Returns (n, heads*out) if
    concat else (n, out) (head average, the paper's prediction layer)."""
    backend = canonical_backend(backend)
    if backend == "kernel" and attn_dropout > 0.0 and train and generator is not None:
        # checked before any kernel work: the fused softmax-aggregate kernel
        # cannot apply per-edge dropout inside the softmax
        raise ValueError(
            "kernel GAT backend is deterministic and cannot apply attention "
            f"dropout (attn_dropout={attn_dropout}) during training; set "
            "attn_dropout=0.0 or use the 'padded' backend"
        )
    heads, _, out_dim = params["w"].shape
    hw = torch.einsum("nf,hfo->nho", h, params["w"])  # (n, H, F')
    s_src = torch.einsum("nho,ho->nh", hw, params["a_src"])  # importance of i as dst
    s_dst = torch.einsum("nho,ho->nh", hw, params["a_dst"])  # importance of j as src

    if backend == "kernel":
        from repro_torch.kernels.gat_edge.ops import bucketed_gat_aggregate, gat_aggregate

        if isinstance(g, BucketedGraphBatch):
            nbrs, msks, rows = _bucket_fields(g)
            out = bucketed_gat_aggregate(
                hw, s_src, s_dst, nbrs, msks, rows, g.gather_rows, negative_slope
            )
        else:
            out = gat_aggregate(hw, s_src, s_dst, g.neighbors, g.mask, negative_slope)
    else:
        nbr = g.neighbors.long()
        mask = g.mask[..., None]
        scores = torch.nn.functional.leaky_relu(
            s_src[:, None, :] + s_dst[nbr], negative_slope
        )  # (n, max_deg, H)
        scores = scores.masked_fill(~mask, _NEG_INF)
        alpha = torch.softmax(scores, dim=1) * mask  # zero out fully-padded rows
        alpha = dropout(alpha, attn_dropout, generator, train)
        out = torch.einsum("ndh,ndho->nho", alpha, hw[nbr])

    out = out + params["b"]
    if concat:
        return out.reshape(out.shape[0], heads * out_dim)
    return out.mean(dim=1)
