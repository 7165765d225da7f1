"""Plain PyTorch versions of the fused GAT neighbor-attention kernel.

Math (paper eq. 3–4, per head):

    e[i,j]     = LeakyReLU(s_self[i] + s_nbr[i,j])     (-1e9 where masked)
    alpha[i,:] = exp(e - max) * mask / max(sum, 1e-30)
    out[i]     = Σ_j alpha[i,j] · x[nbr[i,j]]

``gat_aggregate_ref`` and ``bucket_gat_ref`` keep the signatures of the JAX
oracles in ``repro.kernels.gat_edge.ref`` (head-major, pre-gathered scores).
``gat_edge_ref`` is the same math at the op's level — the layer's own
``(N, H, F)`` layout, ungathered scores and an optional ``row_node`` map —
and is what the kernel wrappers take on CPU tensors, what the ops'
backward differentiates, and what the kernel is checked against on the card.
"""

from __future__ import annotations

import torch

_NEG = -1e9


def _masked_alpha(scores: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    scores = scores.float().masked_fill(~mask, _NEG)
    m = scores.amax(dim=dim, keepdim=True)
    p = torch.exp(scores - m) * mask
    l = p.sum(dim=dim, keepdim=True).clamp_min(1e-30)
    return p / l


def gat_aggregate_ref(
    nbr_hw: torch.Tensor,  # (H, N, D, F) gathered neighbor features
    s_self: torch.Tensor,  # (H, N)
    s_nbr: torch.Tensor,  # (H, N, D)
    mask: torch.Tensor,  # (N, D) bool
    *,
    negative_slope: float = 0.2,
) -> torch.Tensor:  # (H, N, F)
    scores = torch.nn.functional.leaky_relu(s_self[..., None] + s_nbr, negative_slope)
    alpha = _masked_alpha(scores, mask[None], -1).to(nbr_hw.dtype)
    return torch.einsum("hnd,hndf->hnf", alpha, nbr_hw)


def bucket_gat_ref(
    hw_heads: torch.Tensor,  # (H, N, F) full feature matrix
    neighbors: torch.Tensor,  # (R, W) int32, one bucket's rows
    s_self: torch.Tensor,  # (H, R)
    s_nbr: torch.Tensor,  # (H, R, W)
    mask: torch.Tensor,  # (R, W) bool
    *,
    negative_slope: float = 0.2,
) -> torch.Tensor:  # (H, R, F)
    scores = torch.nn.functional.leaky_relu(s_self[..., None] + s_nbr, negative_slope)
    alpha = _masked_alpha(scores, mask[None], -1).to(hw_heads.dtype)
    return torch.einsum("hrw,hrwf->hrf", alpha, hw_heads[:, neighbors.long()])


def gat_edge_ref(
    hw: torch.Tensor,  # (N, H, F)
    s_src: torch.Tensor,  # (N, H)
    s_dst: torch.Tensor,  # (N, H)
    neighbors: torch.Tensor,  # (R, W) int32
    mask: torch.Tensor,  # (R, W) bool
    row_node: torch.Tensor | None = None,  # (R,) int32; None: rows are nodes
    *,
    negative_slope: float = 0.2,
) -> torch.Tensor:  # (R, H, F)
    """The kernel's function in the layer's layout (the op-level plain
    version). Materializes the (R, W, H, F) gather the kernel avoids."""
    nbr = neighbors.long()
    rows = row_node.long() if row_node is not None else torch.arange(
        neighbors.shape[0], device=neighbors.device
    )
    scores = torch.nn.functional.leaky_relu(
        s_src[rows][:, None, :] + s_dst[nbr], negative_slope
    )  # (R, W, H)
    alpha = _masked_alpha(scores, mask[..., None], 1).to(hw.dtype)
    return torch.einsum("rwh,rwhf->rhf", alpha, hw[nbr])
