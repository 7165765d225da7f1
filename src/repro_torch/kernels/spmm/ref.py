"""Plain PyTorch versions of the padded-neighbor SpMM (GCN aggregation):

    out[i] = Σ_j norm[i, j] · hw[neighbors[i, j]]

and its degree-bucketed variant, where rows live in per-bucket dense tiles
of geometric widths and ``gather_rows`` maps original node order into the
bucket-concatenated row space. Counterparts of ``repro.kernels.spmm.ref``
with the same signatures; there is no mask: padding slots carry norm 0 and
index 0, and every slot is summed.
"""

from __future__ import annotations

import torch


def padded_spmm_ref(
    hw: torch.Tensor, neighbors: torch.Tensor, norm: torch.Tensor
) -> torch.Tensor:
    """hw: (N, F); neighbors: (R, D) int32 rows indexing ``hw``; norm: (R, D)
    (0 on padding) -> (R, F). R = N for the padded layout, one bucket's
    row count for a degree bucket."""
    return torch.einsum("nd,ndf->nf", norm, hw[neighbors.long()])


def bucketed_spmm_ref(
    hw: torch.Tensor,  # (N, F)
    neighbors: tuple[torch.Tensor, ...],  # per bucket (R_b, W_b) int32
    norms: tuple[torch.Tensor, ...],  # per bucket (R_b, W_b), 0 on padding
    gather_rows: torch.Tensor,  # (N,) int32 into the bucket-concat row space
) -> torch.Tensor:  # (N, F)
    """Per-bucket weighted gather, concatenated and permuted back to node order."""
    outs = [padded_spmm_ref(hw, nbr, nrm) for nbr, nrm in zip(neighbors, norms)]
    return torch.cat(outs, dim=0)[gather_rows.long()]
