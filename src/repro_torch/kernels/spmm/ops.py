"""Public ops for the SpMM kernel (GCN aggregation), with autograd.

Counterpart of ``repro.kernels.spmm.ops``, same signatures:

* ``padded_spmm(hw, neighbors, norm)`` — the square padded layout; one
  kernel launch.
* ``bucketed_spmm(hw, neighbors, norms, gather_rows)`` — the degree-bucketed
  layout; one launch per non-empty bucket, rows put back in node order
  through ``gather_rows``.

The forward goes through the kernel wrappers (kernel on CUDA tensors, plain
version on CPU tensors). The backward recomputes through the plain version
and differentiates it, giving gradients to ``hw`` and to the norms — the
kernel-forward / plain-backward pairing of the JAX ops' custom VJP (the TPU
kernels had no backward kernel either).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import plain_vjp
from repro_torch.kernels.spmm.kernel import bucket_spmm_kernel, padded_spmm_kernel
from repro_torch.kernels.spmm.ref import bucketed_spmm_ref, padded_spmm_ref


class _PaddedSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hw, neighbors, norm):
        hw, norm = hw.contiguous(), norm.contiguous()
        ctx.save_for_backward(hw, neighbors, norm)
        return padded_spmm_kernel(hw, neighbors, norm)

    @staticmethod
    def backward(ctx, ct):
        hw, neighbors, norm = ctx.saved_tensors
        needs = ctx.needs_input_grad
        d_hw, d_norm = plain_vjp(
            lambda a, w: padded_spmm_ref(a, neighbors, w), (hw, norm), ct,
            needs=(needs[0], needs[2]),
        )
        return d_hw, None, d_norm


def padded_spmm(hw, neighbors, norm):
    """out[i] = Σ_j norm[i,j] · hw[neighbors[i,j]] -> (N, F)."""
    return _PaddedSpmm.apply(hw, neighbors, norm)


class _BucketedSpmm(torch.autograd.Function):
    # the per-bucket tiles ride as flat positional tensors (neighbors, then
    # norms) so autograd can hand each norm tile its own gradient
    @staticmethod
    def forward(ctx, hw, gather_rows, n_buckets, *tiles):
        hw = hw.contiguous()
        neighbors, norms = tiles[:n_buckets], tuple(t.contiguous() for t in tiles[n_buckets:])
        ctx.save_for_backward(hw, gather_rows, *neighbors, *norms)
        ctx.n_buckets = n_buckets
        outs = [
            hw.new_zeros((0, hw.shape[1])) if nbr.shape[0] == 0
            else bucket_spmm_kernel(hw, nbr, nrm)
            for nbr, nrm in zip(neighbors, norms)
        ]
        return torch.cat(outs, dim=0)[gather_rows.long()]

    @staticmethod
    def backward(ctx, ct):
        hw, gather_rows, *tiles = ctx.saved_tensors
        b = ctx.n_buckets
        neighbors, norms = tuple(tiles[:b]), tuple(tiles[b:])
        needs = ctx.needs_input_grad
        grads = plain_vjp(
            lambda a, *w: bucketed_spmm_ref(a, neighbors, w, gather_rows),
            (hw, *norms), ct, needs=(needs[0], *needs[3 + b:]),
        )
        return (grads[0], None, None, *([None] * b), *grads[1:])


def bucketed_spmm(hw, neighbors, norms, gather_rows):
    """Degree-bucketed GCN aggregation back in original node order -> (N, F).

    ``neighbors``/``norms`` are equal-length tuples of per-bucket
    ``(R_b, W_b)`` tiles (indices into ``hw``'s rows); ``gather_rows`` maps
    node i to its row in the bucket concatenation.
    """
    neighbors, norms = tuple(neighbors), tuple(norms)
    if len(neighbors) != len(norms):
        raise ValueError(f"{len(neighbors)} neighbor tiles for {len(norms)} norm tiles")
    return _BucketedSpmm.apply(hw, gather_rows, len(neighbors), *neighbors, *norms)
