"""Public ops for the fused GAT aggregation kernel, with autograd.

Counterpart of ``repro.kernels.gat_edge.ops``, same signatures:

* ``gat_aggregate(hw, s_src, s_dst, neighbors, mask, negative_slope)`` —
  the padded layout; one kernel launch.
* ``bucketed_gat_aggregate(hw, s_src, s_dst, neighbors, masks, row_nodes,
  gather_rows, negative_slope)`` — the degree-bucketed layout; one launch
  per non-empty bucket, rows put back in node order through ``gather_rows``.

The forward goes through the kernel wrappers (kernel on CUDA tensors, plain
version on CPU tensors). The backward recomputes the forward through the
op-level plain version ``ref.gat_edge_ref`` and differentiates it — the
kernel-forward / plain-backward pairing of the JAX ops' custom VJP (the TPU
kernels had no backward kernel either).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.gat_edge.kernel import bucket_gat_kernel, gat_aggregate_kernel
from repro_torch.kernels.gat_edge.ref import gat_edge_ref


def _contiguous(*ts):
    return tuple(t.contiguous() for t in ts)


def _plain_vjp(fn, primals, ct):
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in primals]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, ct)


class _GatAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hw, s_src, s_dst, neighbors, mask, negative_slope):
        hw, s_src, s_dst = _contiguous(hw, s_src, s_dst)
        ctx.save_for_backward(hw, s_src, s_dst, neighbors, mask)
        ctx.negative_slope = negative_slope
        return gat_aggregate_kernel(
            hw, s_src, s_dst, neighbors, mask, negative_slope=negative_slope
        )

    @staticmethod
    def backward(ctx, ct):
        hw, s_src, s_dst, neighbors, mask = ctx.saved_tensors
        grads = _plain_vjp(
            lambda a, b, c: gat_edge_ref(
                a, b, c, neighbors, mask, negative_slope=ctx.negative_slope
            ),
            (hw, s_src, s_dst),
            ct,
        )
        return (*grads, None, None, None)


def gat_aggregate(hw, s_src, s_dst, neighbors, mask, negative_slope=0.2):
    """(N, H, F) aggregated outputs over the padded layout."""
    return _GatAggregate.apply(hw, s_src, s_dst, neighbors, mask, negative_slope)


def _bucketed_forward(kernel, hw, s_src, s_dst, neighbors, masks, row_nodes, gather_rows, slope):
    outs = []
    for nbr, mask, row in zip(neighbors, masks, row_nodes):
        if nbr.shape[0] == 0:
            outs.append(hw.new_zeros((0,) + tuple(hw.shape[1:])))
            continue
        outs.append(kernel(hw, s_src, s_dst, nbr, mask, row, negative_slope=slope))
    return torch.cat(outs, dim=0)[gather_rows.long()]


class _BucketedGatAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hw, s_src, s_dst, neighbors, masks, row_nodes, gather_rows, negative_slope):
        hw, s_src, s_dst = _contiguous(hw, s_src, s_dst)
        ctx.save_for_backward(hw, s_src, s_dst)
        ctx.layout = (neighbors, masks, row_nodes, gather_rows)
        ctx.negative_slope = negative_slope
        return _bucketed_forward(
            bucket_gat_kernel, hw, s_src, s_dst, neighbors, masks, row_nodes,
            gather_rows, negative_slope,
        )

    @staticmethod
    def backward(ctx, ct):
        grads = _plain_vjp(
            lambda a, b, c: _bucketed_forward(
                gat_edge_ref, a, b, c, *ctx.layout, ctx.negative_slope
            ),
            ctx.saved_tensors,
            ct,
        )
        return (*grads, None, None, None, None, None)


def bucketed_gat_aggregate(
    hw, s_src, s_dst, neighbors, masks, row_nodes, gather_rows, negative_slope=0.2
):
    """(N, H, F) aggregated outputs over the degree-bucketed layout.

    ``neighbors``/``masks``/``row_nodes`` are equal-length tuples of one
    bucket's ``(R_b, W_b)`` tiles (+ ``(R_b,)`` original-row map);
    ``gather_rows`` maps node i into the bucket concatenation.
    """
    return _BucketedGatAggregate.apply(
        hw, s_src, s_dst, tuple(neighbors), tuple(masks), tuple(row_nodes),
        gather_rows, negative_slope,
    )
