"""Public SSD op, model layout in and out, with autograd.

Counterpart of ``repro.kernels.ssd.ops.ssd``: x (b, s, h, p), dt (b, s, h),
A (h,), B/C (b, s, n); x, B and C in the model's dtype (float32 or bf16,
handed over uncast as the reference's op does), dt and A float32. Unlike
the JAX op it also returns the final state ``(b, h, p, n)`` float32, as
``ssd_chunked`` does, because the serving prefill hands it to the decode
cache. The op forms ``loga = A·dt`` and calls the
kernel wrapper (kernel on CUDA tensors, plain version on CPU tensors); the
backward differentiates the plain version (``plain_vjp``), as the JAX op's
custom VJP differentiates ``ssd_chunked``.

The kernel starts from a zero state. ``h0`` is taken on the CPU route; on a
CUDA tensor a nonzero ``h0`` raises (an all-zero one is the kernel's own
start). On a meta tensor (the dry run) ``h0`` cannot be read: the op takes
the kernel's zero-state start, which is what a prefill hands it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import kernel_call, plain_vjp
from repro_torch.kernels.ssd.kernel import cost, ssd_kernel
from repro_torch.kernels.ssd.ref import ssd_chunk_scan


def _loga(dt, A):
    return dt * A[None, None, :]


class _Ssd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk, h0):
        x, dt, B, C = (t.contiguous() for t in (x, dt, B, C))
        ctx.save_for_backward(x, dt, A, B, C, h0)
        ctx.chunk = chunk
        loga = _loga(dt, A)
        # one kernel call for the counter (``kernels.kernel_call``), whichever route
        with kernel_call("ssd_kernel", lambda: cost(x, B, chunk=chunk)):
            if h0 is not None:
                if x.is_cpu:
                    return tuple(t.contiguous() for t in ssd_chunk_scan(
                        x, dt, loga, B, C, chunk=chunk, h0=h0))
                if x.is_cuda and bool(h0.count_nonzero()):
                    raise ValueError("the SSD kernel starts from a zero state; got a nonzero "
                                     "h0 on a CUDA tensor")
            return ssd_kernel(x, dt, loga.contiguous(), B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, ct_y, ct_h):
        *primals, h0 = ctx.saved_tensors
        grads = plain_vjp(
            lambda x, dt, A, B, C: ssd_chunk_scan(x, dt, _loga(dt, A), B, C, chunk=ctx.chunk,
                                                  h0=h0),
            primals, (ct_y, ct_h), needs=ctx.needs_input_grad[:5],
        )
        return (*grads, None, None)


def ssd(x, dt, A, B, C, chunk: int = 128, h0=None):
    """Mamba2 SSD -> (y (b, s, h, p), final state (b, h, p, n) float32)."""
    return _Ssd.apply(x, dt, A, B, C, int(chunk), h0)
