"""Public flash-attention op, model layout in and out, with autograd.

Counterpart of ``repro.kernels.flash.ops.flash_attention``: q (B, S, H, hd),
k/v (B, S, KV, hd[_v]) -> (B, S, H, hd_v). The forward goes through the
kernel wrapper (kernel on CUDA tensors, plain version on CPU tensors); the
backward differentiates the plain version (``plain_vjp``), as the JAX op's
custom VJP differentiates its blocked reference. The kernel reads the model
layout itself, so no axis is moved on the way in or out.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import plain_vjp
from repro_torch.kernels.flash.kernel import flash_attention_kernel
from repro_torch.kernels.flash.ref import flash_attention_ref


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, softcap, kv_block):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.save_for_backward(q, k, v)
        ctx.args = (window, softcap, kv_block)
        return flash_attention_kernel(q, k, v, window=window, softcap=softcap, kv_block=kv_block)

    @staticmethod
    def backward(ctx, ct):
        window, softcap, kv_block = ctx.args
        grads = plain_vjp(
            lambda a, b, c: flash_attention_ref(a, b, c, window=window, softcap=softcap,
                                                kv_block=kv_block),
            ctx.saved_tensors, ct, needs=ctx.needs_input_grad[:3],
        )
        return (*grads, None, None, None)


def flash_attention(q, k, v, window: int = 0, softcap: float = 0.0, kv_block: int = 512):
    """Causal attention with optional sliding window and softcap, query and
    key positions ``arange(S)``. ``kv_block`` sizes the plain version's KV
    blocks on the CPU route."""
    return _Flash.apply(q, k, v, int(window), float(softcap), int(kv_block))
