"""Public flash-attention op, model layout in and out, with autograd.

Counterpart of ``repro.kernels.flash.ops.flash_attention``: q (B, S, H, hd),
k/v (B, S, KV, hd[_v]) -> (B, S, H, hd_v), masked by the query and key
positions (row indices unless given). The forward goes through the kernel
wrapper (kernel on CUDA tensors, plain version on CPU tensors); the
backward differentiates the plain version (``plain_vjp``), with the same
positions, as the JAX op's custom VJP differentiates its blocked reference.
The kernel reads the model layout itself, so no axis is moved on the way in
or out.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import plain_vjp
from repro_torch.kernels.flash.kernel import flash_attention_kernel
from repro_torch.kernels.flash.ref import flash_attention_ref


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, softcap, kv_block, q_pos, kv_pos, ordered):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.save_for_backward(q, k, v, q_pos, kv_pos)
        ctx.args = (window, softcap, kv_block)
        return flash_attention_kernel(q, k, v, window=window, softcap=softcap, kv_block=kv_block,
                                      q_pos=q_pos, kv_pos=kv_pos, ordered=ordered)

    @staticmethod
    def backward(ctx, ct):
        window, softcap, kv_block = ctx.args
        q, k, v, q_pos, kv_pos = ctx.saved_tensors
        grads = plain_vjp(
            lambda a, b, c: flash_attention_ref(a, b, c, window=window, softcap=softcap,
                                                kv_block=kv_block, q_pos=q_pos, kv_pos=kv_pos),
            (q, k, v), ct, needs=ctx.needs_input_grad[:3],
        )
        return (*grads, None, None, None, None, None, None)


def flash_attention(q, k, v, window: int = 0, softcap: float = 0.0, kv_block: int = 512,
                    q_pos: torch.Tensor | None = None, kv_pos: torch.Tensor | None = None,
                    ordered: bool = False):
    """Causal attention with optional sliding window and softcap, masked by
    ``q_pos`` / ``kv_pos`` (int32, non-decreasing; row indices when None;
    ``ordered``: already checked, so the kernel wrapper reads nothing).
    ``kv_block`` sizes the plain version's KV blocks on the CPU route."""
    return _Flash.apply(q, k, v, int(window), float(softcap), int(kv_block), q_pos, kv_pos,
                        bool(ordered))
