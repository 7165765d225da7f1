"""Plain PyTorch version of the flash-attention kernel: the model's
``blocked_attention`` with query and key positions both ``arange`` — what
the JAX op's own reference (``repro.kernels.flash.ops._ref``) computes."""

from __future__ import annotations

import torch

from repro_torch.models.transformer.attention import blocked_attention


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd_v)
    *,
    window: int = 0,
    softcap: float = 0.0,
    kv_block: int = 512,
) -> torch.Tensor:  # (B, Sq, H, hd_v)
    q_pos = torch.arange(q.shape[1], device=q.device)
    kv_pos = torch.arange(k.shape[1], device=k.device)
    return blocked_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window,
                             attn_softcap=softcap, kv_block=kv_block)
