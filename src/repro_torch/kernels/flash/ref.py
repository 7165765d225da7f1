"""Plain PyTorch version of the flash-attention kernel: the model's
``blocked_attention`` with query and key positions ``q_pos`` and ``kv_pos``,
by default both ``arange`` — what the JAX op's own reference
(``repro.kernels.flash.ops._ref``) computes; other positions give the
model's mask (``repro.models.transformer.blocks.attn_apply`` masks m-rope
archs by the t-row)."""

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
    q_pos: torch.Tensor | None = None,  # (Sq,)
    kv_pos: torch.Tensor | None = None,  # (Skv,)
) -> torch.Tensor:  # (B, Sq, H, hd_v)
    if q_pos is None:
        q_pos = torch.arange(q.shape[1], device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(k.shape[1], device=k.device)
    return blocked_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window,
                             attn_softcap=softcap, kv_block=kv_block)
