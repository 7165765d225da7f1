"""Attention: blocked online-softmax (flash-style, plain PyTorch) and the
single-token decode path. Counterpart of
``repro.models.transformer.attention``.

``blocked_attention`` walks KV blocks with a running (max, sum, acc), so the
(Sq, Skv) score square is never held whole. It handles GQA head grouping,
sliding windows, the attention softcap and arbitrary query/key positions.
It is the plain version of the flash-attention kernel
(``repro_torch.kernels.flash``), which the prefill runs on the card.
``naive_attention`` is the quadratic oracle the tests hold both against.

``decode_attention`` attends one new token against a KV cache whose
sequence is split over the replicas of ``axis`` (a
``core.data_group.DataGroup``; one replica holds it whole), as the
reference's mesh ``axis`` does (flash-decoding): each replica scores its
own slots, the group takes the maximum, then sums the partial softmax
sums and outputs in ascending replica order.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.data_group import DataGroup
from repro_torch.models.transformer.common import softcap as _softcap

_NEG = -2.0e38  # large negative for f32 masking (avoids inf - inf NaNs)


def softmax_scale(hd: int) -> float:
    """1/sqrt(hd) rounded to float32, as the JAX code computes it."""
    return float(torch.tensor(1.0) / torch.sqrt(torch.tensor(float(hd))))


def _mask_ok(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int) -> torch.Tensor:
    """(Sq, Skv) bool: causal, and within ``window`` when it is > 0."""
    ok = kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok = ok & ((q_pos[:, None] - kv_pos[None, :]) < window)
    return ok


def blocked_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd_v)
    *,
    q_pos: torch.Tensor,  # (Sq,)
    kv_pos: torch.Tensor,  # (Skv,)
    window: int = 0,
    attn_softcap: float = 0.0,
    kv_block: int = 512,
) -> torch.Tensor:
    """Causal attention, O(Sq · kv_block) live scores, computed in float32
    (float64 for float64 inputs). Returns (B, Sq, H, hd_v) in ``q``'s dtype;
    K and V head dims may differ."""
    b, sq, h, hd = q.shape
    skv, kv_heads = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    g = h // kv_heads
    dt = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, sq, kv_heads, g, hd).to(dt) * softmax_scale(hd)

    m = torch.full((b, kv_heads, g, sq), _NEG, dtype=dt, device=q.device)
    l = torch.zeros((b, kv_heads, g, sq), dtype=dt, device=q.device)
    acc = torch.zeros((b, kv_heads, g, sq, hd_v), dtype=dt, device=q.device)
    for c0 in range(0, max(skv, 1), kv_block):
        k_i = k[:, c0:c0 + kv_block].to(dt)
        v_i = v[:, c0:c0 + kv_block].to(dt)
        ok = _mask_ok(q_pos, kv_pos[c0:c0 + kv_block], window)  # (Sq, c)
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, k_i)
        s = _softcap(s, attn_softcap)
        s = s + torch.where(ok, 0.0, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * ok
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, v_i)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, KV, G, Sq, hd_v)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd_v).to(q.dtype)


def naive_attention(q, k, v, *, q_pos, kv_pos, window: int = 0, attn_softcap: float = 0.0):
    """The O(S²)-memory oracle (``repro.kernels.flash.ref.naive_attention``).
    Shapes as ``blocked_attention``."""
    b, sq, h, hd = q.shape
    kv_heads = k.shape[2]
    g = h // kv_heads
    qg = q.reshape(b, sq, kv_heads, g, hd).float()
    s = torch.einsum("bikgd,bjkd->bkgij", qg, k.float()) / math.sqrt(hd)
    s = _softcap(s, attn_softcap)
    ok = _mask_ok(q_pos, kv_pos, window)
    s = torch.where(ok, s, -1e30)
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgij,bjkd->bikgd", a, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def _decode_scores(q, k_cache, kv_pos, cur_pos, window, attn_softcap):
    """(scores (B, KV, G, W) float32, mask (W,)) of one token over a cache."""
    b, h, hd = q.shape
    kv_heads = k_cache.shape[2]
    qg = q.reshape(b, kv_heads, h // kv_heads, hd).float() * softmax_scale(hd)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float())
    s = _softcap(s, attn_softcap)
    ok = (kv_pos >= 0) & (kv_pos <= cur_pos)
    if window > 0:
        ok = ok & ((cur_pos - kv_pos) < window)
    return torch.where(ok, s, _NEG), ok


def decode_attention(
    q: list,  # per replica (B, H, hd) — one new token
    k_cache: list,  # per replica (B, W, KV, hd): its slots
    v_cache: list,  # per replica (B, W, KV, hd_v)
    kv_pos: list,  # per replica (W,) positions; < 0 marks empty slots
    cur_pos: int,  # position of the new token
    *,
    window: int = 0,
    attn_softcap: float = 0.0,
    axis: DataGroup | None = None,
) -> list:
    """Single-token attention against a ring-buffer cache split over the
    replicas of ``axis`` (default ``DataGroup(1)``: one replica, its cache
    whole): every argument but ``cur_pos`` is a list over the local
    replicas, and so is the result, one (B, H, hd_v) each."""
    axis = DataGroup(1) if axis is None else axis
    parts = [_decode_scores(qi, ki, pi, cur_pos, window, attn_softcap)
             for qi, ki, pi in zip(q, k_cache, kv_pos)]
    ms = axis.max([s.amax(dim=-1) for s, _ in parts])
    sums = []
    for (s, ok), m, v in zip(parts, ms, v_cache):
        p = torch.exp(s - m[..., None]) * ok
        sums.append(torch.cat([torch.einsum("bkgc,bckd->bkgd", p, v.float()),
                               p.sum(dim=-1)[..., None]], dim=-1))
    outs = []
    for qi, v, tot in zip(q, v_cache, axis.sum(sums)):
        acc, l = tot[..., :-1], tot[..., -1]
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.reshape(qi.shape[0], qi.shape[1], v.shape[-1]).to(qi.dtype))
    return outs
