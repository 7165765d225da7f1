"""Shared transformer primitives: norms, rope and m-rope, initializers.

Counterpart of ``repro.models.transformer.common``.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with a zero-centred scale (``x · rsqrt(mean x² + eps) ·
    (1 + scale)``), computed in float32 and cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


def normal_init(
    gen: torch.Generator, shape, *, scale: float = 0.02, dtype=torch.float32, device=None
) -> torch.Tensor:
    """``scale``-scaled standard normals drawn from ``gen`` on ``device``
    (the generator's own device when None), scaled in place so a large leaf
    costs one allocation. On the meta device nothing is drawn: the leaf comes
    back empty (``model.abstract_params``). A ``gen`` with a ``normal``
    method (``model.ShardDraws``) draws the leaf itself."""
    if hasattr(gen, "normal"):
        return gen.normal(tuple(shape), scale=scale, dtype=dtype)
    device = gen.device if device is None else device
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    out = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    return out.mul_(scale).to(dtype)


# ------------------------------------------------------------------ rope --


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: broadcastable to
    (..., S) integers. Rotates the full head_dim (half-split convention)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    return _rotate(x, positions[..., None].float() * inv)  # angles (..., S, hd/2)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
                sections=(2, 1, 1)) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): positions (3, ..., S) for (t, h, w); the
    head_dim/2 frequency slots are split across the three components in
    ``sections`` proportion, the last taking the remainder."""
    hd = x.shape[-1]
    half = hd // 2
    total = sum(sections)
    sizes = [half * s // total for s in sections]
    sizes[-1] = half - sum(sizes[:-1])
    inv = rope_freqs(hd, theta, device=x.device)  # (half,)
    # each frequency slot takes the position component of its section
    pos = torch.cat([positions[c, ..., None].expand(*positions.shape[1:], n)
                     for c, n in enumerate(sizes)], dim=-1)  # (..., S, half)
    return _rotate(x, pos.float() * inv)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd) rotated by angles (..., S, hd/2), half-split, in
    float32, cast back to x's dtype."""
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
