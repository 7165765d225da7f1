"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) in PyTorch.
Counterpart of ``repro.models.transformer.ssm``.

Recurrence (per head h, state dim N, head channels P):

    H_t = exp(A·dt_t) · H_{t-1} + dt_t · B_t ⊗ x_t        H: (P, N)
    y_t = C_t · H_t + D · x_t

``ssd_reference`` is the O(S) sequential oracle, ``ssd_chunked`` the
chunked matmul form (the SSD kernel's plain version), ``ssd_decode_step``
the one-token update. ``mamba2_apply`` runs the prefill's scan through the
SSD op (``repro_torch.kernels.ssd``): the hand-written kernel on the card,
the chunked form on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunk_scan
from repro_torch.models.transformer.common import normal_init, rms_norm


# ------------------------------------------------------------------- SSD --


def ssd_reference(x, dt, A, B, C, *, h0=None):
    """Sequential oracle. x: (b,s,h,p), dt: (b,s,h), A: (h,), B/C: (b,s,n).
    Returns (y (b,s,h,p), h_final (b,h,p,n))."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    hs = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) if h0 is None \
        else h0.float()
    ys = []
    for t in range(s):
        x_t, dt_t = x[:, t].float(), dt[:, t].float()
        a_t = torch.exp(A[None, :] * dt_t)  # (b,h)
        upd = torch.einsum("bhp,bn->bhpn", x_t * dt_t[..., None], B[:, t].float())
        hs = a_t[..., None, None] * hs + upd
        ys.append(torch.einsum("bhpn,bn->bhp", hs, C[:, t].float()))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype), hs


def ssd_chunked(x, dt, A, B, C, *, chunk: int, h0=None):
    """Chunked SSD (the mamba2 paper's matmul form). Shapes as
    ``ssd_reference``; sequences are padded to a chunk multiple internally."""
    return ssd_chunk_scan(x, dt, dt * A[None, None, :], B, C, chunk=chunk, h0=h0)


def ssd_decode_step(h_state, x, dt, A, B, C):
    """One-token state update. h_state: (b,h,p,n); x: (b,h,p); dt: (b,h);
    B/C: (b,n). Returns (y (b,h,p), h_new)."""
    a_t = torch.exp(A[None, :] * dt.float())
    upd = torch.einsum("bhp,bn->bhpn", x.float() * dt[..., None], B.float())
    h_new = a_t[..., None, None] * h_state + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, C.float())
    return y.to(x.dtype), h_new


# ----------------------------------------------------------- mamba2 block --


def mamba2_init(gen: torch.Generator, d: int, *, expand: int, head_dim: int, n_state: int,
                conv_width: int, lead=(), dtype=torch.float32) -> dict:
    """One Mamba2 mixer's params, each with leading dims ``lead``."""
    lead = tuple(lead)
    d_in = expand * d
    h = d_in // head_dim
    conv_dim = d_in + 2 * n_state
    dev = gen.device

    def const(values):  # per-head constants, repeated over the stacked layers
        return values.to(dev).expand(*lead, h).clone()

    return {
        "in_proj": normal_init(gen, (*lead, d, 2 * d_in + 2 * n_state + h), dtype=dtype),
        "conv_w": normal_init(gen, (*lead, conv_width, conv_dim), scale=0.2, dtype=dtype),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=dev),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32))),
        "dt_bias": const(torch.full((h,), -4.6, dtype=torch.float32)),  # softplus^-1(0.01)
        "D": const(torch.ones((h,), dtype=torch.float32)),
        "gate_norm": torch.zeros((*lead, d_in), dtype=dtype, device=dev),
        "out_proj": normal_init(gen, (*lead, d_in, d), dtype=dtype),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, state=None):
    """Depthwise causal conv. xbc: (bt, s, c); w: (width, c). ``state``:
    (bt, width-1, c) left context (zeros when None). Returns
    (silu(conv), new state = the last width-1 inputs)."""
    width = w.shape[0]
    if state is None:
        state = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[-1]))
    full = torch.cat([state, xbc], dim=1)
    s = xbc.shape[1]
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + full[:, i:i + s].float() * w[i].float()
    out = out + b.float()
    new_state = full[:, full.shape[1] - (width - 1):]
    return F.silu(out).to(xbc.dtype), new_state


def mamba2_apply(
    p: dict,
    x: torch.Tensor,  # (bt, s, d)
    *,
    expand: int,
    head_dim: int,
    n_state: int,
    chunk: int,
    ssm_state: torch.Tensor | None = None,  # (bt, h, p, n) decode carry
    conv_state: torch.Tensor | None = None,  # (bt, width-1, conv_dim)
    decode: bool = False,
):
    """Mamba2 mixer (no outer residual or norm: the block owns those).
    Returns (y, (ssm_state, conv_state)), the states after this call. The
    prefill (``decode=False``) scans from ``ssm_state`` (zero when None)
    through the SSD op."""
    bt, s, d = x.shape
    d_in = expand * d
    h = d_in // head_dim

    proj = x @ p["in_proj"]  # (bt, s, 2*d_in + 2n + h)
    z, xbc, dt_raw = proj.split([d_in, d_in + 2 * n_state, h], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], state=conv_state)
    x_ssm, B, C = xbc.split([d_in, n_state, n_state], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (bt,s,h)
    A = -torch.exp(p["A_log"])

    xh = x_ssm.reshape(bt, s, h, head_dim)
    if decode:
        if s != 1:
            raise ValueError(f"decode takes one token, got {s}")
        y1, new_ssm = ssd_decode_step(ssm_state, xh[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
        y = y1[:, None]
    else:
        y, new_ssm = ssd(xh, dt, A, B, C, chunk, ssm_state)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh.to(y.dtype)
    y = y.reshape(bt, s, d_in)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = rms_norm(y * F.silu(z), p["gate_norm"])
    return y @ p["out_proj"], (new_ssm, new_conv)

