"""Plain PyTorch version of the SSD chunk-scan kernel: the Mamba2 paper's
chunked matmul form (``repro.models.transformer.ssm.ssd_chunked``), taking
``loga = A·dt`` as the kernel does. Per chunk of Q tokens, with la the
in-chunk cumulative sum of loga:

    Y_intra = (C·Bᵀ ∘ exp(la_i - la_j) ∘ [j <= i]) · (x·dt)
    Y_inter = exp(la_i) · C · Hᵀ
    H'      = exp(la_Q) · H + (x·dt ∘ exp(la_Q - la_j))ᵀ · B

Sequences are padded to a chunk multiple (dt = loga = 0 pads are
state-neutral: decay 1, update 0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_chunk_scan(
    x: torch.Tensor,  # (b, s, h, p)
    dt: torch.Tensor,  # (b, s, h)
    loga: torch.Tensor,  # (b, s, h) = A[h] · dt
    B: torch.Tensor,  # (b, s, n)
    C: torch.Tensor,  # (b, s, n)
    *,
    chunk: int,
    h0: torch.Tensor | None = None,  # (b, h, p, n)
) -> tuple[torch.Tensor, torch.Tensor]:  # y (b, s, h, p), final state (b, h, p, n) f32
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, loga = F.pad(dt, (0, 0, 0, pad)), F.pad(loga, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    nc, q = (s + pad) // chunk, chunk
    xf = x.float().reshape(b, nc, q, h, p)
    dtf = dt.float().reshape(b, nc, q, h)
    Bf = B.float().reshape(b, nc, q, n)
    Cf = C.float().reshape(b, nc, q, n)
    la = torch.cumsum(loga.float().reshape(b, nc, q, h), dim=2)
    hs = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) if h0 is None \
        else h0.float()
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[None, :, :, None]

    ys = []
    for c in range(nc):
        x_c, dt_c, b_c, c_c, la_c = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c], la[:, c]
        xd = x_c * dt_c[..., None]  # (b,q,h,p)
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)
        # the mask goes inside the exp: above the diagonal la_i - la_j > 0 and
        # can overflow, and there exp's gradient (inf) times the mask's 0 is
        # NaN; exp(-inf) is 0 with a zero gradient. Same values either way.
        diff = la_c[:, :, None, :] - la_c[:, None, :, :]  # (b,i,j,h)
        g = cb[..., None] * torch.exp(torch.where(causal, diff, float("-inf")))
        y_intra = torch.einsum("bijh,bjhp->bihp", g, xd)
        y_inter = torch.einsum("bin,bhpn->bihp", c_c, hs) * torch.exp(la_c)[..., None]
        last = la_c[:, -1:, :]  # (b,1,h)
        dstate = torch.exp(last - la_c)  # (b,q,h)
        hs = torch.exp(last[:, 0])[..., None, None] * hs + torch.einsum(
            "bjn,bjhp->bhpn", b_c, xd * dstate[..., None])
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nc * q, h, p)[:, :s]
    return y.to(x.dtype), hs
