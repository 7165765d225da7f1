"""Mixture-of-Experts on one device. Counterpart of
``repro.models.transformer.moe`` without expert parallelism (``ep_axis``).

Routing is sort-based capacity dispatch, as the reference's:

  token→expert assignments are sorted by expert id (stably), each expert
  keeps its first ``capacity`` tokens, an (E, capacity) gather table
  dispatches, and the weighted expert outputs are combined per token.

The reference combines with a scatter-add over the token table. The port
keeps the inverse map instead — each (token, j) pair's slot, or a zero row
when the pair was dropped — and sums each token's k contributions from it:
a gather, so the forward has no atomics and is deterministic on any device.
Autograd makes the gathers' backward (the combine's and the dispatch
``x[tok_table]``'s) accumulating index-puts, which run deterministically
under ``torch.use_deterministic_algorithms(True)``.

Supports softmax top-k, sigmoid+bias selection (deepseek-v3: the bias picks
the experts, the unbiased scores weight them), shared experts and arctic's
parallel dense residual. The reference's expert-parallel modes
(``gathered``, ``a2a``, ``replicated``) need more than one card and are not
ported (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.common import normal_init
from repro_torch.models.transformer.ffn import ffn_apply, ffn_init


def moe_init(gen: torch.Generator, d: int, ff: int, *, num_experts: int, num_shared: int = 0,
             dense_residual: bool = False, router_kind: str = "softmax",
             mlp_kind: str = "swiglu", lead=(), dtype=torch.float32) -> dict:
    """Router (float32), per-expert SwiGLU weights (E, d, ff) and (E, ff,
    d), the sigmoid router's bias, the shared experts' FFN (width ff ×
    num_shared) and the dense residual FFN, each with leading dims ``lead``."""
    lead = tuple(lead)
    p = {
        "router": normal_init(gen, (*lead, d, num_experts), scale=0.006, dtype=torch.float32),
        "we_gate": normal_init(gen, (*lead, num_experts, d, ff), dtype=dtype),
        "we_up": normal_init(gen, (*lead, num_experts, d, ff), dtype=dtype),
        "we_down": normal_init(gen, (*lead, num_experts, ff, d), dtype=dtype),
    }
    if router_kind == "sigmoid":
        p["router_bias"] = torch.zeros((*lead, num_experts), dtype=torch.float32,
                                       device=gen.device)
    if num_shared:
        p["shared"] = ffn_init(gen, d, ff * num_shared, kind=mlp_kind, lead=lead, dtype=dtype)
    if dense_residual:
        p["dense"] = ffn_init(gen, d, ff, kind=mlp_kind, lead=lead, dtype=dtype)
    return p


def _route(p: dict, x: torch.Tensor, *, k: int, router_kind: str):
    """-> (topk_idx (T, k) int64, topk_w (T, k) float32, aux_loss 0-d)."""
    logits = x.float() @ p["router"]  # (T, E)
    e = logits.shape[-1]
    if router_kind == "sigmoid":
        scores = torch.sigmoid(logits)
        idx = torch.topk(scores + p["router_bias"][None, :], k, dim=-1).indices
        w = scores.gather(-1, idx)
        probs = scores / scores.sum(-1, keepdim=True).clamp(min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    # switch-style load-balance aux: E * Σ_e f_e · P_e
    flat = idx.reshape(-1)
    f = torch.zeros(e, device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, device=x.device)) / flat.numel()
    aux = e * (f * probs.mean(dim=0)).sum()
    return idx, w, aux


def _dispatch_tables(idx: torch.Tensor, w: torch.Tensor, *, num_experts: int, capacity: int):
    """Sort-based dispatch -> (token_table (E, C) int64, weight_table (E, C)
    float32, inverse (T, k) int64). Empty slots point at token 0 with weight
    0; ``inverse[t, j]`` is the flat slot e·C + pos of token t's j-th
    choice, or E·C where it was dropped (pos >= capacity)."""
    t, k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    st = torch.div(order, k, rounding_mode="floor")  # the token of each sorted pair
    sw = w.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(num_experts, device=dev, dtype=se.dtype))
    pos = torch.arange(t * k, device=dev) - starts[se]
    n = num_experts * capacity
    slot = torch.where(pos < capacity, se * capacity + pos, n)
    # slot n collects the dropped pairs and is cut off
    tok_table = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_put_((slot,), st)
    w_table = torch.zeros(n + 1, dtype=w.dtype, device=dev).index_put((slot,), sw)
    inverse = torch.empty_like(slot).index_put_((order,), slot)
    return (tok_table[:-1].view(num_experts, capacity), w_table[:-1].view(num_experts, capacity),
            inverse.view(t, k))


def _expert_ffn(p: dict, xin: torch.Tensor, *, mlp_kind: str) -> torch.Tensor:
    """xin: (E, C, d) with per-expert weights (E, d, ff) -> (E, C, d)."""
    if mlp_kind in ("swiglu", "geglu"):
        gate = torch.bmm(xin, p["we_gate"])
        gate = F.silu(gate) if mlp_kind == "swiglu" else F.gelu(gate, approximate="tanh")
        h = gate * torch.bmm(xin, p["we_up"])
    else:
        h = F.gelu(torch.bmm(xin, p["we_up"]), approximate="tanh")
    return torch.bmm(h, p["we_down"])


def expert_capacity(tokens: int, k: int, num_experts: int,
                    capacity_factor: float = 1.25) -> int:
    """Slots per expert for one call of ``tokens`` tokens:
    ``max(8, ceil(T·k/E·capacity_factor))``."""
    return max(8, math.ceil(tokens * k / num_experts * capacity_factor))


def moe_apply(p: dict, x: torch.Tensor, *, num_experts: int, k: int,
              router_kind: str = "softmax", mlp_kind: str = "swiglu",
              capacity_factor: float = 1.25, ep_axis: str | None = None):
    """x (T, d), the tokens of one call -> (out (T, d), aux_loss). Capacity
    (``expert_capacity``) is over this call's tokens, so which tokens are
    dropped depends on the call: the model routes once per (stage,
    micro-batch), as the reference's pipeline does."""
    if ep_axis is not None:
        raise NotImplementedError("expert parallelism (ep_axis) needs more than one card "
                                  "(ROADMAP queue 1 item 9)")
    t, d = x.shape
    idx, w, aux = _route(p, x, k=k, router_kind=router_kind)
    capacity = expert_capacity(t, k, num_experts, capacity_factor)
    tok_table, w_table, inverse = _dispatch_tables(idx, w, num_experts=num_experts,
                                                   capacity=capacity)
    yout = _expert_ffn(p, x[tok_table], mlp_kind=mlp_kind)  # (E, C, d)
    contrib = (yout * w_table[..., None]).float().reshape(-1, d)
    contrib = torch.cat([contrib, contrib.new_zeros((1, d))])  # the dropped pairs' row
    out = contrib[inverse].sum(dim=1).to(x.dtype)  # each token's k choices
    if "shared" in p:
        out = out + ffn_apply(p["shared"], x, kind=mlp_kind)
    if "dense" in p:
        out = out + ffn_apply(p["dense"], x, kind=mlp_kind)
    return out, aux
