"""Mixture-of-Experts with expert parallelism over the data axis; one
device is a group of one. Counterpart of ``repro.models.transformer.moe``.

Routing is sort-based capacity dispatch, as the reference's:

  token→expert assignments are sorted by expert id (stably), each expert
  keeps its first ``capacity`` tokens, an (E, capacity) gather table
  dispatches, and the weighted expert outputs are combined per token.

The reference combines with a scatter-add over the token table. The port
keeps the inverse map instead — each (token, j) pair's slot, or a zero row
when the pair was dropped or went to another replica's expert — and sums
each token's k contributions from it: a gather, so the forward has no
atomics and is deterministic on any device. Autograd makes the gathers'
backward (the combine's and the dispatch ``x[tok_table]``'s) accumulating
index-puts, which run deterministically under
``torch.use_deterministic_algorithms(True)``.

Expert parallelism (``ep_axis``, a ``core.data_group.DataGroup``; without
one, ``DataGroup(1)``, which holds every expert): the expert leaves are
each replica's own ``E / size`` experts, replica r's from ``e0 = r ·
E_local``, and ``x`` and ``p`` are lists, one per replica this process
runs. The reference's three modes (one device runs ``gathered``, whose
collectives over a group of one are copies):

* ``gathered``: tokens, top-k indices and weights are all-gathered over the
  group, capacity is taken over the gathered tokens, each replica runs its
  experts on them, and a reduce-scatter returns each its own tokens'
  outputs;
* ``a2a``: each replica packs per-destination buffers of its own tokens
  (capacity over its own tokens), two all-to-alls carry them to the
  experts and back;
* ``replicated``: every replica holds the same tokens (the
  sequence-sharded decode); each runs its experts and the outputs are
  summed over the group.

Supports softmax top-k, sigmoid+bias selection (deepseek-v3: the bias picks
the experts, the unbiased scores weight them), shared experts and arctic's
parallel dense residual.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.data_group import DataGroup, fanout
from repro_torch.models.transformer.common import normal_init
from repro_torch.models.transformer.ffn import ffn_apply, ffn_init

MOE_MODES = ("gathered", "a2a", "replicated")


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


def _dispatch_tables(idx: torch.Tensor, w: torch.Tensor, *, num_experts: int, capacity: int,
                     e0: int = 0, e_local: int | None = None):
    """Sort-based dispatch -> (token_table (E_local, C) int64, weight_table
    (E_local, C) float32, inverse (T, k) int64) for experts ``e0 ..
    e0 + E_local`` (default: all ``num_experts``). Empty slots point at
    token 0 with weight 0; ``inverse[t, j]`` is the flat slot (e - e0)·C +
    pos of token t's j-th choice, or E_local·C where it was dropped (pos >=
    capacity) or went to an expert outside the range."""
    e_local = num_experts if e_local is None else e_local
    t, k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    st = torch.div(order, k, rounding_mode="floor")  # the token of each sorted pair
    sw = w.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(num_experts, device=dev, dtype=se.dtype))
    pos = torch.arange(t * k, device=dev) - starts[se]
    n = e_local * capacity
    mine = (pos < capacity) & (se >= e0) & (se < e0 + e_local)
    slot = torch.where(mine, (se - e0) * capacity + pos, n)
    # slot n collects the dropped pairs and is cut off
    tok_table = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_put_((slot,), st)
    w_table = torch.zeros(n + 1, dtype=w.dtype, device=dev).index_put((slot,), sw)
    inverse = torch.empty_like(slot).index_put_((order,), slot)
    return (tok_table[:-1].view(e_local, capacity), w_table[:-1].view(e_local, capacity),
            inverse.view(t, k))


def _combine(yout: torch.Tensor, w_table: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """(T, d) float32: each token's k weighted expert outputs, summed, from
    ``yout`` (E, C, d) through the inverse map (zero rows where dropped)."""
    d = yout.shape[-1]
    contrib = (yout * w_table[..., None]).float().reshape(-1, d)
    contrib = torch.cat([contrib, contrib.new_zeros((1, d))])  # the dropped pairs' row
    return contrib[inverse].sum(dim=1)


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


def moe_apply(p, x, *, num_experts: int, k: int, router_kind: str = "softmax",
              mlp_kind: str = "swiglu", capacity_factor: float = 1.25, ep_axis=None,
              mode: str = "gathered"):
    """x (T, d), the tokens of one call -> (out (T, d), aux_loss). Capacity
    (``expert_capacity``) is over this call's tokens (the gathered tokens
    under ``gathered``), so which tokens are dropped depends on the call:
    the model routes once per (stage, micro-batch), as the reference's
    pipeline does. ``ep_axis`` is a ``DataGroup`` (default: a group of one,
    every expert local); ``p`` and ``x`` may be lists over its local
    replicas, and the result is then lists too."""
    kw = dict(num_experts=num_experts, k=k, router_kind=router_kind, mlp_kind=mlp_kind,
              capacity_factor=capacity_factor)
    ep_axis = DataGroup(1) if ep_axis is None else ep_axis
    if mode not in MOE_MODES:
        raise ValueError(f"moe mode must be one of {MOE_MODES}, got {mode!r}")
    if num_experts % ep_axis.size:
        raise ValueError(f"{num_experts} experts do not split over a data axis of "
                         f"{ep_axis.size}")
    single = not isinstance(x, (list, tuple))
    outs, auxs = _moe_group([p] if single else list(p), [x] if single else list(x),
                            group=ep_axis, mode=mode, **kw)
    return (outs[0], auxs[0]) if single else (outs, auxs)


def _moe_group(ps: list, xs: list, *, group, mode, num_experts, k, router_kind, mlp_kind,
               capacity_factor):
    """``moe_apply`` over a data group: one (p, x) per local replica."""
    ep = group.size
    e_local = num_experts // ep
    # x feeds the router, the dispatch and the shared/dense FFNs; its
    # gradients are summed in that order (``fanout``)
    uses = 2 + ("shared" in ps[0]) + ("dense" in ps[0])
    copies = [fanout(x, uses) for x in xs]
    routed = [_route(p, c[0], k=k, router_kind=router_kind) for p, c in zip(ps, copies)]
    toks = [c[1] for c in copies]
    t, d = xs[0].shape
    if mode == "a2a":
        capacity = expert_capacity(t, k, num_experts, capacity_factor)
        tables = [_dispatch_tables(idx, w, num_experts=num_experts, capacity=capacity)
                  for idx, w, _ in routed]
        sends = [x[tt].view(ep, e_local, capacity, d) for x, (tt, _, _) in zip(toks, tables)]
        recv = group.exchange(sends)  # (source, E_local, C, d)
        yout = [_expert_ffn_by_source(p, r, mlp_kind=mlp_kind) for p, r in zip(ps, recv)]
        back = group.exchange(yout)  # (expert's replica, E_local, C, d): this replica's tokens
        outs = [_combine(b.reshape(num_experts, capacity, d), wt, inv)
                for b, (_, wt, inv) in zip(back, tables)]
    else:
        if mode == "gathered":
            xg = group.gather(toks)
            idxg = group.concat([idx for idx, _, _ in routed])
            wg = group.gather([w for _, w, _ in routed])
        else:  # replicated: every replica already holds every token
            xg, idxg, wg = toks, [idx for idx, _, _ in routed], [w for _, w, _ in routed]
        capacity = expert_capacity(xg[0].shape[0], k, num_experts, capacity_factor)
        outs = []
        for p, x, idx, w, r in zip(ps, xg, idxg, wg, group.local):
            tt, wt, inv = _dispatch_tables(idx, w, num_experts=num_experts, capacity=capacity,
                                           e0=r * e_local, e_local=e_local)
            outs.append(_combine(_expert_ffn(p, x[tt], mlp_kind=mlp_kind), wt, inv))
        outs = group.scatter_sum(outs) if mode == "gathered" else group.sum(outs)
    result = []
    for p, c, out in zip(ps, copies, outs):
        out = out.to(c[0].dtype)
        rest = list(c[2:])
        if "shared" in p:
            out = out + ffn_apply(p["shared"], rest.pop(0), kind=mlp_kind)
        if "dense" in p:
            out = out + ffn_apply(p["dense"], rest.pop(0), kind=mlp_kind)
        result.append(out)
    return result, [aux for _, _, aux in routed]


def _expert_ffn_by_source(p: dict, recv: torch.Tensor, *, mlp_kind: str) -> torch.Tensor:
    """recv (sources, E_local, C, d) -> the same shape: every source's
    buffers through the local experts at once."""
    ep, e_local, c, d = recv.shape
    xin = recv.transpose(0, 1).reshape(e_local, ep * c, d)
    y = _expert_ffn(p, xin, mlp_kind=mlp_kind)
    return y.reshape(e_local, ep, c, d).transpose(0, 1)
