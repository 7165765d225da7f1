"""Per-architecture transformer blocks (one layer slot): init, training,
prefill and decode. Counterpart of ``repro.models.transformer.blocks``.

A block takes its slot's ``ex`` — ``{"active": float, "window": int}``, plain
Python numbers — and its slice of the stacked params. A padding slot
(``active == 0``) is the identity: it returns its input and leaves its cache
as it was. Unlike the JAX blocks, which return new caches, the port writes
a layer's cache entries in place into the cache view it is given (a slice
of the model's stacked cache) and returns that view: a 7B model's cache is
gigabytes, and decoding copies none of it.

Attention is GQA with rope or m-rope, or MLA (deepseek-v3: low-rank q and
kv, rope on a 64-wide part with one key rope shared by the heads, and a
compressed ``ckv`` cache that decode expands through ``w_uk``/``w_uv``);
the FFN is dense or MoE (``moe.moe_apply``, routed over the tokens of one
call: one (stage, micro-batch)).

The ``*_all`` forms run a block for every data replica this process holds
(``core.data_group.DataGroup``: all of them in one process, its own on a
rank): params, activations and caches are lists, one per replica. A block
without a collective is the one-replica block per replica; with a
``DataAxis`` MoE reaches over the data axis (``moe_apply``'s expert-
parallel modes), and under ``seq_shard`` the decode attends over a cache
whose sequence is split over it (the reference's ``seq_axis``): each
replica holds ``w_local`` of the ring's ``w_total`` slots, replica r slots
``r·w_local ..``, the owner of slot ``cur_pos mod w_total`` writes it, and
every replica holds the same tokens, so the layers without a collective
give every replica the same rows.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.data_group import DataGroup
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.models.transformer.attention import decode_attention
from repro_torch.models.transformer.common import apply_mrope, apply_rope, normal_init, rms_norm
from repro_torch.models.transformer.ffn import ffn_apply, ffn_init
from repro_torch.models.transformer.moe import moe_apply, moe_init
from repro_torch.models.transformer.ssm import mamba2_apply, mamba2_init


# ------------------------------------------------------------------ init --


def init_attn_params(cfg: ArchConfig, gen: torch.Generator, *, lead=(), dtype=torch.float32) -> dict:
    """GQA projections (and QKV biases), or MLA's low-rank projections and
    norms, each with leading dims ``lead``."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)
    if cfg.attn_kind == "mla":
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        r = cfg.kv_lora_rank
        zeros = lambda n: torch.zeros((*lead, n), dtype=dtype, device=gen.device)
        return {
            "w_dq": normal_init(gen, (*lead, d, cfg.q_lora_rank), dtype=dtype),
            "ln_q": zeros(cfg.q_lora_rank),
            "w_uq": normal_init(gen, (*lead, cfg.q_lora_rank, h * qk), dtype=dtype),
            "w_dkv": normal_init(gen, (*lead, d, r + cfg.qk_rope_head_dim), dtype=dtype),
            "ln_kv": zeros(r),
            "w_uk": normal_init(gen, (*lead, r, h * cfg.qk_nope_head_dim), dtype=dtype),
            "w_uv": normal_init(gen, (*lead, r, h * cfg.v_head_dim), dtype=dtype),
            "w_o": normal_init(gen, (*lead, h * cfg.v_head_dim, d), dtype=dtype),
        }
    p = {
        "w_q": normal_init(gen, (*lead, d, h * hd), dtype=dtype),
        "w_k": normal_init(gen, (*lead, d, kv * hd), dtype=dtype),
        "w_v": normal_init(gen, (*lead, d, kv * hd), dtype=dtype),
        "w_o": normal_init(gen, (*lead, h * hd, d), dtype=dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("b_q", h * hd), ("b_k", kv * hd), ("b_v", kv * hd)):
            p[name] = torch.zeros((*lead, width), dtype=dtype, device=gen.device)
    return p


def init_block(cfg: ArchConfig, gen: torch.Generator, *, lead=(), dtype=torch.float32) -> dict:
    """One attention + FFN (or MoE) layer slot (stacked over ``lead``)."""
    d = cfg.d_model
    zeros = lambda: torch.zeros((*lead, d), dtype=dtype, device=gen.device)
    p = {"ln1": zeros(), "ln2": zeros(), "attn": init_attn_params(cfg, gen, lead=lead, dtype=dtype)}
    if cfg.sandwich_norms:
        p["ln1_post"], p["ln2_post"] = zeros(), zeros()
    if cfg.num_experts:
        p["moe"] = moe_init(
            gen, d, cfg.d_ff, num_experts=cfg.num_experts, num_shared=cfg.num_shared_experts,
            dense_residual=cfg.moe_dense_residual, router_kind=cfg.router_kind,
            mlp_kind=cfg.mlp_kind, lead=lead, dtype=dtype,
        )
    else:
        p["ffn"] = ffn_init(gen, d, cfg.d_ff, kind=cfg.mlp_kind, lead=lead, dtype=dtype)
    return p


def init_mamba_block(cfg: ArchConfig, gen: torch.Generator, *, lead=(), dtype=torch.float32) -> dict:
    return {
        "ln1": torch.zeros((*lead, cfg.d_model), dtype=dtype, device=gen.device),
        "mamba": mamba2_init(
            gen, cfg.d_model, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
            n_state=cfg.ssm_state, conv_width=cfg.ssm_conv_width, lead=lead, dtype=dtype,
        ),
    }


# ------------------------------------------------------------ attention --


def _project_qkv(cfg: ArchConfig, p: dict, h_in: torch.Tensor, positions: torch.Tensor):
    """-> (q (B,S,H,hd), k (B,S,KV,hd), v (B,S,KV,hd_v), cache entry), k
    post-rope. ``positions``: (S,), or (3, S) for m-rope. The entry is what
    prefill persists: {'k','v'} for GQA; for MLA the compressed {'ckv'}
    (B, S, kv_lora + rope) = normed ckv ‖ k_rope, where q and k have head
    dim nope + rope and v ``v_head_dim``, and every head shares k_rope."""
    b, s, _ = h_in.shape
    if cfg.attn_kind == "mla":
        h, nope, rope, r = (cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                            cfg.kv_lora_rank)
        cq = rms_norm(h_in @ p["w_dq"], p["ln_q"], eps=cfg.norm_eps)
        q_nope, q_rope = (cq @ p["w_uq"]).reshape(b, s, h, nope + rope).split([nope, rope], -1)
        q_rope = apply_rope(q_rope, positions, theta=cfg.rope_theta)
        ckv, k_rope = (h_in @ p["w_dkv"]).split([r, rope], -1)
        ckv = rms_norm(ckv, p["ln_kv"], eps=cfg.norm_eps)
        k_rope = apply_rope(k_rope[:, :, None, :], positions, theta=cfg.rope_theta)
        k_nope = (ckv @ p["w_uk"]).reshape(b, s, h, nope)
        v = (ckv @ p["w_uv"]).reshape(b, s, h, cfg.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, rope)], dim=-1)
        return q, k, v, {"ckv": torch.cat([ckv, k_rope[:, :, 0]], dim=-1)}
    hd = cfg.head_dim
    q, k, v = h_in @ p["w_q"], h_in @ p["w_k"], h_in @ p["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.rope_kind == "mrope":
        q = apply_mrope(q, positions, theta=cfg.rope_theta)
        k = apply_mrope(k, positions, theta=cfg.rope_theta)
    elif cfg.rope_kind == "rope":
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v, {"k": k, "v": v}


def attn_apply(cfg: ArchConfig, p: dict, h_in: torch.Tensor, *, positions: torch.Tensor,
               window: int, kv_block: int = 512, return_cache: bool = False):
    """Full-sequence causal attention through the flash op: the hand-written
    kernel on the card, ``blocked_attention`` (KV blocks of ``kv_block``) on
    the CPU. ``positions`` (int32, from ``model.make_positions``) rotate q
    and k. m-rope archs mask by their t-row ``positions[0]``, so a frontend
    prefix (all t = 0) sees itself both ways, as the reference masks; the
    model checks its order where it builds it, so the kernel reads nothing.
    The other archs' positions are ``arange(S)``, which the kernel's index
    path masks by without reading them."""
    b, s, _ = h_in.shape
    q, k, v, entry = _project_qkv(cfg, p, h_in, positions)
    lin = positions[0] if cfg.rope_kind == "mrope" else None
    out = flash_attention(q, k, v, window, cfg.attn_softcap, kv_block, q_pos=lin, kv_pos=lin,
                          ordered=True)
    out = out.reshape(b, s, -1) @ p["w_o"]
    return (out, entry) if return_cache else out


def ring_positions(cur_pos: int, w_local: int, *, device=None, offset: int = 0,
                   w_total: int | None = None) -> torch.Tensor:
    """Global positions held by ring-buffer slots, derived (not stored):
    slot i holds p_i = cur_pos - ((cur_pos - i) mod W); p_i < 0 ⇒ empty.
    Valid because serving fills positions contiguously 0..cur_pos. A
    replica of a sequence-split cache holds slots ``offset ..
    offset + w_local`` of a ring of ``w_total``."""
    w_total = w_total or w_local
    idx = torch.arange(w_local, dtype=torch.int64, device=device) + offset
    return cur_pos - torch.remainder(cur_pos - idx, w_total)


def _decode_entry(cfg: ArchConfig, p: dict, h_in: torch.Tensor, cur_pos: int):
    """The new token's (q (B, H, hd), k, v, cache entry) at ``cur_pos``."""
    shape = (3, 1) if cfg.rope_kind == "mrope" else (1,)
    pos = torch.full(shape, cur_pos, dtype=torch.int32, device=h_in.device)
    q, k_new, v_new, entry = _project_qkv(cfg, p, h_in, pos)
    return q[:, 0], k_new, v_new, entry


def _write_slot(cfg: ArchConfig, cache: dict, slot: int, k_new, v_new, entry) -> None:
    if cfg.attn_kind == "mla":
        cache["ckv"][:, slot] = entry["ckv"][:, 0]
    else:
        cache["k"][:, slot] = k_new[:, 0]
        cache["v"][:, slot] = v_new[:, 0]


def _cache_kv(cfg: ArchConfig, p: dict, cache: dict):
    """(k (B, W, H|KV, hd), v) over the cache's slots: GQA's own, or MLA's
    compressed cache expanded through ``w_uk``/``w_uv``."""
    if cfg.attn_kind != "mla":
        return cache["k"], cache["v"]
    b, w = cache["ckv"].shape[:2]
    h, nope, rope = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    ckv_all, kr_all = cache["ckv"].split([cfg.kv_lora_rank, rope], -1)
    k_nope = (ckv_all @ p["w_uk"]).reshape(b, w, h, nope)
    v_all = (ckv_all @ p["w_uv"]).reshape(b, w, h, cfg.v_head_dim)
    return torch.cat([k_nope, kr_all[:, :, None, :].expand(b, w, h, rope)], dim=-1), v_all


def attn_decode_apply(cfg: ArchConfig, p: dict, h_in: torch.Tensor, cache: dict, *,
                      cur_pos: int, window: int):
    """One new token (h_in (B, 1, d)) against a ring-buffer cache
    ({'k','v'} of (B, W, KV, hd), or MLA's {'ckv'} of (B, W, kv_lora +
    rope)); writes its entry into slot cur_pos mod W in place. MLA then
    expands the whole compressed cache through ``w_uk``/``w_uv`` (the
    reference's recompute form). -> (out (B, 1, d), cache). m-rope rotates the token by
    ``cur_pos`` on all three axes, as the reference's decode does
    (``repro.models.transformer.blocks.attn_decode_apply``), not by the t
    its prefill would give it (``cur_pos - s_front + 1``): the reference's
    decode and its own prefill disagree there, and the port copies it.
    ``attn_decode_all`` over a group of one."""
    return attn_decode_all(cfg, [p], [h_in], [cache], cur_pos=cur_pos, window=window,
                           group=DataGroup(1))[0], cache


def attn_decode_all(cfg: ArchConfig, ps: list, hs: list, caches: list, *, cur_pos: int,
                    window: int, group: DataGroup) -> list:
    """``attn_decode_apply`` over a cache whose ring is split over the
    replicas of ``group``: one (p, h_in, cache) per local replica, each
    cache holding its replica's ``w_local`` slots of ``w_total = w_local ·
    group.size``, replica r slots ``r·w_local ..``. Only the owner of slot
    ``cur_pos mod w_total`` writes it; the attention's softmax is taken over
    the group (``decode_attention(axis=group)``). -> [out (B, 1, d)]."""
    w_local = (caches[0]["ckv"] if cfg.attn_kind == "mla" else caches[0]["k"]).shape[1]
    w_total = w_local * group.size
    slot = cur_pos % w_total
    qs, ks, vs, poss = [], [], [], []
    for p, h_in, cache, r in zip(ps, hs, caches, group.local):
        q, k_new, v_new, entry = _decode_entry(cfg, p, h_in, cur_pos)
        if slot // w_local == r:
            _write_slot(cfg, cache, slot - r * w_local, k_new, v_new, entry)
        k_all, v_all = _cache_kv(cfg, p, cache)
        qs.append(q)
        ks.append(k_all)
        vs.append(v_all)
        poss.append(ring_positions(cur_pos, w_local, device=h_in.device, offset=r * w_local,
                                   w_total=w_total))
    outs = decode_attention(qs, ks, vs, poss, cur_pos, window=window,
                            attn_softcap=cfg.attn_softcap, axis=group)
    return [out.reshape(h.shape[0], 1, -1) @ p["w_o"] for out, h, p in zip(outs, hs, ps)]


def init_attn_cache(cfg: ArchConfig, mb: int, w_local: int, *, dtype=torch.float32,
                    device=None) -> dict:
    """One layer's decode cache: {'k','v'}, or MLA's compressed {'ckv'}.
    Positions are implicit (ring_positions)."""
    if cfg.attn_kind == "mla":
        width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        return {"ckv": torch.zeros((mb, w_local, width), dtype=dtype, device=device)}
    shape = (mb, w_local, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------- blocks --


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """How a block reaches over the data axis: the replicas' ``group``,
    MoE's mode there (``moe.MOE_MODES``), and whether the decode cache's
    sequence is split over it."""

    group: DataGroup
    moe_mode: str = "gathered"
    seq_shard: bool = False
    same_rows: bool = False  # every replica holds the same rows (a batch of one)


def _pre_ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor, a: torch.Tensor):
    """(h + the attention output, the FFN's normed input)."""
    if cfg.sandwich_norms:
        a = rms_norm(a, lp["ln1_post"], eps=cfg.norm_eps)
    h = h + a
    return h, rms_norm(h, lp["ln2"], eps=cfg.norm_eps)


def _post_ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    if cfg.sandwich_norms:
        f = rms_norm(f, lp["ln2_post"], eps=cfg.norm_eps)
    return h + f


def _moe_kw(cfg: ArchConfig) -> dict:
    return dict(num_experts=cfg.num_experts, k=cfg.experts_per_token,
                router_kind=cfg.router_kind, mlp_kind=cfg.mlp_kind)


def _ffn_tail(cfg: ArchConfig, lp: dict, h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Residual attention output, then the residual FFN or MoE (sandwich
    norms on gemma2). The MoE routes the B·S tokens of ``h`` (one
    micro-batch) in one call; its aux loss is discarded, as the
    reference's blocks discard it."""
    h, x = _pre_ffn(cfg, lp, h, a)
    if cfg.num_experts:
        b, s, d = x.shape
        f, _aux = moe_apply(lp["moe"], x.reshape(b * s, d), **_moe_kw(cfg))
        f = f.reshape(b, s, d)
    else:
        f = ffn_apply(lp["ffn"], x, kind=cfg.mlp_kind)
    return _post_ffn(cfg, lp, h, f)


def _ffn_tails(cfg: ArchConfig, lps: list, hs: list, as_: list, data) -> list:
    """``_ffn_tail`` for every local replica; MoE over ``data``'s group."""
    if data is None or not cfg.num_experts:
        return [_ffn_tail(cfg, lp, h, a) for lp, h, a in zip(lps, hs, as_)]
    pre = [_pre_ffn(cfg, lp, h, a) for lp, h, a in zip(lps, hs, as_)]
    b, s, d = pre[0][1].shape
    fs, _aux = moe_apply([lp["moe"] for lp in lps], [x.reshape(b * s, d) for _, x in pre],
                         ep_axis=data.group, mode=data.moe_mode, **_moe_kw(cfg))
    return [_post_ffn(cfg, lp, h, f.reshape(b, s, d)) for lp, (h, _), f in zip(lps, pre, fs)]


def block_train(cfg: ArchConfig, lp: dict, ex: dict, h: torch.Tensor, *,
                positions: torch.Tensor, kv_block: int = 512) -> torch.Tensor:
    """One attention(+FFN) layer over the full sequence (training): the
    forward of ``block_prefill`` without the cache. A padding slot is the
    identity, so its params get no gradient from it."""
    return block_train_all(cfg, [lp], ex, [h], positions=positions, kv_block=kv_block)[0]


def block_prefill(cfg: ArchConfig, lp: dict, ex: dict, h: torch.Tensor, cache: dict, *,
                  positions: torch.Tensor, kv_block: int = 512):
    """Full-sequence forward that also writes this layer's KV entries into
    ``cache`` (width == seq_len). -> (h, cache)."""
    return block_prefill_all(cfg, [lp], ex, [h], [cache], positions=positions,
                             kv_block=kv_block)[0], cache


def block_decode(cfg: ArchConfig, lp: dict, ex: dict, h: torch.Tensor, cache: dict, *,
                 cur_pos: int):
    """One-token forward against this layer's cache (updated in place)."""
    return block_decode_all(cfg, [lp], ex, [h], [cache], cur_pos=cur_pos)[0], cache


def _attn_all(cfg, lps, ex, hs, positions, kv_block, return_cache=False):
    return [attn_apply(cfg, lp["attn"], rms_norm(h, lp["ln1"], eps=cfg.norm_eps),
                       positions=positions, window=int(ex["window"]), kv_block=kv_block,
                       return_cache=return_cache) for lp, h in zip(lps, hs)]


def block_train_all(cfg: ArchConfig, lps: list, ex: dict, hs: list, *, positions,
                    kv_block: int = 512, data: DataAxis | None = None) -> list:
    """``block_train`` for every local replica (MoE over ``data``)."""
    if not ex["active"] > 0:
        return hs
    as_ = _attn_all(cfg, lps, ex, hs, positions, kv_block)
    return _ffn_tails(cfg, lps, hs, as_, data)


def block_prefill_all(cfg: ArchConfig, lps: list, ex: dict, hs: list, caches: list, *,
                      positions, kv_block: int = 512, data: DataAxis | None = None) -> list:
    """``block_prefill`` for every local replica, each writing its cache."""
    if not ex["active"] > 0:
        return hs
    as_ = []
    for (a, entry), cache in zip(_attn_all(cfg, lps, ex, hs, positions, kv_block, True), caches):
        for name, value in entry.items():
            cache[name].copy_(value)
        as_.append(a)
    return _ffn_tails(cfg, lps, hs, as_, data)


def block_decode_all(cfg: ArchConfig, lps: list, ex: dict, hs: list, caches: list, *,
                     cur_pos: int, data: DataAxis | None = None) -> list:
    """``block_decode`` for every local replica; under ``data.seq_shard``
    the attention runs over the sequence-split cache."""
    if not ex["active"] > 0:
        return hs
    normed = [rms_norm(h, lp["ln1"], eps=cfg.norm_eps) for lp, h in zip(lps, hs)]
    if data is not None and data.seq_shard:
        as_ = attn_decode_all(cfg, [lp["attn"] for lp in lps], normed, caches,
                              cur_pos=cur_pos, window=int(ex["window"]), group=data.group)
    else:
        as_ = [attn_decode_apply(cfg, lp["attn"], x, cache, cur_pos=cur_pos,
                                 window=int(ex["window"]))[0]
               for lp, x, cache in zip(lps, normed, caches)]
    return _ffn_tails(cfg, lps, hs, as_, data)


def _mamba(cfg: ArchConfig, lp: dict, h: torch.Tensor, **kw):
    return mamba2_apply(
        lp["mamba"], rms_norm(h, lp["ln1"], eps=cfg.norm_eps), expand=cfg.ssm_expand,
        head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state, chunk=cfg.ssm_chunk, **kw,
    )


def mamba_block_train(cfg: ArchConfig, lp: dict, ex: dict, h: torch.Tensor) -> torch.Tensor:
    """Full-sequence mamba forward from a zero state (training); a padding
    slot is the identity."""
    if not ex["active"] > 0:
        return h
    y, _ = _mamba(cfg, lp, h)
    return h + y


def mamba_block_prefill(cfg: ArchConfig, lp: dict, ex: dict, h: torch.Tensor, cache: dict):
    """Full-sequence mamba forward from a zero state; writes the final
    recurrent and conv states into ``cache`` ({'ssm','conv'})."""
    if not ex["active"] > 0:
        return h, cache
    y, (ssm, conv) = _mamba(cfg, lp, h)
    cache["ssm"].copy_(ssm)
    cache["conv"].copy_(conv)
    return h + y, cache


def mamba_block_decode(cfg: ArchConfig, lp: dict, ex: dict, h: torch.Tensor, cache: dict):
    """One-token mamba step from ``cache`` (updated in place)."""
    if not ex["active"] > 0:
        return h, cache
    y, (ssm, conv) = _mamba(cfg, lp, h, ssm_state=cache["ssm"], conv_state=cache["conv"],
                            decode=True)
    cache["ssm"].copy_(ssm)
    cache["conv"].copy_(conv)
    return h + y, cache


def init_mamba_cache(cfg: ArchConfig, mb: int, *, dtype=torch.float32, device=None) -> dict:
    d_in = cfg.ssm_expand * cfg.d_model
    h = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    return {
        "ssm": torch.zeros((mb, h, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((mb, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }
