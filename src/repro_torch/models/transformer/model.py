"""Full LM assembly for serving: embed → pipelined block stack → head.
Counterpart of the serving half of ``repro.models.transformer.model``.

The JAX model runs its stages on a mesh (``shard_map`` over the "model"
axis, GPipe ticks inside ``spmd_pipeline``). The port serves from one card:
``make_prefill_step`` and ``make_serve_step`` return steps that walk
stages × micro-batches on the host in fill-drain order (tick t runs stage s
on micro-batch t - s), every stage on the same device. Parameters and
caches keep the JAX layout, so the two compare leaf by leaf:

* params: ``embed`` (V, d), ``final_ln`` (d,), ``head`` (d, V) unless tied,
  and ``blocks``, each leaf stacked (num_stages, layers_per_stage, ...);
* caches: each leaf (num_stages, num_micro, slots, b_mb, ...) — attention
  ``k``/``v`` (…, W, KV, hd), Mamba ``ssm`` (…, h, P, N) float32 and
  ``conv`` (…, width-1, conv_dim).

Per-slot extras (``active``, ``window``) are numpy arrays read as Python
numbers: a padding slot (``active == 0``) is skipped, so it is the identity
and leaves its cache as it was. The steps update the cache in place and
return it.

Only dense GQA archs with rope and ``ssm`` archs build in this slice;
``check_supported`` raises for the rest, naming ROADMAP queue 1 item 16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, pipeline_padding
from repro_torch.models.transformer import blocks as B
from repro_torch.models.transformer.common import normal_init, rms_norm, softcap

ROADMAP_ITEM = "ROADMAP queue 1 item 16"


@dataclasses.dataclass(frozen=True)
class Topology:
    """Pipeline shape of a serving step: stages walked on one device,
    GPipe micro-batches per step, and the plain attention's KV block (the
    CPU route of the flash op)."""

    num_stages: int = 1
    num_micro: int = 1
    kv_block: int = 512


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for an arch whose blocks this slice has
    not ported (MoE, MLA, hybrid stacks, m-rope, modality frontends)."""
    missing = []
    if cfg.arch_type not in ("dense", "ssm"):
        missing.append(f"arch_type {cfg.arch_type!r}")
    if cfg.num_experts:
        missing.append("MoE blocks")
    if cfg.arch_type != "ssm" and cfg.attn_kind != "gqa":
        missing.append(f"{cfg.attn_kind} attention")
    if cfg.rope_kind not in ("rope", "none"):
        missing.append(f"{cfg.rope_kind} positions")
    if cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} frontend")
    if cfg.mtp:
        missing.append("the multi-token-prediction head")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch yet ({ROADMAP_ITEM})"
        )


# ------------------------------------------------------------- stacking --


def stacked_shape_plan(cfg: ArchConfig, num_stages: int) -> dict:
    if cfg.arch_type == "hybrid":
        every = cfg.hybrid_attn_every
        per, _ = pipeline_padding(cfg.num_layers, num_stages)
        per = math.ceil(per / every) * every
        return {"per_stage": per, "mamba_per_stage": per - per // every,
                "attn_per_stage": per // every}
    per, pad = pipeline_padding(cfg.num_layers, num_stages)
    return {"per_stage": per, "pad": pad}


def init_params(cfg: ArchConfig, *, seed: int = 0, num_stages: int = 1,
                dtype=torch.float32, device="cpu") -> dict:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (the JAX package's init scheme: normal(0.02) matrices,
    zero norms and biases, the Mamba constants; not its bits — tests that
    compare with JAX convert its params instead)."""
    check_supported(cfg)
    plan = stacked_shape_plan(cfg, num_stages)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {
        "embed": normal_init(gen, (cfg.vocab_size, cfg.d_model), dtype=dtype),
        "final_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal_init(gen, (cfg.d_model, cfg.vocab_size), dtype=dtype)
    lead = (num_stages, plan["per_stage"])
    init = B.init_mamba_block if cfg.arch_type == "ssm" else B.init_block
    params["blocks"] = init(cfg, gen, lead=lead, dtype=dtype)
    return params


def make_extras(cfg: ArchConfig, num_stages: int) -> dict:
    """Per-layer-slot metadata, (num_stages, slots) numpy arrays: ``active``
    (0 on pipeline padding) and ``window`` (0 = global)."""
    per = stacked_shape_plan(cfg, num_stages)["per_stage"]
    total = num_stages * per
    wins = cfg.layer_windows()
    active = (np.arange(total) < cfg.num_layers).astype(np.float32).reshape(num_stages, per)
    window = np.asarray(wins + [0] * (total - len(wins)), np.int32).reshape(num_stages, per)
    return {"active": active, "window": window}


def _slot(tree: dict, *index) -> dict:
    """The sub-tree of one stacked slot: every leaf indexed by ``index``."""
    return {k: _slot(v, *index) if isinstance(v, dict) else v[index] for k, v in tree.items()}


# ------------------------------------------------------------ embeddings --


def embed_inputs(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    return params["embed"][batch["tokens"].long()]  # (B, S, d)


def make_positions(cfg: ArchConfig, seq: int, device=None) -> torch.Tensor:
    """(S,) rope positions."""
    return torch.arange(seq, dtype=torch.int64, device=device)


def lm_head_logits(cfg: ArchConfig, params: dict, y: torch.Tensor) -> torch.Tensor:
    y = rms_norm(y, params["final_ln"], eps=cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return softcap((y @ head).float(), cfg.logit_softcap)


# --------------------------------------------------------------- caches --


def cache_plan(cfg: ArchConfig, topo: Topology, shape: ShapeConfig) -> dict:
    """Static cache geometry: micro-batch rows and ring width (decode:
    seq_len + 16 slots; prefill: seq_len)."""
    b_mb = max(shape.global_batch // topo.num_micro, 1)
    w = shape.seq_len + 16 if shape.kind == "decode" else shape.seq_len
    return {"b_mb": b_mb, "w_total": w, "w_local": w, "nm": topo.num_micro}


def init_cache(cfg: ArchConfig, topo: Topology, shape: ShapeConfig, *,
               dtype=torch.float32, device="cpu") -> dict:
    """A zero cache: leaves (num_stages, num_micro, slots, b_mb, ...), the
    layout of ``abstract_cache``."""
    check_supported(cfg)
    plan = cache_plan(cfg, topo, shape)
    slots = stacked_shape_plan(cfg, topo.num_stages)["per_stage"]
    lead = (topo.num_stages, plan["nm"], slots)
    if cfg.arch_type == "ssm":
        one = B.init_mamba_cache(cfg, plan["b_mb"], dtype=dtype, device="meta")
    else:
        one = B.init_attn_cache(cfg, plan["b_mb"], plan["w_local"], dtype=dtype, device="meta")
    return {k: torch.zeros((*lead, *v.shape), dtype=v.dtype, device=device)
            for k, v in one.items()}


# ------------------------------------------------------------ step fns --


def _fill_drain(num_stages: int, num_micro: int, run: Callable[[int, int], None]) -> None:
    """Call ``run(stage, micro)`` in GPipe fill-drain order."""
    for t in range(num_micro + num_stages - 1):
        for s in range(num_stages):
            if 0 <= t - s < num_micro:
                run(s, t - s)


def _stack_runner(cfg: ArchConfig, topo: Topology, params: dict, cache: dict, acts: list,
                  block: Callable):
    """``run(stage, micro)``: the stage's layer slots over micro-batch
    ``micro``'s activation, each slot with its params and cache slice."""
    extras = make_extras(cfg, topo.num_stages)

    def run(s: int, m: int) -> None:
        h = acts[m]
        for i in range(extras["active"].shape[1]):
            ex = {"active": float(extras["active"][s, i]), "window": int(extras["window"][s, i])}
            h, _ = block(_slot(params["blocks"], s, i), ex, h, _slot(cache, s, m, i))
        acts[m] = h

    return run


def _micro_split(x: torch.Tensor, topo: Topology) -> list:
    if x.shape[0] % topo.num_micro:
        raise ValueError(f"batch {x.shape[0]} does not split into {topo.num_micro} micro-batches")
    return list(x.reshape(topo.num_micro, x.shape[0] // topo.num_micro, *x.shape[1:]))


def make_prefill_step(cfg: ArchConfig, topo: Topology, shape: ShapeConfig) -> Callable:
    """Full-sequence prefill: ``step(params, cache, {"tokens": (B, S)}) ->
    (last-token logits (B, V) float32, cache)``, the cache (from
    ``init_cache`` at ``shape``) filled in place."""
    check_supported(cfg)
    seq = shape.seq_len

    def prefill_step(params: dict, cache: dict, batch: dict):
        x = embed_inputs(cfg, params, batch)
        if x.shape[1] != seq:
            raise ValueError(f"prompt of {x.shape[1]} tokens, step built for {seq}")
        positions = make_positions(cfg, seq, device=x.device)
        if cfg.arch_type == "ssm":
            block = lambda lp, ex, h, c: B.mamba_block_prefill(cfg, lp, ex, h, c)
        else:
            block = lambda lp, ex, h, c: B.block_prefill(
                cfg, lp, ex, h, c, positions=positions, kv_block=topo.kv_block)
        acts = _micro_split(x, topo)
        _fill_drain(topo.num_stages, topo.num_micro,
                    _stack_runner(cfg, topo, params, cache, acts, block))
        y_last = torch.cat([a[:, -1] for a in acts])
        return lm_head_logits(cfg, params, y_last), cache

    return prefill_step


def make_serve_step(cfg: ArchConfig, topo: Topology, shape: ShapeConfig) -> Callable:
    """One decode step: ``step(params, cache, {"tokens": (B,), "pos": int})
    -> (next tokens (B,) int32, cache, logits (B, V) float32)``, the cache
    (from ``init_cache`` at ``shape``) updated in place at slot pos mod W."""
    check_supported(cfg)

    def serve_step(params: dict, cache: dict, batch: dict):
        x = params["embed"][batch["tokens"].long()][:, None, :]  # (B, 1, d)
        pos = int(batch["pos"])
        if cfg.arch_type == "ssm":
            block = lambda lp, ex, h, c: B.mamba_block_decode(cfg, lp, ex, h, c)
        else:
            block = lambda lp, ex, h, c: B.block_decode(cfg, lp, ex, h, c, cur_pos=pos)
        acts = _micro_split(x, topo)
        _fill_drain(topo.num_stages, topo.num_micro,
                    _stack_runner(cfg, topo, params, cache, acts, block))
        logits = lm_head_logits(cfg, params, torch.cat(acts)[:, 0])
        return logits.argmax(dim=-1).to(torch.int32), cache, logits

    return serve_step
