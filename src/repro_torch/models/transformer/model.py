"""Full LM assembly: embed → pipelined block stack → head. Counterpart of
``repro.models.transformer.model``: training, prefill and decode.

The JAX model runs its stages on a mesh (``shard_map`` over the "model"
axis, pipeline ticks inside ``spmd_pipeline``). The port runs on one card:
``make_train_step``, ``make_prefill_step`` and ``make_serve_step`` return
steps that walk stages × micro-batches on the host, every stage on the same
device — in fill-drain order (tick t runs stage s on micro-batch t - s), or
for training under ``schedule="interleaved"`` in the order of
``spmd_pipeline_interleaved`` (virtual stage v·D + d on ring position d).
Parameters and caches keep the JAX layout, so the two compare leaf by leaf:

* params: ``embed`` (V, d), ``final_ln`` (d,), ``head`` (d, V) unless tied,
  ``mtp_proj`` (d, d) on an arch with the multi-token-prediction head,
  ``blocks``, each leaf stacked (num_stages, layers_per_stage, ...), and for
  the zamba2 hybrid ``shared_attn``, one attention block outside the stack
  (``blocks`` then holds only the mamba slots);
* caches: each leaf (num_stages, num_micro, slots, b_mb, ...) — attention
  ``k``/``v`` (…, W, KV, hd) or MLA's compressed ``ckv`` (…, W, kv_lora +
  rope), Mamba ``ssm`` (…, h, P, N) float32 and ``conv`` (…, width-1,
  conv_dim); the hybrid's cache is ``{"mamba": …, "attn": …}``, one
  attention slot per group.

``abstract_params`` builds the parameter tree on the ``meta`` device
(shapes and dtypes, no data): the dry run's (``launch/dryrun.py``).

Per-slot extras (``active``, ``window``) are numpy arrays read as Python
numbers: a padding slot (``active == 0``) is skipped, so it is the identity,
leaves its cache as it was, and its parameters get zero gradients. The
serving steps update the cache in place and return it; the train step
updates the params and the Adam state in place and returns them.

Every arch of the JAX package builds: dense GQA archs with rope or m-rope,
the modality-frontend archs (musicgen-large, qwen2-vl-2b: precomputed
``frontend_embeds`` ahead of the tokens), ``ssm`` archs, the zamba2 hybrid,
and the MoE archs (arctic-480b; deepseek-v3-671b with MLA and the
multi-token-prediction head). ``check_supported`` raises for a config of a
kind the port does not know.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeConfig, pipeline_padding
from repro_torch.kernels import attach_values
from repro_torch.kernels.flash.kernel import check_order
from repro_torch.models.transformer import blocks as B
from repro_torch.models.transformer.common import normal_init, rms_norm, softcap
from repro_torch.train import optimizer as opt_lib

@dataclasses.dataclass(frozen=True)
class Topology:
    """Pipeline shape of a step on one device: stages walked on the host
    (virtual stages when interleaved), micro-batches per step, the plain
    attention's KV block (the CPU route of the flash op), and for training
    the schedule (``fill_drain`` or ``interleaved`` over ``num_stages /
    num_virtual`` ring positions), activation recomputation per (stage,
    micro-batch) and the loss's batch chunks. ``long_context`` is the
    one-card part of the reference's ``seq_shard_decode``: a decode whose
    layers all take ``layer_windows(long_context=True)``'s windows, over a
    ring as wide as the largest (``cache_plan``); nothing is sharded."""

    num_stages: int = 1
    num_micro: int = 1
    kv_block: int = 512
    schedule: str = "fill_drain"
    num_virtual: int = 1
    remat: bool = True
    loss_chunks: int = 8
    long_context: bool = False

    @property
    def pipe_devices(self) -> int:
        """Ring positions: num_stages for fill-drain, num_stages /
        num_virtual for the interleaved (circular) schedule."""
        if self.schedule != "interleaved":
            return self.num_stages
        if self.num_virtual < 1 or self.num_stages % self.num_virtual:
            raise ValueError(
                f"num_virtual ({self.num_virtual}) must divide num_stages ({self.num_stages})"
            )
        return self.num_stages // self.num_virtual


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a block kind the port does not build."""
    unknown = []
    if cfg.arch_type not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
        unknown.append(f"arch_type {cfg.arch_type!r}")
    if cfg.arch_type != "ssm" and cfg.attn_kind not in ("gqa", "mla"):
        unknown.append(f"{cfg.attn_kind} attention")
    if cfg.rope_kind not in ("rope", "mrope", "none"):
        unknown.append(f"{cfg.rope_kind} positions")
    if unknown:
        raise NotImplementedError(f"{cfg.name}: {', '.join(unknown)} not built by repro_torch")


# ------------------------------------------------------------- stacking --


def _hybrid_layout(cfg: ArchConfig, num_stages: int) -> tuple[int, int]:
    """(mamba_slots_per_stage, total_slots_per_stage): the attention slot is
    the last of each ``hybrid_attn_every`` group."""
    every = cfg.hybrid_attn_every
    per, _ = pipeline_padding(cfg.num_layers, num_stages)
    per = math.ceil(per / every) * every
    return per - per // every, per


def stacked_shape_plan(cfg: ArchConfig, num_stages: int) -> dict:
    if cfg.arch_type == "hybrid":
        m_per, per = _hybrid_layout(cfg, num_stages)
        return {"per_stage": per, "mamba_per_stage": m_per,
                "attn_per_stage": per // cfg.hybrid_attn_every}
    per, pad = pipeline_padding(cfg.num_layers, num_stages)
    return {"per_stage": per, "pad": pad}


def _stacked_slots(cfg: ArchConfig, num_stages: int) -> int:
    """Slots per stage of ``params["blocks"]`` (the mamba slots on a hybrid)."""
    plan = stacked_shape_plan(cfg, num_stages)
    return plan["mamba_per_stage"] if cfg.arch_type == "hybrid" else plan["per_stage"]


def init_params(cfg: ArchConfig, *, seed: int = 0, num_stages: int = 1,
                dtype=torch.float32, device="cpu") -> dict:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (the JAX package's init scheme: normal(0.02) matrices,
    zero norms and biases, the Mamba constants; not its bits — tests that
    compare with JAX convert its params instead)."""
    check_supported(cfg)
    return _build_params(cfg, torch.Generator(device=device).manual_seed(seed), num_stages, dtype)


class _NoDraws:
    """Stands for the generator on the meta device, where nothing is drawn
    (``common.normal_init`` returns empty leaves there)."""

    device = torch.device("meta")


def abstract_params(cfg: ArchConfig, num_stages: int = 1, dtype=torch.float32) -> dict:
    """``init_params``' tree on the meta device: its shapes and dtypes, no
    data and no draws. Counterpart of the reference's ``_abstract_params``
    (``jax.eval_shape`` of its init)."""
    check_supported(cfg)
    return _build_params(cfg, _NoDraws(), num_stages, dtype)


def _build_params(cfg: ArchConfig, gen, num_stages: int, dtype) -> dict:
    device = gen.device
    params = {
        "embed": normal_init(gen, (cfg.vocab_size, cfg.d_model), dtype=dtype),
        "final_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal_init(gen, (cfg.d_model, cfg.vocab_size), dtype=dtype)
    if cfg.mtp:
        params["mtp_proj"] = normal_init(gen, (cfg.d_model, cfg.d_model), dtype=dtype)
    lead = (num_stages, _stacked_slots(cfg, num_stages))
    if cfg.arch_type == "hybrid":
        params["shared_attn"] = B.init_block(cfg, gen, dtype=dtype)
    init = B.init_mamba_block if cfg.arch_type in ("ssm", "hybrid") else B.init_block
    params["blocks"] = init(cfg, gen, lead=lead, dtype=dtype)
    return params


def make_extras(cfg: ArchConfig, num_stages: int, *, long_context: bool = False) -> dict:
    """Per-layer-slot metadata, (num_stages, slots) numpy arrays: ``active``
    (0 on pipeline padding) and ``window`` (0 = global; with
    ``long_context``, every global layer takes ``cfg.long_context_window``);
    a hybrid's is ``{"mamba": {"active"}, "attn": {"active", "window"}}``."""
    plan = stacked_shape_plan(cfg, num_stages)
    per = plan["per_stage"]
    wins = cfg.layer_windows(long_context=long_context)
    if cfg.arch_type == "hybrid":
        every = cfg.hybrid_attn_every
        m_per, a_per = plan["mamba_per_stage"], plan["attn_per_stage"]
        active_m = np.zeros((num_stages, m_per), np.float32)
        active_a = np.zeros((num_stages, a_per), np.float32)
        win_a = np.zeros((num_stages, a_per), np.int32)
        for s in range(num_stages):
            mi = ai = 0
            for i in range(per):
                g = s * per + i
                if i % every == every - 1:
                    active_a[s, ai] = float(g < cfg.num_layers)
                    win_a[s, ai] = wins[min(g, cfg.num_layers - 1)]
                    ai += 1
                else:
                    active_m[s, mi] = float(g < cfg.num_layers)
                    mi += 1
        return {"mamba": {"active": active_m}, "attn": {"active": active_a, "window": win_a}}
    total = num_stages * per
    active = (np.arange(total) < cfg.num_layers).astype(np.float32).reshape(num_stages, per)
    window = np.asarray(wins + [0] * (total - len(wins)), np.int32).reshape(num_stages, per)
    return {"active": active, "window": window}


def _slot(tree: dict, *index) -> dict:
    """The sub-tree of one stacked slot: every leaf indexed by ``index``."""
    return opt_lib.tree_map(lambda v: v[index], tree)


def _slot_extras(ex: dict, *index) -> dict:
    """One slot's extras as Python numbers."""
    out = {"active": float(ex["active"][index])}
    if "window" in ex:
        out["window"] = int(ex["window"][index])
    return out


# ------------------------------------------------------------ embeddings --


def frontend_rows(cfg: ArchConfig, seq: int) -> int:
    """Rows of a ``seq``-long sequence that the modality frontend fills."""
    return int(seq * cfg.frontend_frac) if cfg.frontend != "none" else 0


def embed_inputs(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """(B, S, d): the token embeddings, after ``batch["frontend_embeds"]``
    (B, s_front, d) on a frontend arch."""
    x = params["embed"][batch["tokens"].long()]  # (B, S_text, d)
    if cfg.frontend != "none":
        x = torch.cat([batch["frontend_embeds"].to(x.dtype), x], dim=1)
    return x


def make_positions(cfg: ArchConfig, seq: int, device=None) -> torch.Tensor:
    """(S,) int32 rope positions, or (3, S) for m-rope: the frontend rows on
    a side x side grid at t = 0, then the text at t = h = w = 1, 2, ...
    Built from numpy, as the reference builds them. The t-row, the flash
    kernel's mask order (``blocks.attn_apply``), never decreases. On the meta
    device the values ride along (``kernels.attach_values``), so the flash
    kernel's cost counts the pairs they mask."""
    if cfg.rope_kind != "mrope":
        return torch.arange(seq, dtype=torch.int32, device=device)
    s_front = frontend_rows(cfg, seq)
    side = max(1, int(math.sqrt(max(s_front, 1))))
    idx = np.arange(seq)
    t = np.where(idx < s_front, 0, idx - s_front + 1)
    hh = np.where(idx < s_front, (idx // side) % side, idx - s_front + 1)
    ww = np.where(idx < s_front, idx % side, idx - s_front + 1)
    grid = np.stack([t, hh, ww]).astype(np.int32)
    out = torch.from_numpy(grid).to(device)
    return attach_values(out, grid) if out.is_meta else out


def lm_head_logits(cfg: ArchConfig, params: dict, y: torch.Tensor) -> torch.Tensor:
    y = rms_norm(y, params["final_ln"], eps=cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return softcap((y @ head).float(), cfg.logit_softcap)


# ------------------------------------------------------------ batches --


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """{name: (shape, dtype)} of one step's input batch: decode ``tokens``
    (B,) and ``pos``; prefill ``tokens`` (B, S - s_front); train ``tokens``
    (B, S - s_front + 1), the last column the labels' shift; on a frontend
    arch also ``frontend_embeds`` (B, s_front, d), s_front =
    ``frontend_rows(cfg, S)``."""
    bsz, seq = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((bsz,), torch.int32), "pos": ((), torch.int32)}
    s_front = frontend_rows(cfg, seq)
    specs = {"tokens": ((bsz, seq - s_front + (1 if shape.kind == "train" else 0)), torch.int32)}
    if cfg.frontend != "none":
        specs["frontend_embeds"] = ((bsz, s_front, cfg.d_model), torch.float32)
    return specs


def labels_from_batch(batch: dict, seq: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels (B, S) int64, mask (B, S) float32) aligned with the
    concatenated sequence of ``seq`` rows: the next tokens, after -1 for
    each of the ``seq - (tokens - 1)`` frontend rows, and ``labels >= 0``."""
    toks = batch["tokens"]
    labels = toks[:, 1:].long()
    s_front = seq - (toks.shape[1] - 1)
    if s_front > 0:
        pad = torch.full((toks.shape[0], s_front), -1, dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return labels, (labels >= 0).float()


# --------------------------------------------------------------- caches --


def cache_plan(cfg: ArchConfig, topo: Topology, shape: ShapeConfig) -> dict:
    """Static cache geometry: micro-batch rows and ring width (decode:
    seq_len + 16 slots, or with ``topo.long_context`` the largest window of
    ``layer_windows(long_context=True)``, 0 for an SSM, as at
    ``repro/models/transformer/model.py:675-680`` unsharded; prefill:
    seq_len)."""
    b_mb = max(shape.global_batch // topo.num_micro, 1)
    if shape.kind != "decode":
        w = shape.seq_len
    elif topo.long_context:
        w = max(cfg.layer_windows(long_context=True)) if cfg.arch_type != "ssm" else 0
    else:
        w = shape.seq_len + 16
    return {"b_mb": b_mb, "w_total": w, "w_local": w, "nm": topo.num_micro}


def init_cache(cfg: ArchConfig, topo: Topology, shape: ShapeConfig, *,
               dtype=torch.float32, device="cpu") -> dict:
    """A zero cache: leaves (num_stages, num_micro, slots, b_mb, ...), the
    layout of ``abstract_cache``."""
    check_supported(cfg)
    plan = cache_plan(cfg, topo, shape)
    sp = stacked_shape_plan(cfg, topo.num_stages)

    def build(one: dict, slots: int) -> dict:
        lead = (topo.num_stages, plan["nm"], slots)
        return {k: torch.zeros((*lead, *v.shape), dtype=v.dtype, device=device)
                for k, v in one.items()}

    mamba = lambda: B.init_mamba_cache(cfg, plan["b_mb"], dtype=dtype, device="meta")
    attn = lambda: B.init_attn_cache(cfg, plan["b_mb"], plan["w_local"], dtype=dtype,
                                     device="meta")
    if cfg.arch_type == "hybrid":
        return {"mamba": build(mamba(), sp["mamba_per_stage"]),
                "attn": build(attn(), sp["attn_per_stage"])}
    return build(mamba() if cfg.arch_type == "ssm" else attn(), sp["per_stage"])


# ---------------------------------------------------------------- stages --


def _stage_fn(cfg: ArchConfig, topo: Topology, extras: dict, blocks: Callable,
              shared: dict | None, mode: str, *, positions=None, cur_pos=None) -> Callable:
    """``stage(s, h, cache) -> h``: stage ``s``'s layer slots over one
    micro-batch's activation ``h``. ``blocks(s, i)`` gives slot i's params;
    ``cache`` is the (stage, micro-batch) view of the cache, its leaves
    (slots, ...), written in place (None when training). On a hybrid, groups
    of mamba slots, each followed by one application of the weight-shared
    attention block ``shared`` (``_hybrid_stage`` of the JAX model)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")

    def attn(lp, ex, h, c):
        if mode == "train":
            return B.block_train(cfg, lp, ex, h, positions=positions, kv_block=topo.kv_block)
        if mode == "prefill":
            return B.block_prefill(cfg, lp, ex, h, c, positions=positions,
                                   kv_block=topo.kv_block)[0]
        return B.block_decode(cfg, lp, ex, h, c, cur_pos=cur_pos)[0]

    def mamba(lp, ex, h, c):
        if mode == "train":
            return B.mamba_block_train(cfg, lp, ex, h)
        fn = B.mamba_block_prefill if mode == "prefill" else B.mamba_block_decode
        return fn(cfg, lp, ex, h, c)[0]

    if cfg.arch_type != "hybrid":
        block = mamba if cfg.arch_type == "ssm" else attn

        def stage(s, h, cache):
            for i in range(extras["active"].shape[1]):
                h = block(blocks(s, i), _slot_extras(extras, s, i), h,
                          None if cache is None else _slot(cache, i))
            return h

        return stage

    m_ex, a_ex = extras["mamba"], extras["attn"]
    n_attn = a_ex["active"].shape[1]
    m_grp = m_ex["active"].shape[1] // max(n_attn, 1)

    def hybrid_stage(s, h, cache):
        for g in range(max(n_attn, 1)):
            for j in range(g * m_grp, (g + 1) * m_grp):
                h = mamba(blocks(s, j), _slot_extras(m_ex, s, j), h,
                          None if cache is None else _slot(cache["mamba"], j))
            if n_attn:
                h = attn(shared, _slot_extras(a_ex, s, g), h,
                         None if cache is None else _slot(cache["attn"], g))
        return h

    return hybrid_stage


def _fill_drain_order(num_stages: int, num_micro: int) -> list[tuple[int, int]]:
    """(stage, micro-batch) pairs in GPipe fill-drain order."""
    return [(s, t - s) for t in range(num_micro + num_stages - 1)
            for s in range(num_stages) if 0 <= t - s < num_micro]


def _interleaved_order(num_devices: int, num_virtual: int,
                       num_micro: int) -> list[tuple[int, int]]:
    """(virtual stage, micro-batch) pairs in the tick order of
    ``spmd_pipeline_interleaved``: at tick t, ring position d runs
    micro-batch (t - d) mod C of round (t - d) // C, virtual stage
    round·D + d."""
    D, V, C = num_devices, num_virtual, num_micro
    return [(((t - d) // C) * D + d, (t - d) % C) for t in range(V * C + D - 1)
            for d in range(D) if 0 <= t - d < V * C]


def _micro_split(x: torch.Tensor, topo: Topology) -> list:
    if x.shape[0] % topo.num_micro:
        raise ValueError(f"batch {x.shape[0]} does not split into {topo.num_micro} micro-batches")
    return list(x.reshape(topo.num_micro, x.shape[0] // topo.num_micro, *x.shape[1:]))


def _run_stages(stage: Callable, order: list, acts: list, cache: dict | None = None) -> None:
    """Each (stage, micro-batch) of ``order`` over ``acts[micro]``, with the
    pair's cache view."""
    for s, m in order:
        acts[m] = stage(s, acts[m], None if cache is None else _slot(cache, s, m))


# ------------------------------------------------------------ step fns --


def _unstacked(blocks: dict, per: int) -> Callable:
    """``(s, i) -> slot params`` over views of the stacked leaves. One
    ``unbind`` per leaf: its backward stacks the slots' gradients once,
    with zeros for a slot that was skipped."""
    views = opt_lib.tree_map(lambda a: a.flatten(0, 1).unbind(0), blocks)
    return lambda s, i: opt_lib.tree_map(lambda v: v[s * per + i], views)


def make_train_step(cfg: ArchConfig, topo: Topology, shape: ShapeConfig, *,
                    lr: float = 1e-4) -> Callable:
    """One training step: ``step(params, opt_state, {"tokens": (B, S+1)}) ->
    (params, opt_state, {"loss": 0-d tensor})``. Embed, the staged stack over
    ``num_micro`` micro-batches (each (stage, micro-batch) under
    ``torch.utils.checkpoint`` when ``topo.remat``), the masked mean
    next-token loss over ``loss_chunks`` chunks along the minor batch dim
    (each checkpointed), the gradients of every parameter (zeros for a
    skipped slot), and one Adam update (``optimizer.adam(lr)``, the
    reference's defaults) applied to ``params`` and ``opt_state`` in place.
    ``step.optimizer`` is the optimizer, for ``init``; ``step.loss(params,
    batch)`` the step's loss without the update."""
    check_supported(cfg)
    if topo.schedule not in ("fill_drain", "interleaved"):
        raise ValueError(
            f"Topology.schedule must be 'fill_drain' or 'interleaved', got {topo.schedule!r}"
        )
    interleaved = topo.schedule == "interleaved" and topo.num_stages > 1
    if interleaved:
        if cfg.arch_type == "hybrid":
            raise NotImplementedError(
                "interleaved schedule requires a homogeneous block stack; "
                "zamba2-style hybrid stages run fill_drain"
            )
        if topo.num_micro < topo.pipe_devices:
            raise ValueError(
                f"interleaved schedule needs num_micro ({topo.num_micro}) >= "
                f"physical stage devices ({topo.pipe_devices})"
            )
        order = _interleaved_order(topo.pipe_devices, topo.num_virtual, topo.num_micro)
    else:
        order = _fill_drain_order(topo.num_stages, topo.num_micro)
    seq = shape.seq_len
    extras = make_extras(cfg, topo.num_stages)
    per = _stacked_slots(cfg, topo.num_stages)
    optimizer = opt_lib.adam(lr)
    want = {name: spec[0] for name, spec in batch_specs(cfg, shape).items()}

    def chunk_loss(params, yi, li, mi):
        logits = lm_head_logits(cfg, params, yi)
        # masked mean accumulated as (sum, count)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, li.clamp(min=0)[..., None])[..., 0]
        total = ((lse - ll) * mi).sum()
        if cfg.mtp:
            # multi-token-prediction aux head (deepseek-v3): position t
            # predicts t + 2, weight 0.3, over the main mask's count
            logits2 = lm_head_logits(cfg, params, yi @ params["mtp_proj"])[:, :-1]
            mi2 = mi[:, 1:] * mi[:, :-1]
            lse2 = torch.logsumexp(logits2, dim=-1)
            ll2 = logits2.gather(-1, li[:, 1:].clamp(min=0)[..., None])[..., 0]
            total = total + 0.3 * ((lse2 - ll2) * mi2).sum()
        return total, mi.sum()

    def loss_fn(params, batch):
        # frontend rows, where there are any, split into micro-batches with x
        x = embed_inputs(cfg, params, dict(batch, tokens=batch["tokens"][:, :-1]))
        positions = make_positions(cfg, seq, device=x.device)
        stage = _stage_fn(cfg, topo, extras, _unstacked(params["blocks"], per),
                          params.get("shared_attn"), "train", positions=positions)
        acts = _micro_split(x, topo)
        for s, m in order:
            if topo.remat:
                acts[m] = checkpoint(stage, s, acts[m], None, use_reentrant=False)
            else:
                acts[m] = stage(s, acts[m], None)
        y = torch.cat(acts)
        labels, mask = labels_from_batch(batch, seq)
        bsz = y.shape[0]
        chunks = min(topo.loss_chunks, bsz)
        # chunk along the MINOR batch dim, as the reference does: chunk i
        # holds rows i, i + chunks, ...
        yc = y.reshape(bsz // chunks, chunks, seq, -1).transpose(0, 1)
        lc = labels.reshape(bsz // chunks, chunks, seq).transpose(0, 1)
        mc = mask.reshape(bsz // chunks, chunks, seq).transpose(0, 1)
        total = torch.zeros((), device=y.device)
        count = torch.zeros((), device=y.device)
        for i in range(chunks):
            s_i, c_i = checkpoint(chunk_loss, params, yc[i], lc[i], mc[i], use_reentrant=False)
            total, count = total + s_i, count + c_i
        return total / torch.clamp(count, min=1.0)

    def train_step(params: dict, opt_state, batch: dict):
        got = {name: tuple(batch[name].shape) for name in want if name in batch}
        if got != want:
            raise ValueError(f"batch of shapes {got}, step built for {want}")
        leaves = opt_lib.tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(leaves, batch)
        flat = opt_lib.tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        del leaves, flat
        optimizer.apply_(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach()}

    train_step.optimizer = optimizer
    train_step.loss = loss_fn
    return train_step


def _prefill(cfg: ArchConfig, topo: Topology, extras: dict, params: dict, cache: dict,
             batch: dict, seq: int, positions: torch.Tensor | None = None):
    """The prefill of ``make_prefill_step``, at ``positions`` when given: a
    check's positions (the m-rope decode's own), of ``make_positions``'
    shape, whose mask row is checked here never to decrease, as the flash
    kernel needs (``make_positions``' never does, by construction)."""
    # frontend rows, where there are any, split into micro-batches with x
    x = embed_inputs(cfg, params, batch)
    if x.shape[1] != seq:
        raise ValueError(f"prompt of {x.shape[1]} rows, step built for {seq}")
    if positions is None:
        positions = make_positions(cfg, seq, device=x.device)
    else:
        want = (3, seq) if cfg.rope_kind == "mrope" else (seq,)
        if tuple(positions.shape) != want:
            raise ValueError(f"positions of shape {tuple(positions.shape)}, the step needs {want}")
        check_order("positions", positions[0] if cfg.rope_kind == "mrope" else positions)
        positions = positions.to(x.device, torch.int32)
    stage = _stage_fn(cfg, topo, extras, lambda s, i: _slot(params["blocks"], s, i),
                      params.get("shared_attn"), "prefill", positions=positions)
    acts = _micro_split(x, topo)
    _run_stages(stage, _fill_drain_order(topo.num_stages, topo.num_micro), acts, cache)
    y_last = torch.cat([a[:, -1] for a in acts])
    return lm_head_logits(cfg, params, y_last), cache


def make_prefill_step(cfg: ArchConfig, topo: Topology, shape: ShapeConfig) -> Callable:
    """Full-sequence prefill: ``step(params, cache, {"tokens": (B, S -
    s_front)[, "frontend_embeds": (B, s_front, d)]}) -> (last-token logits
    (B, V) float32, cache)``, the cache (from ``init_cache`` at ``shape``)
    filled in place."""
    check_supported(cfg)
    seq = shape.seq_len
    extras = make_extras(cfg, topo.num_stages)

    def prefill_step(params: dict, cache: dict, batch: dict):
        return _prefill(cfg, topo, extras, params, cache, batch, seq)

    return prefill_step


def make_serve_step(cfg: ArchConfig, topo: Topology, shape: ShapeConfig) -> Callable:
    """One decode step: ``step(params, cache, {"tokens": (B,), "pos": int})
    -> (next tokens (B,) int32, cache, logits (B, V) float32)``, the cache
    (from ``init_cache`` at ``shape``) updated in place at slot pos mod W.
    With ``topo.long_context`` every layer attends within its long-context
    window, over a ring that wraps at the largest (``cache_plan``)."""
    check_supported(cfg)
    extras = make_extras(cfg, topo.num_stages, long_context=topo.long_context)
    order = _fill_drain_order(topo.num_stages, topo.num_micro)

    def serve_step(params: dict, cache: dict, batch: dict):
        x = params["embed"][batch["tokens"].long()][:, None, :]  # (B, 1, d)
        stage = _stage_fn(cfg, topo, extras, lambda s, i: _slot(params["blocks"], s, i),
                          params.get("shared_attn"), "decode", cur_pos=int(batch["pos"]))
        acts = _micro_split(x, topo)
        _run_stages(stage, order, acts, cache)
        logits = lm_head_logits(cfg, params, torch.cat(acts)[:, 0])
        return logits.argmax(dim=-1).to(torch.int32), cache, logits

    return serve_step
