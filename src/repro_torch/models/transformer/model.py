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
from repro_torch.core.spmd_pipe import (
    StageRing, spmd_pipeline, spmd_pipeline_backward, spmd_pipeline_interleaved,
)
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
    ring as wide as the largest (``cache_plan``); nothing is sharded.

    ``ring``: None runs every stage in this process. A
    ``core.ranks.RankGrid`` of one replica (``RankGrid(1, pipe_devices)``)
    makes this process one ring position of a torchrun world: it holds
    ``held_stages(topo, position)``, its params' and caches' stacked leaves
    only those rows (``init_params(..., stages=...)``, ``position_shard``,
    ``init_cache``), and its activations hop by point-to-point ops."""

    num_stages: int = 1
    num_micro: int = 1
    kv_block: int = 512
    schedule: str = "fill_drain"
    num_virtual: int = 1
    remat: bool = True
    loss_chunks: int = 8
    long_context: bool = False
    ring: object = dataclasses.field(default=None, compare=False)

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
                dtype=torch.float32, device="cpu", stages=None) -> dict:
    """Random weights drawn on ``device`` (the JAX package's init scheme:
    normal(0.02) matrices, zero norms and biases, the Mamba constants; not
    its bits — tests that compare with JAX convert its params instead).

    The leaves outside the stack come from a ``torch.Generator`` seeded with
    ``seed``; stage s's ``blocks`` rows from one seeded with (seed, s) alone
    (``stage_seed``). ``stages`` (default: all ``num_stages``) names the
    stages whose rows to draw, in row order: a ring position draws only its
    own (``held_stages``), the same rows one process draws for them, and no
    rank ever holds the whole stack."""
    check_supported(cfg)
    stages = list(range(num_stages)) if stages is None else list(stages)
    gen = lambda s: torch.Generator(device=device).manual_seed(
        seed if s is None else stage_seed(seed, s))
    return _build_params(cfg, gen, stages, num_stages, dtype)


def stage_seed(seed: int, stage: int) -> int:
    """The generator seed of stage ``stage``'s block rows: a function of
    (seed, stage) only."""
    hi, lo = np.random.SeedSequence((seed, stage + 1)).generate_state(2)
    return (int(hi) << 32) | int(lo)


class _NoDraws:
    """Stands for the generator on the meta device, where nothing is drawn
    (``common.normal_init`` returns empty leaves there)."""

    device = torch.device("meta")


def abstract_params(cfg: ArchConfig, num_stages: int = 1, dtype=torch.float32) -> dict:
    """``init_params``' tree on the meta device: its shapes and dtypes, no
    data and no draws. Counterpart of the reference's ``_abstract_params``
    (``jax.eval_shape`` of its init)."""
    check_supported(cfg)
    return _build_params(cfg, lambda s: _NoDraws(), list(range(num_stages)), num_stages, dtype)


def _build_params(cfg: ArchConfig, gen_of: Callable, stages: list, num_stages: int,
                  dtype) -> dict:
    gen = gen_of(None)
    device = gen.device
    params = {
        "embed": normal_init(gen, (cfg.vocab_size, cfg.d_model), dtype=dtype),
        "final_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal_init(gen, (cfg.d_model, cfg.vocab_size), dtype=dtype)
    if cfg.mtp:
        params["mtp_proj"] = normal_init(gen, (cfg.d_model, cfg.d_model), dtype=dtype)
    if cfg.arch_type == "hybrid":
        params["shared_attn"] = B.init_block(cfg, gen, dtype=dtype)
    init = B.init_mamba_block if cfg.arch_type in ("ssm", "hybrid") else B.init_block
    slots = _stacked_slots(cfg, num_stages)
    if device.type == "meta" or len(stages) == 1:
        params["blocks"] = init(cfg, gen_of(stages[0]), lead=(len(stages), slots), dtype=dtype)
        return params
    # one stage's rows at a time, into the stack: the draw holds one extra stage
    blocks = None
    for row, s in enumerate(stages):
        part = init(cfg, gen_of(s), lead=(1, slots), dtype=dtype)
        if blocks is None:
            blocks = opt_lib.tree_map(lambda a: a.new_empty((len(stages), *a.shape[1:])), part)
        opt_lib.tree_map(lambda dst, src: dst[row:row + 1].copy_(src), blocks, part)
        del part
    params["blocks"] = blocks
    return params


def held_stages(topo: "Topology", position: int) -> list[int]:
    """The (virtual) stages ring position ``position`` holds, in row order:
    {position} under fill-drain, {v·D + position} interleaved."""
    if topo.schedule == "interleaved" and topo.num_stages > 1:
        return [v * topo.pipe_devices + position for v in range(topo.num_virtual)]
    return [position]


def position_shard(tree: dict, topo: "Topology", position: int) -> dict:
    """One ring position's copy of a full parameter tree (the port's own, or
    the reference's through ``convert.params_from_jax``; Adam's moments
    alike): the ``blocks`` rows of ``held_stages``, every other leaf whole."""
    rows = held_stages(topo, position)
    take = lambda a: a[torch.tensor(rows, device=a.device)].clone()
    return {k: opt_lib.tree_map(take if k == "blocks" else torch.clone, v)
            for k, v in tree.items()}


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
    layout of ``abstract_cache``; on a ring position (``topo.ring``) only
    its own stage's row, (1, num_micro, slots, b_mb, ...)."""
    check_supported(cfg)
    plan = cache_plan(cfg, topo, shape)
    sp = stacked_shape_plan(cfg, topo.num_stages)
    rows = topo.num_stages if topo.ring is None else 1

    def build(one: dict, slots: int) -> dict:
        lead = (rows, plan["nm"], slots)
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
              shared: Callable | None, mode: str, *, positions=None, cur_pos=None) -> Callable:
    """``stage(s, h, cache) -> h``: stage ``s``'s layer slots over one
    micro-batch's activation ``h``. ``blocks(s, i)`` gives slot i's params;
    ``cache`` is the (stage, micro-batch) view of the cache, its leaves
    (slots, ...), written in place (None when training). On a hybrid, groups
    of mamba slots, each followed by one application of the weight-shared
    attention block ``shared(s)`` (``_hybrid_stage`` of the JAX model)."""
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
                h = attn(shared(s), _slot_extras(a_ex, s, g), h,
                         None if cache is None else _slot(cache["attn"], g))
        return h

    return hybrid_stage


def _ring(topo: Topology, serving: bool = False) -> StageRing:
    """The step's stage ring: ``pipe_devices`` positions of ``num_virtual``
    stages for interleaved training, else ``num_stages`` positions of one
    (the serving steps always run fill-drain); on ``topo.ring``'s ranks
    when it is set."""
    if not serving and topo.schedule == "interleaved" and topo.num_stages > 1:
        return StageRing(topo.pipe_devices, topo.num_virtual, topo.num_micro, topo.ring)
    return StageRing(topo.num_stages, 1, topo.num_micro, topo.ring)


def _interleaved_order(num_devices: int, num_virtual: int,
                       num_micro: int) -> list[tuple[int, int]]:
    """(virtual stage, micro-batch) pairs in the tick order of
    ``spmd_pipeline_interleaved``: at tick t, ring position d runs
    micro-batch (t - d) mod C of round (t - d) // C, virtual stage
    round·D + d."""
    return StageRing(num_devices, num_virtual, num_micro).order()


def _micro_split(x: torch.Tensor, topo: Topology) -> list:
    if x.shape[0] % topo.num_micro:
        raise ValueError(f"batch {x.shape[0]} does not split into {topo.num_micro} micro-batches")
    return list(x.reshape(topo.num_micro, x.shape[0] // topo.num_micro, *x.shape[1:]))


def _check_rows(ring: StageRing, tree: dict, what: str) -> None:
    """Every leaf of ``tree`` stacks the rows of the stages this process
    holds: all of them in one process, its own on a ring position."""
    rows = ring.K if ring.grid is None else ring.V
    got = {tuple(a.shape[:1]) for a in opt_lib.tree_leaves(tree)}
    if got != {(rows,)}:
        where = "one process" if ring.grid is None else f"ring position {ring.positions[0]}"
        raise ValueError(f"{what} stack {sorted(got)} rows; {where} holds {rows} "
                         "(position_shard / init_params(stages=held_stages(...)))")


def _from_last(ring: StageRing, value: torch.Tensor | None, shape, dtype, device) -> torch.Tensor:
    """``value``, made on the position of the last stage, on every position
    (a broadcast from that rank; in one process, the value itself)."""
    if ring.grid is None:
        return value
    import torch.distributed as dist

    buf = value.contiguous() if value is not None else torch.empty(shape, dtype=dtype,
                                                                    device=device)
    dist.broadcast(buf, src=ring.grid.rank_at(ring.last))
    return buf


def _gathered(grid, value: torch.Tensor) -> list:
    """Every ring position's ``value``, in position order."""
    import torch.distributed as dist

    got = [torch.empty_like(value) for _ in range(grid.D)]
    dist.all_gather(got, value)  # the world is the one ring (StageRing refuses a data axis)
    return [got[grid.rank_at(d)] for d in range(grid.D)]


def _ascending_sum(parts: list) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, in that order."""
    out = parts[0].clone()
    for p in parts[1:]:
        out.add_(p)
    return out


def _flat(tree: dict) -> torch.Tensor:
    return torch.cat([a.reshape(-1) for a in opt_lib.tree_leaves(tree)])


def _unflat_into(tree: dict, flat: torch.Tensor) -> None:
    off = 0
    for a in opt_lib.tree_leaves(tree):
        a.copy_(flat[off:off + a.numel()].view_as(a))
        off += a.numel()


# ------------------------------------------------------------ step fns --


def make_train_step(cfg: ArchConfig, topo: Topology, shape: ShapeConfig, *,
                    lr: float = 1e-4) -> Callable:
    """One training step: ``step(params, opt_state, {"tokens": (B, S+1)}) ->
    (params, opt_state, {"loss": 0-d tensor})``. Embed, the stage ring over
    ``num_micro`` micro-batches (``spmd_pipeline`` or
    ``spmd_pipeline_interleaved``; each (stage, micro-batch) under
    ``torch.utils.checkpoint`` when ``topo.remat``), the masked mean
    next-token loss over ``loss_chunks`` chunks along the minor batch dim
    (each checkpointed), then the backward pipeline
    (``spmd_pipeline_backward``: the ticks in reverse, one autograd pass per
    (stage, micro-batch)), the gradients of every parameter (zeros for a
    skipped slot), and one Adam update (``optimizer.adam(lr)``, the
    reference's defaults) applied to ``params`` and ``opt_state`` in place.

    Each layer slot of each stage (and, on the hybrid, each stage's use of
    the shared attention block) is an autograd leaf of its own, whose
    gradient sums its micro-batches C-1 down to 0 in place; the shared
    block's per-stage gradients are then summed in ascending stage order. With ``topo.ring`` the same
    step runs on each rank over its own rows: the last position computes
    the loss over the whole batch and broadcasts it, the replicated leaves'
    gradients (``embed``, ``final_ln``, ``head``, ``mtp_proj``: nonzero only
    where used) are summed over the ring, the shared block's gathered, and
    every rank applies Adam to its own tree — bit for bit the one-process
    step's numbers. ``step.optimizer`` is the optimizer, for ``init``;
    ``step.loss(params, batch)`` the step's loss without the update."""
    check_supported(cfg)
    if topo.schedule not in ("fill_drain", "interleaved"):
        raise ValueError(
            f"Topology.schedule must be 'fill_drain' or 'interleaved', got {topo.schedule!r}"
        )
    if topo.schedule == "interleaved" and topo.num_stages > 1:
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
    ring = _ring(topo)
    seq = shape.seq_len
    extras = make_extras(cfg, topo.num_stages)
    optimizer = opt_lib.adam(lr)
    want = {name: spec[0] for name, spec in batch_specs(cfg, shape).items()}
    held = [k for d in ring.positions for k in ring.stages(d)]
    last = ring.holds(ring.K - 1)

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

    def head_loss(params, y, batch):
        """The loss over the whole batch from the last stage's output."""
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

    def wire(batch):
        """One hop's shape: a micro-batch's activation, or its cotangent."""
        return batch["tokens"].shape[0] // topo.num_micro, seq, cfg.d_model

    def forward(params, blocks, shared, batch, fwd):
        """Embed on stage 0's position and run the ring; ``fwd(stage, k, m,
        h)`` runs one item. Returns (x, {m: the last stage's output})."""
        embed = params["embed"]
        positions = make_positions(cfg, seq, device=embed.device)
        stage = _stage_fn(cfg, topo, extras, blocks, shared, "train", positions=positions)
        x = xs = None
        if ring.holds(0):
            # frontend rows, where there are any, split into micro-batches with x
            x = embed_inputs(cfg, params, dict(batch, tokens=batch["tokens"][:, :-1]))
            xs = _micro_split(x, topo)
        outs = spmd_pipeline_interleaved(lambda k, m, h: fwd(stage, k, m, h), xs, ring,
                                         wire_shape=wire(batch), dtype=embed.dtype,
                                         device=embed.device)
        return x, outs

    def loss_fn(params, batch):
        _check_rows(ring, params["blocks"], "params['blocks']")
        blocks = lambda k, i: _slot(params["blocks"], ring.row_of(k), i)
        shared = (lambda k: params["shared_attn"]) if "shared_attn" in params else None
        _, outs = forward(params, blocks, shared, batch, lambda st, k, m, h: st(k, h, None))
        loss = head_loss(params, torch.cat([outs[m] for m in range(topo.num_micro)]), batch) \
            if last else None
        return _from_last(ring, loss, (), torch.float32, params["embed"].device)

    def train_step(params: dict, opt_state, batch: dict):
        got = {name: tuple(batch[name].shape) for name in want if name in batch}
        if got != want:
            raise ValueError(f"batch of shapes {got}, step built for {want}")
        _check_rows(ring, params["blocks"], "params['blocks']")
        grads = opt_lib.tree_map(torch.zeros_like, params)

        def leaf(p, g):
            # an autograd leaf over p whose gradient accumulates into g in place
            out = p.detach().requires_grad_(True)
            out.grad = g
            return out

        leaves = {k: opt_lib.tree_map(leaf, v, grads[k]) for k, v in params.items()
                  if k not in ("blocks", "shared_attn")}
        # one leaf per (stage, slot), its gradient a view of its row of grads:
        # each backward pass adds into it, and no pass stacks a stage's rows
        per = _stacked_slots(cfg, topo.num_stages)
        slots = {(k, i): opt_lib.tree_map(
            lambda p, g: leaf(p[ring.row_of(k), i], g[ring.row_of(k), i]),
            params["blocks"], grads["blocks"]) for k in held for i in range(per)}
        blocks = lambda k, i: slots[(k, i)]
        shared = None
        if "shared_attn" in params:
            aliases = {k: opt_lib.tree_map(lambda p: leaf(p, torch.zeros_like(p)),
                                           params["shared_attn"]) for k in held}
            shared = aliases.__getitem__
        saved = {}

        def fwd(stage, k, m, h):
            h = h.detach().requires_grad_(True)
            if topo.remat:
                y = checkpoint(stage, k, h, None, use_reentrant=False)
            else:
                y = stage(k, h, None)
            saved[(k, m)] = (h, y)
            return y.detach()

        x, outs = forward(leaves, blocks, shared, batch, fwd)
        loss, cotangents = None, {}
        if last:
            ys = [outs[m].requires_grad_(True) for m in range(topo.num_micro)]
            loss = head_loss(leaves, torch.cat(ys), batch)
            torch.autograd.backward(loss)
            cotangents = {m: y.grad for m, y in enumerate(ys)}
            del ys

        def bwd(k, m, g):
            h, y = saved.pop((k, m))
            torch.autograd.backward(y, g)
            return h.grad

        d_x = spmd_pipeline_backward(bwd, cotangents, ring, wire_shape=wire(batch),
                                     dtype=params["embed"].dtype, device=params["embed"].device)
        del cotangents, outs
        if x is not None:
            torch.autograd.backward(x, torch.stack([d_x[m] for m in range(topo.num_micro)])
                                    .reshape(x.shape))
        del x, d_x, leaves, slots
        if shared is not None:  # one gradient per stage, summed in ascending stage order
            parts = [_flat(opt_lib.tree_map(lambda a: a.grad, aliases[k])) for k in held]
            del aliases, shared
            if ring.grid is not None:
                parts = _gathered(ring.grid, parts[0])
            _unflat_into(grads["shared_attn"], _ascending_sum(parts))
            del parts
        if ring.grid is not None:  # each replicated leaf: its users' gradients, zeros elsewhere
            import torch.distributed as dist

            for k, v in grads.items():
                if k not in ("blocks", "shared_attn"):
                    for g in opt_lib.tree_leaves(v):
                        dist.all_reduce(g)
        loss = _from_last(ring, None if loss is None else loss.detach(), (), torch.float32,
                          params["embed"].device)
        optimizer.apply_(opt_lib.tree_leaves(grads), opt_state, params)
        return params, opt_state, {"loss": loss}

    train_step.optimizer = optimizer
    train_step.loss = loss_fn
    return train_step


def _serve_ring(topo: Topology, params: dict, cache: dict) -> StageRing:
    ring = _ring(topo, serving=True)
    _check_rows(ring, params["blocks"], "params['blocks']")
    _check_rows(ring, cache, "the cache")
    return ring


def _prefill(cfg: ArchConfig, topo: Topology, extras: dict, params: dict, cache: dict,
             batch: dict, seq: int, positions: torch.Tensor | None = None):
    """The prefill of ``make_prefill_step``, at ``positions`` when given: a
    check's positions (the m-rope decode's own), of ``make_positions``'
    shape, whose mask row is checked here never to decrease, as the flash
    kernel needs (``make_positions``' never does, by construction)."""
    ring = _serve_ring(topo, params, cache)
    embed = params["embed"]
    rows = batch["tokens"].shape[1] + (batch["frontend_embeds"].shape[1]
                                       if "frontend_embeds" in batch else 0)
    if rows != seq:
        raise ValueError(f"prompt of {rows} rows, step built for {seq}")
    if positions is None:
        positions = make_positions(cfg, seq, device=embed.device)
    else:
        want = (3, seq) if cfg.rope_kind == "mrope" else (seq,)
        if tuple(positions.shape) != want:
            raise ValueError(f"positions of shape {tuple(positions.shape)}, the step needs {want}")
        check_order("positions", positions[0] if cfg.rope_kind == "mrope" else positions)
        positions = positions.to(embed.device, torch.int32)
    stage = _stage_fn(cfg, topo, extras, lambda s, i: _slot(params["blocks"], ring.row_of(s), i),
                      lambda s: params.get("shared_attn"), "prefill", positions=positions)
    # frontend rows, where there are any, split into micro-batches with x
    xs = _micro_split(embed_inputs(cfg, params, batch), topo) if ring.holds(0) else None
    b = batch["tokens"].shape[0]
    outs = spmd_pipeline(lambda s, m, h: stage(s, h, _slot(cache, ring.row_of(s), m)), xs, ring,
                         wire_shape=(b // topo.num_micro, seq, cfg.d_model), dtype=embed.dtype,
                         device=embed.device)
    y_last = torch.cat([outs[m][:, -1] for m in range(topo.num_micro)]) if outs else None
    y_last = _from_last(ring, y_last, (b, cfg.d_model), embed.dtype, embed.device)
    return lm_head_logits(cfg, params, y_last), cache


def make_prefill_step(cfg: ArchConfig, topo: Topology, shape: ShapeConfig) -> Callable:
    """Full-sequence prefill: ``step(params, cache, {"tokens": (B, S -
    s_front)[, "frontend_embeds": (B, s_front, d)]}) -> (last-token logits
    (B, V) float32, cache)``, the cache (from ``init_cache`` at ``shape``)
    filled in place. On ``topo.ring``'s ranks every rank passes the whole
    batch: position 0 embeds it, each position fills its own cache rows,
    and the last position's final hidden rows are broadcast, so every rank
    returns the logits."""
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
    window, over a ring that wraps at the largest (``cache_plan``). On
    ``topo.ring``'s ranks every rank passes the tokens, position 0 embeds
    them, and the last position's final hidden rows are broadcast, so every
    rank returns the next tokens and the logits."""
    check_supported(cfg)
    extras = make_extras(cfg, topo.num_stages, long_context=topo.long_context)

    def serve_step(params: dict, cache: dict, batch: dict):
        ring = _serve_ring(topo, params, cache)
        embed = params["embed"]
        stage = _stage_fn(cfg, topo, extras,
                          lambda s, i: _slot(params["blocks"], ring.row_of(s), i),
                          lambda s: params.get("shared_attn"), "decode",
                          cur_pos=int(batch["pos"]))
        xs = _micro_split(embed[batch["tokens"].long()][:, None, :], topo) \
            if ring.holds(0) else None  # (B, 1, d)
        b = batch["tokens"].shape[0]
        outs = spmd_pipeline(lambda s, m, h: stage(s, h, _slot(cache, ring.row_of(s), m)), xs,
                             ring, wire_shape=(b // topo.num_micro, 1, cfg.d_model),
                             dtype=embed.dtype, device=embed.device)
        y = torch.cat([outs[m][:, 0] for m in range(topo.num_micro)]) if outs else None
        logits = lm_head_logits(cfg, params,
                                _from_last(ring, y, (b, cfg.d_model), embed.dtype, embed.device))
        return logits.argmax(dim=-1).to(torch.int32), cache, logits

    return serve_step
