"""Full LM assembly: embed → pipelined block stack → head. Counterpart of
``repro.models.transformer.model``: training, prefill and decode.

The JAX model runs its stages on a ``("data", "model")`` mesh
(``shard_map`` over the "model" axis, pipeline ticks inside
``spmd_pipeline``, the "data" axis its ``fsdp`` axis). The port's
``make_train_step``, ``make_prefill_step`` and ``make_serve_step`` return
steps that walk stages × micro-batches on the host — in fill-drain order
(tick t runs stage s on micro-batch t - s), or for training under
``schedule="interleaved"`` in the order of ``spmd_pipeline_interleaved``
(virtual stage v·D + d on ring position d) — for every replica of the data
axis (``Topology.data``) in one process, or one (replica, ring position)
per rank of a ``RankGrid`` (``Topology.ring``). Parameters and caches
keep the JAX layout, so the two compare leaf by leaf:

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
import functools
import math
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeConfig, pipeline_padding
from repro_torch.core.data_group import DataGroup, ordered_sum
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
    """Pipeline shape of a step: stages (virtual stages when interleaved),
    micro-batches per step, the plain attention's KV block (the CPU route
    of the flash op), and for training the schedule (``fill_drain`` or
    ``interleaved`` over ``num_stages / num_virtual`` ring positions),
    activation recomputation per (stage, micro-batch) and the loss's batch
    chunks.

    ``data`` is the reference's ``fsdp_size``: replicas of the stage ring
    over the data axis, replica r taking rows ``[r·b_local, (r+1)·b_local)``
    of the batch. Across it the block leaves are ZeRO-3-split (``zero3``,
    the reference's default: a replica holds ``1 / data`` of a split leaf
    and gathers it just before its layer runs; off, the blocks are
    replicated and only the ``embed``/``head`` moments are split, ZeRO-1),
    the experts are split (expert parallelism), and MoE runs ``moe_mode``
    (``gathered`` or ``a2a``). ``param_layout`` says where each leaf lives.

    ``long_context`` is the reference's ``seq_shard_decode``: a decode
    whose layers all take ``layer_windows(long_context=True)``'s windows,
    over a ring as wide as the largest (``cache_plan``); with ``data`` > 1
    that ring is split over the data axis, every replica holds the same
    tokens, and the decode's MoE runs ``replicated``.

    ``pods`` is the reference's ``pod_axis``: each pod holds a whole
    ``(data, stage)`` grid, the batch rows split ``pods · data`` ways in
    (pod, data) order, pod p taking rows ``[p·B/pods, (p+1)·B/pods)``;
    params and moments are the same in every pod (ZeRO-3, ZeRO-1 and the
    experts split over ``data`` alone), the loss is the mean over the whole
    batch, and the gradients are summed across pods in ascending pod order
    before every pod applies the same update. The long-context decode
    keeps its one row, replicated across pods.

    ``ring``: None runs every pod, replica and stage in this process (a
    hop is a hand-over, a data- or pod-axis collective an ordered local
    sum or concatenation: ``core.data_group``). A ``core.ranks.RankGrid(
    data, pipe_devices, pods=pods)`` makes this process one ring position
    of one replica of one pod in a torchrun world: it holds
    ``held_stages(topo, position)``, its params' and caches' stacked leaves
    only those rows and its data shard of each split leaf
    (``init_params(..., stages=..., data_rank=...)``, ``grid_shard``,
    ``init_cache``); its activations hop by point-to-point ops, the data
    axis's collectives run over its ``data_group`` and the pod axis's over
    its ``pod_group``."""

    num_stages: int = 1
    num_micro: int = 1
    kv_block: int = 512
    schedule: str = "fill_drain"
    num_virtual: int = 1
    remat: bool = True
    loss_chunks: int = 8
    long_context: bool = False
    data: int = 1
    moe_mode: str = "gathered"
    zero3: bool = True
    pods: int = 1
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

    @property
    def seq_shard(self) -> bool:
        """Whether a long-context decode splits its ring over the data axis."""
        return self.long_context and self.data > 1


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


def check_topology(cfg: ArchConfig, topo: Topology) -> None:
    """Raise ``ValueError`` for a data axis the config or the ring cannot hold."""
    if topo.data < 1 or topo.pods < 1:
        raise ValueError(f"Topology.data and .pods must be >= 1, got {topo.data}, {topo.pods}")
    if topo.moe_mode not in ("gathered", "a2a"):
        raise ValueError(f"Topology.moe_mode must be 'gathered' or 'a2a', got {topo.moe_mode!r}")
    if cfg.num_experts and cfg.num_experts % topo.data:
        raise ValueError(f"{cfg.num_experts} experts do not split over a data axis of {topo.data}")
    grid = topo.ring
    if grid is not None and (grid.dp, getattr(grid, "pods", 1)) != (topo.data, topo.pods):
        raise ValueError(f"a Topology of data {topo.data} and pods {topo.pods} on a rank grid "
                         f"of {grid.dp} replicas x {grid.D} positions in "
                         f"{getattr(grid, 'pods', 1)} pods")


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
                dtype=torch.float32, device="cpu", stages=None, topo: Topology | None = None,
                data_rank: int | None = None) -> dict:
    """Random weights drawn on ``device`` (the JAX package's init scheme:
    normal(0.02) matrices, zero norms and biases, the Mamba constants; not
    its bits — tests that compare with JAX convert its params instead).

    The leaves outside the stack come from a ``torch.Generator`` seeded with
    ``seed``; stage s's ``blocks`` rows from one seeded with (seed, s) alone
    (``stage_seed``). ``stages`` (default: all ``num_stages``) names the
    stages whose rows to draw, in row order: a ring position draws only its
    own (``held_stages``), the same rows one process draws for them, and no
    rank ever holds the whole stack.

    With ``topo.data`` > 1, a leaf that ``param_layout`` splits over the
    data axis is drawn one data shard at a time, shard r of stage s from a
    generator seeded with (seed, s, r) alone (``shard_seed``; the shared
    block's with s = -1), its other leaves from the stage's generator.
    ``data_rank`` (default: every shard, the whole leaf) names the shard to
    draw: a rank of a ``RankGrid`` draws only its own, the rows one process
    draws for it."""
    check_supported(cfg)
    stages = list(range(num_stages)) if stages is None else list(stages)
    gen = lambda s: torch.Generator(device=device).manual_seed(
        seed if s is None else stage_seed(seed, s))
    if topo is None or topo.data == 1:
        return _build_params(cfg, gen, stages, num_stages, dtype)
    check_topology(cfg, topo)
    shards = list(range(topo.data)) if data_rank is None else [data_rank]
    layout, shapes = leaf_layout(cfg, topo), abstract_params(cfg, topo.num_stages)

    def draws(s: int, common: torch.Generator, top: str) -> ShardDraws:
        lead = 2 if top == "blocks" else 0
        gens = [torch.Generator(device=device).manual_seed(shard_seed(seed, s, r))
                for r in shards]
        return ShardDraws(common, gens, topo.data,
                          _dims_by_shape(layout.params[top], shapes[top], lead), lead)

    return _build_params(cfg, lambda s: gen(s) if s is None else draws(s, gen(s), "blocks"),
                         stages, num_stages, dtype,
                         shared_of=lambda common: draws(-1, common, "shared_attn"))


def _dims_by_shape(dims: dict, shapes: dict, lead: int) -> dict:
    """{a leaf's shape after its ``lead`` stacking dims: its split dim
    there, or None} over a tree of ``leaf_layout`` split dims and its
    ``abstract_params`` shapes. The layout decides by path; the draws see
    only shapes, and no two leaves of one shape split differently."""
    out = {}
    for d, a in zip(opt_lib.tree_leaves(dims), opt_lib.tree_leaves(shapes)):
        key, dim = tuple(a.shape[lead:]), None if d is None else d - lead
        if out.setdefault(key, dim) != dim:
            raise ValueError(f"leaves of shape {key} split on dims {out[key]} and {dim}")
    return out


def stage_seed(seed: int, stage: int) -> int:
    """The generator seed of stage ``stage``'s block rows: a function of
    (seed, stage) only."""
    hi, lo = np.random.SeedSequence((seed, stage + 1)).generate_state(2)
    return (int(hi) << 32) | int(lo)


def shard_seed(seed: int, stage: int, data_rank: int) -> int:
    """The generator seed of data shard ``data_rank`` of stage ``stage``'s
    split leaves (stage -1: the shared block's): a function of the three
    only."""
    hi, lo = np.random.SeedSequence((seed, stage + 1, data_rank + 1)).generate_state(2)
    return (int(hi) << 32) | int(lo)


class ShardDraws:
    """``normal_init``'s source under a data-split layout: a leaf that
    ``dims`` (its shape after the ``lead`` stacking dims: its split dim
    there, or None; ``_dims_by_shape``) splits is drawn shard by shard,
    each from its own generator of ``gens``, and the shards concatenated;
    any other leaf is drawn from ``common``, as every replica draws it."""

    def __init__(self, common: torch.Generator, gens: list, size: int, dims: dict, lead: int):
        self.common, self.gens, self.size, self.dims, self.lead = (
            common, gens, size, dims, lead)
        self.device = common.device

    def normal(self, shape: tuple, *, scale: float, dtype) -> torch.Tensor:
        dim = self.dims[tuple(shape[self.lead:])]
        if dim is None:
            return normal_init(self.common, shape, scale=scale, dtype=dtype)
        dim += self.lead
        part = list(shape)
        part[dim] //= self.size
        pieces = [normal_init(g, part, scale=scale, dtype=dtype) for g in self.gens]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)


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
                  dtype, shared_of: Callable = lambda gen: gen) -> dict:
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
        params["shared_attn"] = B.init_block(cfg, shared_of(gen), dtype=dtype)
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


# ------------------------------------------------------- sharding layout --

STAGE_AXIS, DATA_AXIS = "model", "data"  # the reference's mesh axis names


def _split_rule(top: str, expert: bool, dims: tuple, topo: Topology) -> int | None:
    """The dim of a leaf (after its stacking dims) that the data axis
    splits, or None: the reference's ``param_layout`` rule. A block's
    expert leaf whenever ``data`` > 1 (its expert dim); under ``zero3`` a
    block or shared-block leaf of two or more dims whose first divides."""
    if topo.data <= 1 or top not in ("blocks", "shared_attn"):
        return None
    if expert and top == "blocks":
        return 0
    if topo.zero3 and len(dims) >= 2 and dims[0] % topo.data == 0:
        return 0
    return None


def _with_paths(fn: Callable, tree, path=()):
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, (*path, k)) for k, v in tree.items()}
    return fn(path, tree)


def _is_expert(path) -> bool:
    return any(n.startswith("we_") for n in path)


def param_layout(cfg: ArchConfig, params_shapes: dict, topo: Topology) -> tuple[dict, dict]:
    """-> (spec tree, ZeRO-3 gather-mask tree): the reference's
    ``param_layout`` (``repro/models/transformer/model.py:190``) over a
    tree of ``init_params``' shapes (``abstract_params``). A spec is the
    tuple of mesh axis names (``"model"``, ``"data"``) or None, one per
    dim, as the reference's ``PartitionSpec``; the mask is True where a
    leaf is gathered before its layer runs (the split non-expert leaves).
    Expert leaves stay split over the data axis (expert parallelism);
    ``embed``, ``head``, ``final_ln`` and ``mtp_proj`` are replicated."""

    def spec(path, leaf):
        top, shape = path[0], tuple(leaf.shape)
        if top in ("embed", "head", "final_ln", "mtp_proj"):
            return (None,) * len(shape)
        if top == "shared_attn":
            dim = _split_rule(top, False, shape, topo)
            return tuple(DATA_AXIS if i == dim else None for i in range(len(shape)))
        dims = shape[2:]
        dim = _split_rule(top, _is_expert(path), dims, topo)
        return (STAGE_AXIS, None, *(DATA_AXIS if i == dim else None for i in range(len(dims))))

    def gather(path, leaf):
        top = path[0]
        if top not in ("blocks", "shared_attn") or _is_expert(path):
            return False
        dims = tuple(leaf.shape) if top == "shared_attn" else tuple(leaf.shape[2:])
        return _split_rule(top, False, dims, topo) is not None

    return _with_paths(spec, params_shapes), _with_paths(gather, params_shapes)


def moment_specs(cfg: ArchConfig, params_shapes: dict, topo: Topology) -> dict:
    """Adam's moments' specs: the params', but the replicated ``embed`` and
    ``head`` moments ZeRO-1-split over the data axis (``embed`` on its
    vocab dim, else on ``d_model``; ``head`` on its vocab dim), as the
    reference's ``moment_specs``."""
    specs, _ = param_layout(cfg, params_shapes, topo)
    if topo.data <= 1:
        return specs
    out = dict(specs)
    vocab, d = cfg.vocab_size, cfg.d_model
    if "embed" in out and vocab % topo.data == 0:
        out["embed"] = (DATA_AXIS, None)
    elif "embed" in out and d % topo.data == 0:
        out["embed"] = (None, DATA_AXIS)
    if "head" in out and vocab % topo.data == 0:
        out["head"] = (None, DATA_AXIS)
    return out


def _split_dims(specs: dict) -> dict:
    """Each leaf's data-split dim, or None where it is whole on every replica."""
    return _with_paths(lambda _, sp: sp.index(DATA_AXIS) if DATA_AXIS in sp else None, specs)


@dataclasses.dataclass
class LeafLayout:
    """Where a step's leaves live on the data axis: ``params`` and
    ``moments``, trees of each leaf's split dim (None: whole on every
    replica); ``gather``, the ZeRO-3 mask (``param_layout``)."""

    params: dict
    moments: dict
    gather: dict


@functools.lru_cache(maxsize=64)
def leaf_layout(cfg: ArchConfig, topo: Topology) -> LeafLayout:
    """The data-axis layout of ``init_params``' tree under ``topo``
    (``param_layout`` and ``moment_specs`` over ``abstract_params``)."""
    shapes = abstract_params(cfg, topo.num_stages)
    specs, gather = param_layout(cfg, shapes, topo)
    return LeafLayout(_split_dims(specs), _split_dims(moment_specs(cfg, shapes, topo)), gather)


def _layout(cfg: ArchConfig, topo: Topology, params: dict) -> LeafLayout:
    """``leaf_layout``, or without a data axis every leaf of ``params``
    whole (no meta build of the tree)."""
    if topo.data > 1:
        return leaf_layout(cfg, topo)
    whole = opt_lib.tree_map(lambda _: None, params)
    return LeafLayout(whole, whole, opt_lib.tree_map(lambda _: False, params))


def _cut(a: torch.Tensor, dim, size: int, r: int) -> torch.Tensor:
    """Data shard r of ``a`` along ``dim`` (``a`` itself when None)."""
    if dim is None or size == 1:
        return a
    n = a.shape[dim] // size
    return a.narrow(dim, r * n, n)


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


def grid_shard(tree: dict, cfg: ArchConfig, topo: "Topology", position: int, data_rank: int,
               moments: bool = False) -> dict:
    """One rank's copy of a full parameter tree (Adam's moments with
    ``moments``): ``position_shard``'s rows, then its data shard of every
    leaf the layout splits (``param_layout``, ``moment_specs``)."""
    layout = leaf_layout(cfg, topo)
    dims = layout.moments if moments else layout.params
    part = position_shard(tree, topo, position)
    return opt_lib.tree_map(lambda a, d: _cut(a, d, topo.data, data_rank).clone(), part, dims)


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


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, dtype=torch.float32) -> dict:
    """{name: (shape, dtype)} of one step's input batch: decode ``tokens``
    (B,) and ``pos``; prefill ``tokens`` (B, S - s_front); train ``tokens``
    (B, S - s_front + 1), the last column the labels' shift; on a frontend
    arch also ``frontend_embeds`` (B, s_front, d) in ``dtype`` (the
    params'), s_front = ``frontend_rows(cfg, S)``. The reference's spec
    of the frontend rows is bfloat16 at its default dtype (and at float32
    too); the step casts them to the activations' dtype either way."""
    bsz, seq = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((bsz,), torch.int32), "pos": ((), torch.int32)}
    s_front = frontend_rows(cfg, seq)
    specs = {"tokens": ((bsz, seq - s_front + (1 if shape.kind == "train" else 0)), torch.int32)}
    if cfg.frontend != "none":
        specs["frontend_embeds"] = ((bsz, s_front, cfg.d_model), dtype)
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
    """Static cache geometry (the reference's ``cache_plan``): micro-batch
    rows of the whole batch and ring width (decode: seq_len + 16 slots, or
    with ``topo.long_context`` the largest window of
    ``layer_windows(long_context=True)``, 0 for an SSM, split over the data
    axis into ``w_local = w_total / data`` when ``topo.seq_shard``;
    prefill: seq_len)."""
    b_mb = max(shape.global_batch // topo.num_micro, 1)
    if shape.kind != "decode":
        w = shape.seq_len
    elif topo.long_context:
        w = max(cfg.layer_windows(long_context=True)) if cfg.arch_type != "ssm" else 0
    else:
        w = shape.seq_len + 16
    w_local = w // topo.data if topo.seq_shard else w
    return {"b_mb": b_mb, "w_total": w, "w_local": w_local, "nm": topo.num_micro}


def init_cache(cfg: ArchConfig, topo: Topology, shape: ShapeConfig, *,
               dtype=torch.float32, device="cpu") -> dict:
    """A zero cache: leaves (num_stages, num_micro, slots, b_mb, ...), the
    layout of ``abstract_cache``; on a rank (``topo.ring``) only its own
    stage's row, (1, num_micro, slots, b_mb, ...), and with a data or pod
    axis its replica's rows of each micro-batch (``b_mb / (pods · data)``),
    or under ``topo.seq_shard`` its ``w_local`` ring slots (a long-context
    decode's one row on every pod)."""
    check_supported(cfg)
    check_topology(cfg, topo)
    plan = cache_plan(cfg, topo, shape)
    sp = stacked_shape_plan(cfg, topo.num_stages)
    rows = topo.num_stages if topo.ring is None else 1
    b, w = plan["b_mb"], plan["w_local"]
    if topo.seq_shard:
        if plan["w_total"] % topo.data:
            raise ValueError(f"a ring of {plan['w_total']} slots does not split over a data "
                             f"axis of {topo.data}")
        w = w if topo.ring is not None else plan["w_total"]
    split = topo.data * topo.pods if shape.global_batch > 1 else 1  # a row of one: replicated
    if not topo.seq_shard and split > 1:
        if b % split:
            raise ValueError(f"micro-batches of {b} rows do not split over {split} "
                             "(pod, data) replicas")
        b = b // split if topo.ring is not None else b

    def build(one: dict, slots: int) -> dict:
        lead = (rows, plan["nm"], slots)
        return {k: torch.zeros((*lead, *v.shape), dtype=v.dtype, device=device)
                for k, v in one.items()}

    mamba = lambda: B.init_mamba_cache(cfg, b, dtype=dtype, device="meta")
    attn = lambda: B.init_attn_cache(cfg, b, w, dtype=dtype, device="meta")
    if cfg.arch_type == "hybrid":
        return {"mamba": build(mamba(), sp["mamba_per_stage"]),
                "attn": build(attn(), sp["attn_per_stage"])}
    return build(mamba() if cfg.arch_type == "ssm" else attn(), sp["per_stage"])


# ------------------------------------------------------------- replicas --
#
# A step runs the replicas of the data axis this process holds
# (``DataGroup.local``): every one in one process, its own on a rank. Its
# stage functions take and return lists with one entry per local replica;
# the ring executors pass a list in one process (a hop hands it over) and
# a rank's one tensor between ranks (``_pack``/``_unpack``).


def _pack(ring: StageRing, xs: list):
    return xs if ring.grid is None else xs[0]


def _unpack(ring: StageRing, h) -> list:
    return h if ring.grid is None else [h]


def _own(a: torch.Tensor, dim, group: DataGroup, r: int) -> torch.Tensor:
    """Replica r's rows of a leaf this process holds: its data shard in one
    process (the whole leaf on a rank, which holds only its own)."""
    return a if group.grid is not None else _cut(a, dim, group.size, r)


def _replica_views(tree: dict, splits: dict, group: DataGroup) -> list:
    """Each local replica's view of a tree: its rows of every split leaf,
    every other leaf whole."""
    return [opt_lib.tree_map(lambda a, d: _own(a, d, group, r), tree, splits)
            for r in group.local]


def _gathered_params(trees: list, mask, group: DataGroup) -> list:
    """ZeRO-3: each local replica's tree with every leaf of ``mask``
    gathered over the data axis (``DataGroup.gather``: its backward is the
    reduce-scatter of the gradient), just before the layer runs."""
    if group.size == 1:
        return trees
    if isinstance(mask, dict):
        parts = {k: _gathered_params([t[k] for t in trees], v, group) for k, v in mask.items()}
        return [{k: parts[k][j] for k in mask} for j in range(len(trees))]
    return group.gather(trees) if mask else trees


def _slot_dims(splits: dict) -> dict:
    """Split dims of a stacked ``blocks`` tree, in one slot's coordinates."""
    return opt_lib.tree_map(lambda d: None if d is None else d - 2, splits)


def _cache_views(cache: dict, topo: Topology, group: DataGroup,
                 same_rows: bool = False) -> list:
    """Each local replica's view of one (stage, micro-batch) cache (leaves
    (slots, b_mb, ...)): its rows of the micro-batch, or under
    ``seq_shard`` its ring slots of the attention leaves (the mamba state,
    the same on every replica, whole); with ``same_rows`` (a batch of one)
    the whole cache, every replica's."""
    if group.grid is not None or group.size == 1:
        return [cache]
    if same_rows and not topo.seq_shard:
        return [cache] * len(group.local)

    def view(path, a, r):
        if not topo.seq_shard:
            return _cut(a, 1, group.size, r)
        return _cut(a, 2, group.size, r) if path[-1] in ("k", "v", "ckv") else a

    return [_with_paths(lambda path, a: view(path, a, r), cache) for r in group.local]


def _replica_batches(batch: dict, group: DataGroup, replicated: bool = False) -> list:
    """Each local replica's batch: rows ``[r·b_local, (r+1)·b_local)`` of
    every batched leaf (the reference's ``P(data)`` on dim 0), or the whole
    batch when ``replicated``."""
    if replicated or group.size == 1:
        return [batch] * len(group.local)
    b = batch["tokens"].shape[0]
    if b % group.size:
        raise ValueError(f"a batch of {b} rows does not split over a data axis of {group.size}")
    n = b // group.size
    rows = lambda v, r: v[r * n:(r + 1) * n] if torch.is_tensor(v) and v.dim() else v
    return [{k: rows(v, r) for k, v in batch.items()} for r in group.local]


def _data_axis(topo: Topology, group: DataGroup, mode: str,
               same_rows: bool = False) -> "B.DataAxis | None":
    """How a step's blocks reach over the data axis (None without one).
    ``same_rows``: a batch of one row, which every replica holds (the
    reference shards no batch of one), as under the sequence-split decode."""
    if group.size == 1:
        return None
    seq = mode == "decode" and topo.seq_shard
    same = seq or same_rows
    return B.DataAxis(group, "replicated" if same else topo.moe_mode, seq, same)


# ---------------------------------------------------------------- stages --


def _stage_fn(cfg: ArchConfig, topo: Topology, extras: dict, blocks: Callable,
              shared: Callable | None, mode: str, *, positions=None, cur_pos=None,
              data: "B.DataAxis | None" = None, remat: bool = False) -> Callable:
    """``stage(s, hs, caches) -> hs``: stage ``s``'s layer slots over one
    micro-batch of every local replica: ``hs`` a list of activations,
    ``caches`` a list of the replicas' (stage, micro-batch) cache views,
    leaves (slots, ...), written in place (None when training).
    ``blocks(s, i)`` gives slot i's params, one tree per replica, ZeRO-3
    gathered where it is called. On a hybrid, groups of mamba slots, each
    followed by one application of the weight-shared attention block
    ``shared(s)``, gathered for each application (``_hybrid_stage`` of the
    JAX model). With ``remat`` each layer (a slot, or an application of the
    shared block) runs under ``torch.utils.checkpoint`` with its gather
    inside: the forward keeps only the layer's input, and the backward
    gathers and recomputes one layer at a time, so a layer's gathered
    weights live only until its own backward. Under ``data.seq_shard``
    (and for any batch of one row: ``data.same_rows``) every replica holds
    the same rows, and one process runs a mamba slot once for all of them
    (their state is one)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    slot = lambda caches, i: None if caches is None else [_slot(c, i) for c in caches]

    def layer(fn, hs):
        return checkpoint(fn, hs, use_reentrant=False) if remat else fn(hs)

    def attn(lps, ex, hs, cs):
        if mode == "train":
            return B.block_train_all(cfg, lps, ex, hs, positions=positions,
                                     kv_block=topo.kv_block, data=data)
        if mode == "prefill":
            return B.block_prefill_all(cfg, lps, ex, hs, cs, positions=positions,
                                       kv_block=topo.kv_block, data=data)
        return B.block_decode_all(cfg, lps, ex, hs, cs, cur_pos=cur_pos, data=data)

    def mamba(lps, ex, hs, cs):
        def run(lp, h, c):
            if mode == "train":
                return B.mamba_block_train(cfg, lp, ex, h)
            fn = B.mamba_block_prefill if mode == "prefill" else B.mamba_block_decode
            return fn(cfg, lp, ex, h, c)[0]

        cs = [None] * len(hs) if cs is None else cs
        if data is not None and data.same_rows and len(hs) > 1:
            return [run(lps[0], hs[0], cs[0])] * len(hs)
        return [run(lp, h, c) for lp, h, c in zip(lps, hs, cs)]

    if cfg.arch_type != "hybrid":
        block = mamba if cfg.arch_type == "ssm" else attn

        def stage(s, hs, caches):
            def one(i):
                return lambda hs: block(blocks(s, i), _slot_extras(extras, s, i), hs,
                                        slot(caches, i))

            for i in range(extras["active"].shape[1]):
                hs = layer(one(i), hs)
            return hs

        return stage

    m_ex, a_ex = extras["mamba"], extras["attn"]
    n_attn = a_ex["active"].shape[1]
    m_grp = m_ex["active"].shape[1] // max(n_attn, 1)

    def hybrid_stage(s, hs, caches):
        def one_mamba(j):
            return lambda hs: mamba(blocks(s, j), _slot_extras(m_ex, s, j), hs,
                                    None if caches is None else [_slot(c["mamba"], j)
                                                                 for c in caches])

        def one_shared(g):
            return lambda hs: attn(shared(s), _slot_extras(a_ex, s, g), hs,
                                   None if caches is None else [_slot(c["attn"], g)
                                                                for c in caches])

        for g in range(max(n_attn, 1)):
            for j in range(g * m_grp, (g + 1) * m_grp):
                hs = layer(one_mamba(j), hs)
            if n_attn:
                hs = layer(one_shared(g), hs)
        return hs

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


def _micro_inputs(ring: StageRing, topo: Topology, xs: list) -> list:
    """The ring's inputs: per micro-batch, every local replica's rows."""
    split = [_micro_split(x, topo) for x in xs]
    return [_pack(ring, [sp[m] for sp in split]) for m in range(topo.num_micro)]


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
    of this replica's ring (a broadcast over its stage group; in one
    process, the value itself)."""
    if ring.grid is None:
        return value
    import torch.distributed as dist

    buf = value.contiguous() if value is not None else torch.empty(shape, dtype=dtype,
                                                                    device=device)
    dist.broadcast(buf, src=ring.grid.rank_at(ring.last), group=ring.grid.stage_group)
    return buf


def _outputs(ring: StageRing, topo: Topology, outs: dict, pick: Callable = lambda y: y) -> list:
    """Each local replica's rows of the last stage's outputs, where they
    are made (``pick`` of each micro-batch's, concatenated)."""
    per_micro = [_unpack(ring, outs[m]) for m in range(topo.num_micro)]
    return [torch.cat([pick(ys[j]) for ys in per_micro]) for j in range(len(per_micro[0]))]


def _last_rows(ring: StageRing, topo: Topology, outs: dict, pick: Callable, shape, dtype,
               device) -> list:
    """``_outputs`` on every position: broadcast from the last stage's over
    each replica's ring."""
    if ring.grid is None:
        return _outputs(ring, topo, outs, pick)
    y = _outputs(ring, topo, outs, pick)[0] if outs else None
    return [_from_last(ring, y, shape, dtype, device)]


def _gathered(grid, value: torch.Tensor) -> list:
    """Every ring position's ``value``, in position order (an all-gather
    over this replica's stage group)."""
    import torch.distributed as dist

    got = [torch.empty_like(value) for _ in range(grid.D)]
    dist.all_gather(got, value, group=grid.stage_group)
    row = sorted(grid.rows[grid.row])  # the group's ranks, in group order
    return [got[row.index(grid.rank_at(d))] for d in range(grid.D)]


def _flat(tree: dict) -> torch.Tensor:
    return torch.cat([a.reshape(-1) for a in opt_lib.tree_leaves(tree)])


def _unflat(tree: dict, flat: torch.Tensor) -> dict:
    """``flat`` cut into views shaped as ``tree``'s leaves."""
    it, off = [], 0
    for a in opt_lib.tree_leaves(tree):
        it.append(flat[off:off + a.numel()].view_as(a))
        off += a.numel()
    it.reverse()
    return opt_lib.tree_map(lambda _: it.pop(), tree)


def _sum_over_data(pending: list, group: DataGroup) -> None:
    """Each ``(dst, parts)``: ``dst`` becomes the ordered sum over the
    data axis of the replicas' gradients ``parts`` (this process's)."""
    if group.size == 1:
        return
    for dst, parts in pending:
        dst.copy_(group.sum(parts)[0])


def _sum_over_pods(trees: list, layout: LeafLayout, pods: DataGroup) -> dict:
    """The ordered sum across pods of each local pod's gradient tree, into
    the first: in one process over the pods' trees, on a rank over the
    tree of every pod's rank at its (replica, position) (an all-gather,
    then the sum). A rank sums only the rows its update reads of a ZeRO-1
    leaf (``embed``/``head``: its own moment rows)."""
    grid = pods.grid

    def one(d_param, d_moment, *gs):
        if grid is not None and d_moment is not None and d_moment != d_param:
            gs = [_cut(g, d_moment, grid.dp, grid.replica) for g in gs]
        gs[0].copy_(pods.sum(list(gs))[0])

    opt_lib.tree_map(one, layout.params, layout.moments, *trees)
    return trees[0]


def _moments_init(params: dict, layout: LeafLayout, group: DataGroup) -> "opt_lib.AdamState":
    """Adam's zero state: float32 moments shaped as ``params``, but on a
    rank the ZeRO-1-split ``embed``/``head`` moments its own rows only."""

    def zeros(p, d_param, d_moment):
        shape = list(p.shape)
        if group.grid is not None and d_moment is not None and d_moment != d_param:
            shape[d_moment] //= group.size
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    device = params["embed"].device
    return opt_lib.AdamState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=opt_lib.tree_map(zeros, params, layout.params, layout.moments),
        nu=opt_lib.tree_map(zeros, params, layout.params, layout.moments),
    )


def _apply_adam(optimizer, grads: dict, state, params: dict, layout: LeafLayout,
                group: DataGroup) -> None:
    """Adam in place over this process's leaves. On a rank of a data axis a
    ZeRO-1 leaf (``embed``/``head``: whole params, split moments) updates
    its own rows, which are then all-gathered back into the whole leaf;
    every other leaf is this rank's alone. Element by element the update is
    the one-process step's over the whole tree."""
    if group.grid is None or group.size == 1:
        optimizer.apply_(opt_lib.tree_leaves(grads), state, params)
        return
    r, size = group.local[0], group.size
    ps, gs, regather = [], [], []
    for p, g, d_param, d_moment in zip(*(opt_lib.tree_leaves(t) for t in (
            params, grads, layout.params, layout.moments))):
        if d_moment is not None and d_moment != d_param:
            ps.append(_cut(p, d_moment, size, r))
            gs.append(_cut(g, d_moment, size, r))
            regather.append((p, d_moment))
        else:
            ps.append(p)
            gs.append(g)
    optimizer.apply_(gs, opt_lib.AdamState(state.step, opt_lib.tree_leaves(state.mu),
                                           opt_lib.tree_leaves(state.nu)), ps)
    for p, dim in regather:
        p.copy_(group.concat([_cut(p, dim, size, r)], dim)[0])


# ------------------------------------------------------------ step fns --


def make_train_step(cfg: ArchConfig, topo: Topology, shape: ShapeConfig, *,
                    lr: float = 1e-4) -> Callable:
    """One training step: ``step(params, opt_state, {"tokens": (B, S+1)}) ->
    (params, opt_state, {"loss": 0-d tensor})``. Embed, the stage ring over
    ``num_micro`` micro-batches (``spmd_pipeline`` or
    ``spmd_pipeline_interleaved``; each layer of a (stage, micro-batch)
    under ``torch.utils.checkpoint`` when ``topo.remat``), the masked mean
    next-token loss over ``loss_chunks`` chunks along the minor batch dim
    (each checkpointed), then the backward pipeline
    (``spmd_pipeline_backward``: the ticks in reverse, one autograd pass per
    (stage, micro-batch)), the gradients of every parameter (zeros for a
    skipped slot), and one Adam update (``optimizer.adam(lr)``, the
    reference's defaults) applied to ``params`` and ``opt_state`` in place.

    Each layer slot of each stage (and, on the hybrid, each stage's use of
    the shared attention block) is an autograd leaf of its own, whose
    gradient sums its micro-batches C-1 down to 0 in place; the shared
    block's per-stage gradients are then summed in ascending stage order.
    With ``topo.ring`` the same step runs on each rank over its own rows:
    the last position computes the loss and broadcasts it, the replicated
    leaves' gradients (``embed``, ``final_ln``, ``head``, ``mtp_proj``:
    nonzero only where used) are summed over the ring, the shared block's
    gathered, and every rank applies Adam to its own tree — bit for bit the
    one-process step's numbers.

    With ``topo.data`` > 1 every replica runs its rows of the batch through
    the ring: the loss is the masked mean over the whole batch (each
    replica's (sum, count) summed over the data axis before the backward,
    so every gradient is the global mean's), a ZeRO-3-split leaf is
    gathered where its layer runs and its gradient reduce-scattered there,
    the gradients of the leaves whole on every replica are summed over the
    data axis, and Adam updates each replica's shards (``embed``/``head``:
    its ZeRO-1 rows, then all-gathered). Every sum over replicas runs in
    ascending replica order (``core.data_group``). ``step.optimizer`` is
    the optimizer, its ``init`` the moments in the layout of
    ``moment_specs``; ``step.loss(params, batch)`` the step's loss without
    the update."""
    check_supported(cfg)
    check_topology(cfg, topo)
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
    group = DataGroup(topo.data, topo.ring)
    data = _data_axis(topo, group, "train")
    if topo.data > 1:
        leaf_layout(cfg, topo)  # built once, here
    seq = shape.seq_len
    nm = topo.num_micro
    extras = make_extras(cfg, topo.num_stages)
    base = opt_lib.adam(lr)
    optimizer = base._replace(
        init=lambda params: _moments_init(params, _layout(cfg, topo, params), group))
    want = {name: spec[0] for name, spec in batch_specs(cfg, shape).items()}
    held = [k for d in ring.positions for k in ring.stages(d)]
    last = ring.holds(ring.K - 1)
    wire = (shape.global_batch // (topo.pods * topo.data) // nm, seq, cfg.d_model)
    pods = DataGroup(topo.pods, topo.ring, axis="pod")

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

    def head_sums(params, y, batch):
        """(loss sum, count) over one replica's rows of the batch from the
        last stage's output."""
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
        return total, count

    def mean_loss(sums, denom=None):
        """(each replica's share of the global mean loss, the loss sum over
        the data axis, the count): its sum over the count summed over the
        data axis, or over ``denom`` (the whole batch's, with pods)."""
        if denom is None:
            denom = torch.clamp(group.sum([c.detach() for _, c in sums])[0], min=1.0)
        total = group.sum([s.detach() for s, _ in sums])[0]
        return [s / denom for s, _ in sums], total, denom

    def forward(top_trees, blocks, shared, batches, fwd, remat=False):
        """Embed on stage 0's position and run the ring; ``fwd(stage, k, m,
        h)`` runs one item. Returns (each replica's x, {m: the last stage's
        output})."""
        embed = top_trees[0]["embed"]
        positions = make_positions(cfg, seq, device=embed.device)
        stage = _stage_fn(cfg, topo, extras, blocks, shared, "train", positions=positions,
                          data=data, remat=remat)
        xs = inputs = None
        if ring.holds(0):
            # frontend rows, where there are any, split into micro-batches with x
            xs = [embed_inputs(cfg, t, dict(b, tokens=b["tokens"][:, :-1]))
                  for t, b in zip(top_trees, batches)]
            inputs = _micro_inputs(ring, topo, xs)
        outs = spmd_pipeline_interleaved(lambda k, m, h: fwd(stage, k, m, h), inputs, ring,
                                         wire_shape=wire, dtype=embed.dtype, device=embed.device)
        return xs, outs

    def loss_fn(params, batch):
        _check_rows(ring, params["blocks"], "params['blocks']")
        blocks, shared = _serve_params(cfg, topo, group, ring, params)
        run = lambda st, k, m, h: _pack(ring, st(k, _unpack(ring, h), None))
        denom = None if topo.pods == 1 else _count(batch)
        totals = []
        for pod_batch in _replica_batches(batch, pods):
            batches = _replica_batches(pod_batch, group)
            _, outs = forward([params] * len(group.local), blocks, shared, batches, run)
            if last:
                ys = _outputs(ring, topo, outs)
                _, total, denom = mean_loss([head_sums(params, y, b)
                                             for y, b in zip(ys, batches)], denom)
                totals.append(total)
        loss = _pod_loss(totals, denom) if last else None
        return _from_last(ring, loss, (), torch.float32, params["embed"].device)

    def _pod_loss(totals, denom):
        """The mean loss from each local pod's loss sum (one pod: its own)."""
        return (totals[0] if topo.pods == 1 else pods.sum(totals)[0]) / denom

    def _count(batch):
        """The whole batch's loss count (its mask's sum: a function of the
        batch's shape), clamped as ``mean_loss``'s."""
        return torch.clamp(labels_from_batch(batch, seq)[1].sum(), min=1.0)

    def train_step(params: dict, opt_state, batch: dict):
        got = {name: tuple(batch[name].shape) for name in want if name in batch}
        if got != want:
            raise ValueError(f"batch of shapes {got}, step built for {want}")
        _check_rows(ring, params["blocks"], "params['blocks']")
        layout = _layout(cfg, topo, params)
        if topo.pods == 1:
            grads, total, denom = pod_grads(params, batch, layout)
            totals = [total]
        else:
            # every pod's gradients of the whole batch's mean loss (its count
            # a function of the batch's shape alone), summed across pods in
            # ascending pod order; the same update in every pod
            denom = _count(batch)
            parts = [pod_grads(params, b, layout, denom)
                     for b in _replica_batches(batch, pods)]
            grads = _sum_over_pods([g for g, _, _ in parts], layout, pods)
            totals = [t for _, t, _ in parts]
            del parts
        loss = _pod_loss(totals, denom) if last else None
        loss = _from_last(ring, loss, (), torch.float32, params["embed"].device)
        _apply_adam(optimizer, grads, opt_state, params, layout, group)
        return params, opt_state, {"loss": loss}

    def pod_grads(params: dict, batch: dict, layout: LeafLayout, denom=None):
        """One pod's pass over its rows of the batch: (the gradients, the
        loss sum over the data axis and the count where the loss is made;
        None elsewhere)."""
        slot_dims = _slot_dims(layout.params["blocks"])
        slot_gather = layout.gather["blocks"]
        shared_dims = layout.params.get("shared_attn")
        shared_gather = layout.gather.get("shared_attn")
        tops = [k for k in params if k not in ("blocks", "shared_attn")]
        batches = _replica_batches(batch, group)
        grads = opt_lib.tree_map(torch.zeros_like, params)
        L = len(group.local)
        pending = []  # (gradient, replicas' parts) to sum over the data axis

        def leaf(p, g):
            # an autograd leaf over p whose gradient accumulates into g in place
            out = p.detach().requires_grad_(True)
            out.grad = g
            return out

        def own_leaves(ptree, gtree, dims) -> list:
            """Per local replica, a tree of leaves over its rows of each
            split leaf (gradient: its rows of ``gtree``); a leaf whole on
            every replica gets a gradient of its own per replica (in one
            process), summed over the data axis after the backward."""
            def one(p, g, d):
                if d is not None:
                    return tuple(leaf(_own(p, d, group, r), _own(g, d, group, r))
                                 for r in group.local)
                out = replicas_of(p, g)
                pending.append((g, [o.grad for o in out]))
                return out

            per = opt_lib.tree_map(one, ptree, gtree, dims)
            return [opt_lib.tree_map(lambda t: t[j], per) for j in range(L)]

        def replicas_of(p, g):
            # one leaf per local replica: the first's gradient is g, the
            # others' their own until they are summed into it
            return (leaf(p, g), *(leaf(p, torch.zeros_like(p)) for _ in range(L - 1)))

        top_leaves = [{} for _ in range(L)]
        for k in tops:
            parts = replicas_of(params[k], grads[k])
            for j in range(L):
                top_leaves[j][k] = parts[j]
        # one leaf per (stage, slot), its gradient a view of its row of grads:
        # each backward pass adds into it, and no pass stacks a stage's rows
        per = _stacked_slots(cfg, topo.num_stages)
        slots = {(k, i): own_leaves(_slot(params["blocks"], ring.row_of(k), i),
                                    _slot(grads["blocks"], ring.row_of(k), i), slot_dims)
                 for k in held for i in range(per)}
        blocks = lambda k, i: _gathered_params(slots[(k, i)], slot_gather, group)
        shared = aliases = None
        if "shared_attn" in params:
            # per stage a gradient of its own (the stages' sum runs in
            # ascending stage order), each replica its rows of a split leaf
            def alias(p, d):
                return tuple(leaf(q, torch.zeros_like(q))
                             for q in (_own(p, d, group, r) for r in group.local))

            aliases = {}
            for k in held:
                per_leaf = opt_lib.tree_map(alias, params["shared_attn"], shared_dims)
                aliases[k] = [opt_lib.tree_map(lambda t: t[j], per_leaf) for j in range(L)]
            shared = lambda k: _gathered_params(aliases[k], shared_gather, group)
        saved = {}

        def fwd(stage, k, m, h):
            hs = [x.detach().requires_grad_(True) for x in _unpack(ring, h)]
            ys = stage(k, hs, None)
            saved[(k, m)] = (hs, ys)
            return _pack(ring, [y.detach() for y in ys])

        xs, outs = forward(top_leaves, blocks, shared, batches, fwd, remat=topo.remat)
        total, cotangents = None, {}
        if last:
            ys = [[y.requires_grad_(True) for y in _unpack(ring, outs[m])] for m in range(nm)]
            sums = [head_sums(t, torch.cat([ys[m][j] for m in range(nm)]), b)
                    for j, (t, b) in enumerate(zip(top_leaves, batches))]
            shares, total, denom = mean_loss(sums, denom)
            torch.autograd.backward(shares)
            cotangents = {m: _pack(ring, [y.grad for y in ys[m]]) for m in range(nm)}
            del ys, sums, shares

        def bwd(k, m, g):
            hs, ys = saved.pop((k, m))
            torch.autograd.backward(ys, _unpack(ring, g))
            return _pack(ring, [h.grad for h in hs])

        d_x = spmd_pipeline_backward(bwd, cotangents, ring, wire_shape=wire,
                                     dtype=params["embed"].dtype, device=params["embed"].device)
        del cotangents, outs
        if xs is not None:
            torch.autograd.backward(xs, [torch.stack([_unpack(ring, d_x[m])[j] for m in range(nm)])
                                         .reshape(x.shape) for j, x in enumerate(xs)])
        del xs, d_x, slots
        if aliases is not None:
            _sum_shared(aliases, grads["shared_attn"], shared_dims, pending)
            del aliases, shared
        _sum_tops(top_leaves, grads, tops, layout)
        del top_leaves
        _sum_over_data(pending, group)
        del pending
        return grads, total, denom

    def _sum_shared(aliases, dst, shared_dims, pending):
        """The shared block's gradient: per replica its stages' gradients
        summed in ascending stage order (over the ring on ranks); a split
        leaf's into its rows, a whole one's then summed over the data axis."""
        per_rep = []
        for j in range(len(group.local)):
            parts = [_flat(opt_lib.tree_map(lambda a: a.grad, aliases[k][j])) for k in held]
            if ring.grid is not None:
                parts = _gathered(ring.grid, parts[0])
            per_rep.append(_unflat(aliases[held[0]][j], ordered_sum(parts)))

        def put(g, d, *parts):
            if d is None:
                if group.size == 1:
                    g.copy_(parts[0])
                else:
                    pending.append((g, list(parts)))
            else:
                for part, r in zip(parts, group.local):
                    _own(g, d, group, r).copy_(part)

        opt_lib.tree_map(put, dst, shared_dims, *per_rep)

    def _sum_tops(top_leaves, grads, tops, layout):
        """``embed``, ``final_ln``, ``head``, ``mtp_proj``: each replica's
        users' gradients (zeros elsewhere) summed over the ring, then over
        the data axis — a ZeRO-1 leaf only its own rows, which its update
        reads."""
        import torch.distributed as dist

        for k in tops:
            parts = [t[k].grad for t in top_leaves]
            if ring.grid is not None and ring.D > 1:
                dist.all_reduce(parts[0], group=ring.grid.stage_group)
            if group.size == 1:
                continue
            dim = layout.moments[k]
            if dim is None:
                grads[k].copy_(group.sum(parts)[0])
            else:
                for r, rows in zip(group.local, group.reduce_rows(parts, dim)):
                    _cut(grads[k], dim, group.size, r).copy_(rows)

    train_step.optimizer = optimizer
    train_step.loss = loss_fn
    return train_step


def _serve_ring(topo: Topology, params: dict, cache: dict) -> StageRing:
    ring = _ring(topo, serving=True)
    _check_rows(ring, params["blocks"], "params['blocks']")
    _check_rows(ring, cache, "the cache")
    return ring


def _serve_params(cfg: ArchConfig, topo: Topology, group: DataGroup, ring: StageRing,
                  params: dict):
    """(blocks(s, i), shared(s)) of a serving stage: each local replica's
    slot params, ZeRO-3 gathered where the stage calls them."""
    layout = _layout(cfg, topo, params)
    dims = _slot_dims(layout.params["blocks"])
    blocks = lambda s, i: _gathered_params(_replica_views(
        _slot(params["blocks"], ring.row_of(s), i), dims, group), layout.gather["blocks"], group)
    shared = None
    if "shared_attn" in params:
        shared = lambda s: _gathered_params(_replica_views(
            params["shared_attn"], layout.params["shared_attn"], group),
            layout.gather["shared_attn"], group)
    return blocks, shared


def _replica_logits(cfg: ArchConfig, topo: Topology, group: DataGroup, params: dict,
                    ys: list, replicated: bool) -> torch.Tensor:
    """The whole batch's logits from each local replica's final rows: the
    replicas' rows in replica order (an all-gather on ranks), or one
    replica's where every replica holds every row."""
    logits = [lm_head_logits(cfg, params, y) for y in ys]
    if replicated or group.size == 1:
        return logits[0]
    return group.concat(logits)[0]


def _over_pods(topo: Topology, run: Callable, cache: dict, batch: dict) -> torch.Tensor:
    """``run(cache, batch)``'s logits over every pod: each local pod's run
    over its rows of the batch and of the cache's micro-batches (in one
    process a view of them, on a rank its own cache), the logits
    concatenated in pod order (an all-gather over ``pod_group`` on a
    rank). A batch of one row (the long-context decode's) is every pod's:
    one run stands for all of them in one process, and each pod's rank
    runs its own."""
    if topo.pods == 1 or batch["tokens"].shape[0] == 1:
        return run(cache, batch)
    pods = DataGroup(topo.pods, topo.ring, axis="pod")
    caches = [cache] if pods.grid is not None else [
        opt_lib.tree_map(lambda a: _cut(a, 3, pods.size, p), cache) for p in pods.local]
    logits = [run(c, b) for c, b in zip(caches, _replica_batches(batch, pods))]
    return pods.concat(logits)[0]


def _prefill(cfg: ArchConfig, topo: Topology, extras: dict, params: dict, cache: dict,
             batch: dict, seq: int, positions: torch.Tensor | None = None):
    """The prefill of ``make_prefill_step``, at ``positions`` when given: a
    check's positions (the m-rope decode's own), of ``make_positions``'
    shape, whose mask row is checked here never to decrease, as the flash
    kernel needs (``make_positions``' never does, by construction)."""
    check_topology(cfg, topo)
    ring = _serve_ring(topo, params, cache)
    group = DataGroup(topo.data, topo.ring)
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
    blocks, shared = _serve_params(cfg, topo, group, ring, params)
    same = batch["tokens"].shape[0] == 1
    stage = _stage_fn(cfg, topo, extras, blocks, shared, "prefill", positions=positions,
                      data=_data_axis(topo, group, "prefill", same))

    def run(cache, batch):
        batches = _replica_batches(batch, group, replicated=same)
        # frontend rows, where there are any, split into micro-batches with x
        xs = _micro_inputs(ring, topo, [embed_inputs(cfg, params, b) for b in batches]) \
            if ring.holds(0) else None
        b_local = batches[0]["tokens"].shape[0]
        item = lambda s, m, h: _pack(ring, stage(s, _unpack(ring, h), _cache_views(
            _slot(cache, ring.row_of(s), m), topo, group, same)))
        outs = spmd_pipeline(item, xs, ring,
                             wire_shape=(b_local // topo.num_micro, seq, cfg.d_model),
                             dtype=embed.dtype, device=embed.device)
        ys = _last_rows(ring, topo, outs, lambda y: y[:, -1], (b_local, cfg.d_model),
                        embed.dtype, embed.device)
        return _replica_logits(cfg, topo, group, params, ys, replicated=same)

    return _over_pods(topo, run, cache, batch), cache


def make_prefill_step(cfg: ArchConfig, topo: Topology, shape: ShapeConfig) -> Callable:
    """Full-sequence prefill: ``step(params, cache, {"tokens": (B, S -
    s_front)[, "frontend_embeds": (B, s_front, d)]}) -> (last-token logits
    (B, V) float32, cache)``, the cache (from ``init_cache`` at ``shape``)
    filled in place. On ``topo.ring``'s ranks every rank passes the whole
    batch: position 0 embeds its replica's rows, each position fills its
    own cache rows, and the last position's final hidden rows are
    broadcast over the ring and all-gathered over the data axis, so every
    rank returns the whole batch's logits."""
    check_supported(cfg)
    seq = shape.seq_len
    extras = make_extras(cfg, topo.num_stages)
    if topo.data > 1:
        leaf_layout(cfg, topo)  # built once, here

    def prefill_step(params: dict, cache: dict, batch: dict):
        return _prefill(cfg, topo, extras, params, cache, batch, seq)

    return prefill_step


def make_serve_step(cfg: ArchConfig, topo: Topology, shape: ShapeConfig) -> Callable:
    """One decode step: ``step(params, cache, {"tokens": (B,), "pos": int})
    -> (next tokens (B,) int32, cache, logits (B, V) float32)``, the cache
    (from ``init_cache`` at ``shape``) updated in place at slot pos mod W.
    With ``topo.long_context`` every layer attends within its long-context
    window, over a ring that wraps at the largest (``cache_plan``); with a
    data axis too (``topo.seq_shard``) every replica decodes the whole
    batch over its share of the ring, and MoE runs ``replicated``. On
    ``topo.ring``'s ranks every rank passes the tokens, position 0 embeds
    its replica's, and the final hidden rows are broadcast over the ring
    (and all-gathered over the data axis), so every rank returns the next
    tokens and the logits of the whole batch."""
    check_supported(cfg)
    check_topology(cfg, topo)
    extras = make_extras(cfg, topo.num_stages, long_context=topo.long_context)
    group = DataGroup(topo.data, topo.ring)
    same = shape.global_batch == 1  # a batch of one: every replica's
    rep = topo.seq_shard or same
    data = _data_axis(topo, group, "decode", same)
    if topo.data > 1:
        leaf_layout(cfg, topo)  # built once, here

    def serve_step(params: dict, cache: dict, batch: dict):
        ring = _serve_ring(topo, params, cache)
        embed = params["embed"]
        blocks, shared = _serve_params(cfg, topo, group, ring, params)
        stage = _stage_fn(cfg, topo, extras, blocks, shared, "decode",
                          cur_pos=int(batch["pos"]), data=data)

        def run(cache, batch):
            batches = _replica_batches(batch, group, replicated=rep)
            xs = _micro_inputs(ring, topo, [embed[b["tokens"].long()][:, None, :]
                                            for b in batches]) \
                if ring.holds(0) else None  # (b, 1, d)
            b_local = batches[0]["tokens"].shape[0]
            item = lambda s, m, h: _pack(ring, stage(s, _unpack(ring, h), _cache_views(
                _slot(cache, ring.row_of(s), m), topo, group, same)))
            outs = spmd_pipeline(item, xs, ring,
                                 wire_shape=(b_local // topo.num_micro, 1, cfg.d_model),
                                 dtype=embed.dtype, device=embed.device)
            ys = _last_rows(ring, topo, outs, lambda y: y[:, 0], (b_local, cfg.d_model),
                            embed.dtype, embed.device)
            return _replica_logits(cfg, topo, group, params, ys, replicated=rep)

        logits = _over_pods(topo, run, cache, batch)
        return logits.argmax(dim=-1).to(torch.int32), cache, logits

    return serve_step
