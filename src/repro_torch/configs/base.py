"""Architecture + input-shape config system (a copy of ``repro.configs.base``).

One ``ArchConfig`` fully determines a model in ``repro_torch.models.transformer``;
one ``ShapeConfig`` is an assigned input shape. Every assigned architecture
registers itself (``register_arch``) with the exact public-literature
hyper-parameters plus a reduced ``smoke`` variant (≤2 layers, d_model ≤ 512,
≤4 experts) used by CPU smoke tests.

The dataclasses are framework-free and kept here as the port's own copy, so
the port never imports the JAX package; ``tests/test_torch_configs.py`` holds
every field, parameter count and layer window equal to the original's.

Layer heterogeneity (gemma2 local/global alternation, zamba2 shared-attention
interleave, deepseek dense-first-k) is encoded by ``layer_kinds()`` /
``layer_windows()`` — per-layer-slot lists that the model turns into
per-slot ``active``/``window`` extras.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

# ----------------------------------------------------------------- shapes --


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


# ------------------------------------------------------------------ archs --

LayerKind = str  # "attn" | "mamba" | "pad"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str  # citation bracket from the assignment
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention
    attn_kind: str = "gqa"  # "gqa" | "mla" | "none"
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_kind: str = "rope"  # "rope" | "mrope" | "none"
    window_size: int = 0  # 0 = all layers global
    window_pattern: str = "none"  # "none" | "alternate" (gemma2: even layers local)
    attn_softcap: float = 0.0  # gemma2: 50.0
    logit_softcap: float = 0.0  # gemma2: 30.0
    sandwich_norms: bool = False  # gemma2 pre+post norms

    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel
    router_kind: str = "softmax"  # "softmax" | "sigmoid" (deepseek v3)
    mtp: bool = False  # deepseek multi-token-prediction aux head

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    hybrid_attn_every: int = 0  # zamba2: shared attn block every k slots

    # misc
    mlp_kind: str = "swiglu"  # "swiglu" | "geglu" | "gelu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # modality frontend stub: extra precomputed-embedding inputs
    frontend: str = "none"  # "none" | "vision" | "audio"
    frontend_frac: float = 0.25  # fraction of seq filled by frontend embeds

    # sub-quadratic long-context variant (beyond-paper; auto-selected for
    # long_500k on archs without native sub-quadratic layers)
    long_context_window: int = 8_192

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---------------------------------------------------------- patterns --

    def layer_kinds(self) -> list[LayerKind]:
        """Per-layer block kind, before pipeline padding."""
        kinds: list[LayerKind] = []
        for i in range(self.num_layers):
            if self.arch_type == "ssm":
                kinds.append("mamba")
            elif self.arch_type == "hybrid":
                every = max(self.hybrid_attn_every, 1)
                kinds.append("attn" if (i % every) == (every - 1) else "mamba")
            else:
                kinds.append("attn")
        return kinds

    def layer_windows(self, *, long_context: bool = False) -> list[int]:
        """Per-layer sliding-window size; 0 = full/global attention."""
        wins: list[int] = []
        for i in range(self.num_layers):
            if self.window_pattern == "alternate":
                w = self.window_size if i % 2 == 0 else 0
            else:
                w = self.window_size
            if long_context and w == 0:
                # beyond-paper sliding-window fallback so long_500k lowers
                w = self.long_context_window
            wins.append(w)
        return wins

    def is_subquadratic(self) -> bool:
        """True if *every* layer is O(seq)-bounded natively (no fallback)."""
        if self.arch_type in ("ssm",):
            return True
        if self.arch_type == "hybrid":
            # mamba layers are O(1)/token; attention layers still need a
            # window for 500k unless we accept O(seq) per token (decode-only
            # cost is linear; we still window them — see DESIGN.md)
            return True
        return False

    # ------------------------------------------------------------- sizes --

    @property
    def moe_layers(self) -> int:
        return self.num_layers if self.num_experts else 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size  # head
        for kind in self.layer_kinds():
            n += 2 * d  # norms (approx; sandwich adds 2 more)
            if self.sandwich_norms:
                n += 2 * d
            if kind == "attn":
                n += self._attn_params()
                n += self._ffn_params()
            elif kind == "mamba":
                n += self._mamba_params()
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attn_kind == "mla":
            qk = self.qk_nope_head_dim + self.qk_rope_head_dim
            n = 0
            if self.q_lora_rank:
                n += d * self.q_lora_rank + self.q_lora_rank * self.num_heads * qk
            else:
                n += d * self.num_heads * qk
            n += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            n += self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
            n += self.num_heads * self.v_head_dim * d
            return n
        hd = self.head_dim
        n = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if self.qkv_bias:
            n += (self.num_heads + 2 * self.num_kv_heads) * hd
        return n

    def _ffn_params(self) -> int:
        d = self.d_model
        gates = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        if self.num_experts:
            expert = gates * d * self.d_ff
            n = self.num_experts * expert + self.num_shared_experts * expert
            n += d * self.num_experts  # router
            if self.moe_dense_residual:
                n += gates * d * self.d_ff
            return n
        return gates * d * self.d_ff

    def _mamba_params(self) -> int:
        d = self.d_model
        d_in = self.ssm_expand * d
        h = d_in // self.ssm_head_dim
        n_state = self.ssm_state
        n = 0
        n += d * (2 * d_in + 2 * n_state + h)  # in_proj (x, z, B, C, dt)
        n += self.ssm_conv_width * (d_in + 2 * n_state)  # depthwise conv
        n += h * 3  # A_log, dt_bias, D
        n += d_in  # gate norm
        n += d_in * d  # out_proj
        return n

    def active_param_count(self) -> int:
        """Active params per token (= param_count for dense)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        gates = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        expert = gates * d * self.d_ff
        inactive_per_layer = (self.num_experts - self.experts_per_token) * expert
        return self.param_count() - self.moe_layers * inactive_per_layer


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}
_SMOKE: dict[str, Callable[[], ArchConfig]] = {}


def register_arch(full: Callable[[], ArchConfig], smoke: Callable[[], ArchConfig]):
    cfg = full()
    _REGISTRY[cfg.name] = full
    _SMOKE[cfg.name] = smoke
    return full


def get_arch(name: str, *, smoke: bool = False) -> ArchConfig:
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def pipeline_padding(num_layers: int, num_stages: int) -> tuple[int, int]:
    """(layers_per_stage, pad_slots) for a stage count."""
    per = math.ceil(num_layers / num_stages)
    return per, per * num_stages - num_layers
