"""deepseek-v3-671b [moe] — MLA + 1 shared/256 routed top-8 + MTP
[arXiv:2412.19437].

61L, d_model=7168, 128 heads MLA (kv_lora 512, q_lora 1536, nope 128 +
rope 64, v 128), expert d_ff=2048, vocab=129280, sigmoid router with top-8 of
256 routed experts + 1 shared expert. MTP implemented as an auxiliary
next-next-token head. Deviation from the HF card: the first-3-dense-layers
exception is dropped so layer slots stay homogeneous for the pipeline scan
(DESIGN.md §6).
"""

from repro_torch.configs.base import ArchConfig, register_arch


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        source="arXiv:2412.19437",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        d_ff=2048,
        vocab_size=129280,
        attn_kind="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        num_experts=256,
        experts_per_token=8,
        num_shared_experts=1,
        router_kind="sigmoid",
        mtp=True,
        mlp_kind="swiglu",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        source="arXiv:2412.19437",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=64,
        vocab_size=512,
        attn_kind="mla",
        q_lora_rank=48,
        kv_lora_rank=32,
        qk_nope_head_dim=32,
        qk_rope_head_dim=16,
        v_head_dim=32,
        num_experts=4,
        experts_per_token=2,
        num_shared_experts=1,
        router_kind="sigmoid",
        mtp=True,
        mlp_kind="swiglu",
    )


register_arch(config, smoke)
