"""arctic-480b [moe] — dense-MoE hybrid: 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

35L, d_model=7168, 56 heads, GQA kv=8, expert d_ff=4864, vocab=32000.
Every layer runs a dense FFN residual IN PARALLEL with the top-2 MoE.
"""

from repro_torch.configs.base import ArchConfig, register_arch


def config() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b",
        arch_type="moe",
        source="hf:Snowflake/snowflake-arctic-base",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        num_experts=128,
        experts_per_token=2,
        moe_dense_residual=True,
        router_kind="softmax",
        mlp_kind="swiglu",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b",
        arch_type="moe",
        source="hf:Snowflake/snowflake-arctic-base",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=64,
        vocab_size=512,
        num_experts=4,
        experts_per_token=2,
        moe_dense_residual=True,
        router_kind="softmax",
        mlp_kind="swiglu",
    )


register_arch(config, smoke)
