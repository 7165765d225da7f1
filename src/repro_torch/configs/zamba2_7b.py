"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

81 layer slots, d_model=3584, ssm_state=64; a weight-SHARED attention block
(32 heads, GQA kv=32) is applied every 6th slot, mamba2 elsewhere. The
shared block's weights are passed as non-scanned captures through the
pipeline (DESIGN.md §6); mamba parameters at attention slots are inert.
"""

from repro_torch.configs.base import ArchConfig, register_arch


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        arch_type="hybrid",
        source="arXiv:2411.15242",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        hybrid_attn_every=6,
        mlp_kind="swiglu",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        arch_type="hybrid",
        source="arXiv:2411.15242",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=32,
        ssm_chunk=32,
        hybrid_attn_every=2,
        mlp_kind="swiglu",
    )


register_arch(config, smoke)
