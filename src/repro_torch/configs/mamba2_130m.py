"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

24L, d_model=768, attention-free, ssm_state=128, expand 2 (d_inner 1536,
head_dim 64 → 24 ssm heads), vocab=50280. The only fully sub-quadratic
assigned arch — long_500k runs natively.
"""

from repro_torch.configs.base import ArchConfig, register_arch


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m",
        arch_type="ssm",
        source="arXiv:2405.21060",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        head_dim=1,
        d_ff=0,
        vocab_size=50280,
        attn_kind="none",
        rope_kind="none",
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        mlp_kind="swiglu",
        tie_embeddings=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m",
        arch_type="ssm",
        source="arXiv:2405.21060",
        num_layers=2,
        d_model=128,
        num_heads=0,
        num_kv_heads=0,
        head_dim=1,
        d_ff=0,
        vocab_size=512,
        attn_kind="none",
        rope_kind="none",
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=32,
        ssm_chunk=32,
        mlp_kind="swiglu",
        tie_embeddings=True,
    )


register_arch(config, smoke)
