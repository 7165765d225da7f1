"""gemma2-27b [dense] — local/global alternation + softcaps [arXiv:2408.00118].

46L, d_model=4608, 32 heads (head_dim 128), GQA kv=16, d_ff=36864 (GeGLU),
vocab=256000. Even layers use a 4096 sliding window; attention softcap 50,
final-logit softcap 30; sandwich (pre+post) RMSNorms.
"""

from repro_torch.configs.base import ArchConfig, register_arch


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b",
        arch_type="dense",
        source="arXiv:2408.00118",
        num_layers=46,
        d_model=4608,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256000,
        window_size=4096,
        window_pattern="alternate",
        attn_softcap=50.0,
        logit_softcap=30.0,
        sandwich_norms=True,
        mlp_kind="geglu",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b",
        arch_type="dense",
        source="arXiv:2408.00118",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        window_size=64,
        window_pattern="alternate",
        attn_softcap=50.0,
        logit_softcap=30.0,
        sandwich_norms=True,
        mlp_kind="geglu",
    )


register_arch(config, smoke)
