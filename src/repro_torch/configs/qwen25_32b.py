"""qwen2.5-32b [dense] — GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B family card].

64L, d_model=5120, 40 heads, GQA kv=8, d_ff=27648, vocab=152064.
"""

from repro_torch.configs.base import ArchConfig, register_arch


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-32b",
        arch_type="dense",
        source="hf:Qwen/Qwen2.5-0.5B",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=27648,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mlp_kind="swiglu",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-32b",
        arch_type="dense",
        source="hf:Qwen/Qwen2.5-0.5B",
        num_layers=2,
        d_model=160,
        num_heads=5,
        num_kv_heads=1,
        d_ff=320,
        vocab_size=512,
        qkv_bias=True,
        mlp_kind="swiglu",
    )


register_arch(config, smoke)
