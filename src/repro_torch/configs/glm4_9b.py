"""glm4-9b [dense] — RoPE + aggressive GQA [hf:THUDM/glm-4-9b].

40L, d_model=4096, 32 heads, GQA kv=2, d_ff=13696, vocab=151552.
GLM uses partial rotary (half the head dim) and QKV bias.
"""

from repro_torch.configs.base import ArchConfig, register_arch


def config() -> ArchConfig:
    return ArchConfig(
        name="glm4-9b",
        arch_type="dense",
        source="hf:THUDM/glm-4-9b",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=151552,
        qkv_bias=True,
        rope_theta=10_000.0,
        mlp_kind="swiglu",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="glm4-9b",
        arch_type="dense",
        source="hf:THUDM/glm-4-9b",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
        mlp_kind="swiglu",
    )


register_arch(config, smoke)
