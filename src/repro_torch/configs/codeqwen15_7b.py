"""codeqwen1.5-7b [dense] — qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B].

32L, d_model=4096, 32 heads (GQA kv=32 — effectively MHA), d_ff=13440,
vocab=92416, QKV bias (qwen1.5 family), rope.
"""

from repro_torch.configs.base import ArchConfig, register_arch


def config() -> ArchConfig:
    return ArchConfig(
        name="codeqwen1.5-7b",
        arch_type="dense",
        source="hf:Qwen/CodeQwen1.5-7B",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mlp_kind="swiglu",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="codeqwen1.5-7b",
        arch_type="dense",
        source="hf:Qwen/CodeQwen1.5-7B",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
        mlp_kind="swiglu",
    )


register_arch(config, smoke)
