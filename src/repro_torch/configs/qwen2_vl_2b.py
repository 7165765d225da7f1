"""qwen2-vl-2b [vlm] — M-RoPE + dynamic resolution [arXiv:2409.12191].

Transformer backbone only (assignment carve-out): the ViT vision encoder +
projector is a stub; ``input_specs`` provides precomputed patch embeddings
occupying ``frontend_frac`` of the sequence. 28L, d_model=1536, 12 heads,
GQA kv=2, d_ff=8960, vocab=151936, M-RoPE (3-section rotary).
"""

from repro_torch.configs.base import ArchConfig, register_arch


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b",
        arch_type="vlm",
        source="arXiv:2409.12191",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        rope_kind="mrope",
        mlp_kind="swiglu",
        frontend="vision",
        frontend_frac=0.25,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b",
        arch_type="vlm",
        source="arXiv:2409.12191",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
        rope_kind="mrope",
        mlp_kind="swiglu",
        frontend="vision",
        frontend_frac=0.25,
    )


register_arch(config, smoke)
