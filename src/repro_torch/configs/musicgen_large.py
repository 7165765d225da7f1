"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

Transformer backbone only (assignment carve-out): the EnCodec conv codec is
a stub; ``input_specs`` provides precomputed frame embeddings for the audio
prompt portion of the sequence. 48L, d_model=2048, 32 heads (MHA, kv=32),
d_ff=8192 (GELU MLP, as in the paper's standard transformer), vocab=2048
(EnCodec codebook size).
"""

from repro_torch.configs.base import ArchConfig, register_arch


def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large",
        arch_type="audio",
        source="arXiv:2306.05284",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        mlp_kind="gelu",
        frontend="audio",
        frontend_frac=0.25,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large",
        arch_type="audio",
        source="arXiv:2306.05284",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=128,
        mlp_kind="gelu",
        frontend="audio",
        frontend_frac=0.25,
    )


register_arch(config, smoke)
