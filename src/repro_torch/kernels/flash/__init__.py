"""Causal flash attention: one hand-written CUDA kernel (``csrc/flash.cu``),
its plain PyTorch version and the op."""
