"""Mamba2 SSD chunk scan: one hand-written CUDA kernel (``csrc/ssd.cu``), its
plain PyTorch version and the op."""
