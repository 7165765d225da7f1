"""Fused GAT neighbor attention: one hand-written CUDA kernel for the padded
and the degree-bucketed layouts, its plain PyTorch versions and the ops."""
