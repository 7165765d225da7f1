"""Wrappers of the hand-written CUDA GAT aggregation kernel.

One kernel (``csrc/gat_edge.cu``) serves both TPU kernels it replaces:

* ``gat_aggregate_kernel`` — the padded layout (replaces
  ``repro/kernels/gat_edge/kernel.py`` ``gat_aggregate_kernel``, whose
  ``pallas_call`` is at ``:70``): rows are the graph's nodes, R = N.
* ``bucket_gat_kernel`` — one degree bucket (replaces ``bucket_gat_kernel``,
  ``pallas_call`` at ``:164``): R tile rows mapped to nodes by ``row_node``.

Both take the layer's own tensors — ``hw`` (N, H, F), ``s_src``/``s_dst``
(N, H) — and gather scores and feature rows inside the kernel. On CUDA
tensors they launch the kernel (and count the launch in ``.launches``); on
CPU tensors they return the plain version ``ref.gat_edge_ref``. Anything
else raises: a wrong device, dtype, shape or a non-contiguous tensor.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import takes_kernel
from repro_torch.kernels._build import BuiltLibrary, load_library
from repro_torch.kernels.gat_edge.ref import gat_edge_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "gat_edge.cu"


@functools.cache
def library() -> BuiltLibrary:
    """The built and loaded kernel library (compiled at the first call)."""
    built = load_library("gat_edge", [SOURCE])
    fn = built.lib.gat_edge_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return built


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")


def _launch(hw, s_src, s_dst, neighbors, mask, row_node, negative_slope):
    n, h, f = hw.shape
    r, w = neighbors.shape
    _check("hw", hw, torch.float32, (n, h, f))
    _check("s_src", s_src, torch.float32, (n, h))
    _check("s_dst", s_dst, torch.float32, (n, h))
    _check("neighbors", neighbors, torch.int32, (r, w))
    _check("mask", mask, torch.bool, (r, w))
    if row_node is not None:
        _check("row_node", row_node, torch.int32, (r,))
    if w < 1 or h < 1 or f < 1:
        raise ValueError(f"empty width/heads/features: W={w} H={h} F={f}")
    out = torch.empty((r, h, f), dtype=torch.float32, device=hw.device)
    if r == 0:
        return out, False
    lib = library().lib
    with torch.cuda.device(hw.device):
        stream = torch.cuda.current_stream(hw.device).cuda_stream
        err = lib.gat_edge_forward(
            hw.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(), neighbors.data_ptr(),
            mask.data_ptr(), None if row_node is None else row_node.data_ptr(),
            out.data_ptr(), r, w, h, f, n, float(negative_slope), stream,
        )
    if err != 0:
        raise RuntimeError(f"gat_edge kernel launch failed: cudaError_t {err}")
    return out, True


def gat_aggregate_kernel(
    hw: torch.Tensor,  # (N, H, F) f32
    s_src: torch.Tensor,  # (N, H)
    s_dst: torch.Tensor,  # (N, H)
    neighbors: torch.Tensor,  # (N, W) int32
    mask: torch.Tensor,  # (N, W) bool
    *,
    negative_slope: float = 0.2,
) -> torch.Tensor:  # (N, H, F)
    """Masked-softmax neighbor aggregation over the padded layout."""
    if not takes_kernel(hw, s_src, s_dst, neighbors, mask):
        return gat_edge_ref(hw, s_src, s_dst, neighbors, mask, negative_slope=negative_slope)
    if neighbors.shape[0] != hw.shape[0]:
        raise ValueError(
            f"padded layout: {neighbors.shape[0]} neighbor rows for {hw.shape[0]} nodes"
        )
    out, launched = _launch(hw, s_src, s_dst, neighbors, mask, None, negative_slope)
    if launched:
        gat_aggregate_kernel.launches += 1
    return out


def bucket_gat_kernel(
    hw: torch.Tensor,  # (N, H, F) f32, original node numbering
    s_src: torch.Tensor,  # (N, H)
    s_dst: torch.Tensor,  # (N, H)
    neighbors: torch.Tensor,  # (R, W) int32, one bucket's tile
    mask: torch.Tensor,  # (R, W) bool
    row_node: torch.Tensor,  # (R,) int32, node each tile row holds
    *,
    negative_slope: float = 0.2,
) -> torch.Tensor:  # (R, H, F)
    """The same aggregation over one degree bucket's rows."""
    if not takes_kernel(hw, s_src, s_dst, neighbors, mask, row_node):
        return gat_edge_ref(
            hw, s_src, s_dst, neighbors, mask, row_node, negative_slope=negative_slope
        )
    out, launched = _launch(hw, s_src, s_dst, neighbors, mask, row_node, negative_slope)
    if launched:
        bucket_gat_kernel.launches += 1
    return out


gat_aggregate_kernel.launches = 0
bucket_gat_kernel.launches = 0
