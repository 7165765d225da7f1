"""Wrappers of the hand-written CUDA SpMM kernel (GCN aggregation).

One kernel (``csrc/spmm.cu``) serves both TPU kernels it replaces, which
share one ``pallas_call`` (``repro/kernels/spmm/kernel.py:77``):

* ``padded_spmm_kernel`` — the square padded layout (replaces
  ``padded_spmm_kernel``, ``:86``): one row of ``neighbors`` per row of
  ``hw``.
* ``bucket_spmm_kernel`` — one degree bucket's (R, W) tile indexing into
  the full (N, F) matrix (replaces ``bucket_spmm_kernel``, ``:99``).

On CUDA tensors they launch the kernel (and count the launch in
``.launches``); on CPU tensors they return the plain version
``ref.padded_spmm_ref``. Anything else raises: a wrong device, dtype, shape
or a non-contiguous tensor.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import check_tensor, takes_kernel
from repro_torch.kernels._build import BuiltLibrary, load_library
from repro_torch.kernels.spmm.ref import padded_spmm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "spmm.cu"


@functools.cache
def library() -> BuiltLibrary:
    """The built and loaded kernel library (compiled at the first call)."""
    built = load_library("spmm", [SOURCE])
    fn = built.lib.spmm_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return built


def _launch(hw, neighbors, norm):
    n, f = hw.shape
    r, w = neighbors.shape
    check_tensor("hw", hw, torch.float32, (n, f))
    check_tensor("neighbors", neighbors, torch.int32, (r, w))
    check_tensor("norm", norm, torch.float32, (r, w))
    if w < 1 or f < 1:
        raise ValueError(f"empty width/features: W={w} F={f}")
    out = torch.empty((r, f), dtype=torch.float32, device=hw.device)
    if r == 0:
        return out, False
    lib = library().lib
    with torch.cuda.device(hw.device):
        stream = torch.cuda.current_stream(hw.device).cuda_stream
        err = lib.spmm_forward(
            hw.data_ptr(), neighbors.data_ptr(), norm.data_ptr(), out.data_ptr(),
            r, w, f, n, stream,
        )
    if err != 0:
        raise RuntimeError(f"spmm kernel launch failed: cudaError_t {err}")
    return out, True


def padded_spmm_kernel(
    hw: torch.Tensor,  # (N, F) f32
    neighbors: torch.Tensor,  # (N, D) int32
    norm: torch.Tensor,  # (N, D) f32, 0 on padding
) -> torch.Tensor:  # (N, F)
    """GCN aggregation over the padded layout."""
    if not takes_kernel(hw, neighbors, norm):
        return padded_spmm_ref(hw, neighbors, norm)
    if neighbors.shape[0] != hw.shape[0]:
        raise ValueError(
            f"padded layout: {neighbors.shape[0]} neighbor rows for {hw.shape[0]} nodes"
        )
    out, launched = _launch(hw, neighbors, norm)
    if launched:
        padded_spmm_kernel.launches += 1
    return out


def bucket_spmm_kernel(
    hw: torch.Tensor,  # (N, F) f32, original node numbering
    neighbors: torch.Tensor,  # (R, W) int32, one bucket's tile
    norm: torch.Tensor,  # (R, W) f32
) -> torch.Tensor:  # (R, F)
    """The same aggregation over one degree bucket's rows."""
    if not takes_kernel(hw, neighbors, norm):
        return padded_spmm_ref(hw, neighbors, norm)
    out, launched = _launch(hw, neighbors, norm)
    if launched:
        bucket_spmm_kernel.launches += 1
    return out


padded_spmm_kernel.launches = 0
bucket_spmm_kernel.launches = 0
