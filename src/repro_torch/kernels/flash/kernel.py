"""Wrapper of the hand-written CUDA flash-attention kernel.

``flash_attention_kernel`` replaces ``repro/kernels/flash/kernel.py``
``flash_attention_kernel`` (``pallas_call`` at ``:102``). It takes the
model's layout — q (B, Sq, H, hd), k (B, Skv, KV, hd), v (B, Skv, KV, hd_v),
float32 or bfloat16 — and returns (B, Sq, H, hd_v) in q's dtype: causal
attention with optional sliding ``window`` and tanh ``softcap``. Query and
key positions are 0-based row indices, or the int32 vectors ``q_pos`` (Sq,)
and ``kv_pos`` (Skv,) on the tensors' device, both non-decreasing (key j is
seen by row i when ``kv_pos[j] <= q_pos[i]``, and within the window of
``q_pos[i]``). On CUDA tensors it launches
``csrc/flash.cu`` (and counts the launch in ``.launches``); on CPU tensors
it returns the plain version ``ref.flash_attention_ref``, whose KV block is
``kv_block`` (the kernel tiles KV by 16, 32 or 64 keys whatever it is); on
meta tensors it checks and allocates as for a launch and returns the output
empty. Every call hands its cost (``roofline.kernel_cost.flash_cost``) to
an active operation counter (``kernels.kernel_call``); on meta tensors the
positions' values come from ``kernels.host_values``.
Anything else raises: a wrong device, dtype, shape, head grouping, a
non-contiguous tensor, one position vector without the other, or positions
that decrease (the kernel skips KV tiles by their first and last keys'
positions). Reading the positions to check their order is a host sync, so
a caller that has checked them where it built them (the model, once a
step) passes ``ordered=True`` and the wrapper reads nothing.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import check_tensor, host_values, kernel_call, takes_kernel
from repro_torch.kernels._build import BuiltLibrary, load_library
from repro_torch.kernels.flash.ref import flash_attention_ref
from repro_torch.models.transformer.attention import softmax_scale

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash.cu"
MAX_HEAD_DIM = 256  # the kernel's shared-memory tiles fit up to 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_order(name: str, pos: torch.Tensor) -> None:
    """Raise unless the position vector ``pos`` is non-decreasing (one host
    read of it; on a meta tensor, its attached values)."""
    if pos.is_meta:
        pos = torch.from_numpy(host_values(pos))
    if pos.numel() > 1 and bool((pos[1:] < pos[:-1]).any()):
        raise ValueError(f"{name} decreases: the kernel takes non-decreasing positions")


@functools.cache
def library() -> BuiltLibrary:
    """The built and loaded kernel library (compiled at the first call)."""
    built = load_library("flash", [SOURCE])
    fn = built.lib.flash_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return built


def flash_attention_kernel(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd_v)
    *,
    window: int = 0,
    softcap: float = 0.0,
    kv_block: int = 512,
    q_pos: torch.Tensor | None = None,  # (Sq,) int32
    kv_pos: torch.Tensor | None = None,  # (Skv,) int32
    ordered: bool = False,
) -> torch.Tensor:  # (B, Sq, H, hd_v)
    """Causal (windowed, softcapped) GQA attention, masked by position;
    ``ordered``: the caller has checked that the positions do not decrease."""
    if (q_pos is None) != (kv_pos is None):
        raise ValueError("give both q_pos and kv_pos, or neither")
    with kernel_call("flash_attention_kernel",
                     lambda: cost(q, k, v, window=window, q_pos=q_pos, kv_pos=kv_pos)):
        return _flash(q, k, v, window, softcap, kv_block, q_pos, kv_pos, ordered)


def cost(q, k, v, *, window=0, q_pos=None, kv_pos=None) -> tuple[int, int]:
    """(operations, bytes) of one launch on these inputs
    (``roofline.kernel_cost.flash_cost``; reads the positions' values)."""
    from repro_torch.roofline.kernel_cost import flash_cost

    b, sq, h, hd = q.shape
    _, skv, kv, _ = k.shape
    pos = {} if q_pos is None else {"q_pos": host_values(q_pos), "kv_pos": host_values(kv_pos)}
    return flash_cost(b, sq, skv, h, kv, hd, v.shape[-1], q.element_size(), window, **pos)


def _flash(q, k, v, window, softcap, kv_block, q_pos, kv_pos, ordered):
    if not takes_kernel(q, k, v, q_pos, kv_pos, meta=True):
        # contiguous, as the kernel writes it, so what follows runs alike on every route
        return flash_attention_ref(q, k, v, window=window, softcap=softcap, kv_block=kv_block,
                                   q_pos=q_pos, kv_pos=kv_pos).contiguous()
    b, sq, h, hd = q.shape
    _, skv, kv, _ = k.shape
    hd_v = v.shape[-1]
    if q.dtype not in DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, kernel takes float32 or bfloat16")
    check_tensor("q", q, q.dtype, (b, sq, h, hd))
    check_tensor("k", k, q.dtype, (b, skv, kv, hd))
    check_tensor("v", v, q.dtype, (b, skv, kv, hd_v))
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group onto {kv} kv heads")
    if not (1 <= hd <= MAX_HEAD_DIM and 1 <= hd_v <= MAX_HEAD_DIM):
        raise ValueError(f"head dims hd={hd} hd_v={hd_v}: the kernel takes 1..{MAX_HEAD_DIM}")
    if q_pos is not None:
        for name, pos, n in (("q_pos", q_pos, sq), ("kv_pos", kv_pos, skv)):
            check_tensor(name, pos, torch.int32, (n,))
            if not ordered:
                check_order(name, pos)
    out = torch.empty((b, sq, h, hd_v), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if skv == 0:
        raise ValueError("no keys: Skv = 0")
    if q.is_meta:
        return out
    lib = library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if q_pos is None else q_pos.data_ptr(),
            None if kv_pos is None else kv_pos.data_ptr(), DTYPES[q.dtype],
            b, sq, skv, h, kv, hd, hd_v, softmax_scale(hd), int(window), float(softcap), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError_t {err}")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
