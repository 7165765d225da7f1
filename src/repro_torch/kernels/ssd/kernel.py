"""Wrapper of the hand-written CUDA SSD chunk-scan kernel.

``ssd_kernel`` replaces ``repro/kernels/ssd/kernel.py`` ``ssd_kernel``
(``pallas_call`` at ``:84``). It takes the model's layout — x (b, S, h, P),
dt and ``loga = A·dt`` (b, S, h) float32, B and C (b, S, N), x, B and C
all float32 or all bfloat16 — and returns ``(y (b, S, h, P) in x's dtype,
final state (b, h, P, N) float32)`` from a zero initial state. bf16 inputs
are upcast as the kernel stages them and run the same fp32 math, as the
TPU kernel upcasts them in VMEM. On CUDA tensors it runs ``csrc/ssd.cu`` — three CUDA launches per
call (chunk states, the state pass, the output), counted once per call in
``.launches`` — with the chunk states in a (b, h, chunks, P, N) scratch it
allocates; on CPU tensors it returns the plain version
``ref.ssd_chunk_scan``; on meta tensors it checks the shapes and
allocates as for a launch (the shared-memory check needs the built
library) and returns y and the state empty. Every call hands its cost
(``roofline.kernel_cost.ssd_cost``) to an active operation counter
(``kernels.kernel_call``). Anything else raises: a wrong device, dtype, shape,
a non-contiguous tensor, a head dim P above 64 or a chunk above 128 (the
kernel's register tiles), or a (P, N, chunk) whose tiles exceed a block's
shared memory.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import check_tensor, kernel_call, takes_kernel
from repro_torch.kernels._build import BuiltLibrary, load_library
from repro_torch.kernels.ssd.ref import ssd_chunk_scan

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # x, B, C and y
MAX_SMEM_BYTES = 232_448  # what one block may opt into on Hopper
MAX_P = 64  # the kernel's y tile: 16 rows x 64 columns of accumulators
MAX_CHUNK = 128  # 8 warps of 16 query rows


@functools.cache
def library() -> BuiltLibrary:
    """The built and loaded kernel library (compiled at the first call)."""
    built = load_library("ssd", [SOURCE])
    fn = built.lib.ssd_forward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    built.lib.ssd_smem_bytes.argtypes = [ctypes.c_int] * 3
    built.lib.ssd_smem_bytes.restype = ctypes.c_longlong
    return built


def ssd_kernel(
    x: torch.Tensor,  # (b, S, h, P) float32 or bfloat16
    dt: torch.Tensor,  # (b, S, h) float32
    loga: torch.Tensor,  # (b, S, h) float32
    B: torch.Tensor,  # (b, S, N) in x's dtype
    C: torch.Tensor,  # (b, S, N) in x's dtype
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan from a zero state -> (y, final state)."""
    with kernel_call("ssd_kernel", lambda: cost(x, B, chunk=chunk)):
        return _ssd(x, dt, loga, B, C, chunk)


def cost(x, B, *, chunk: int = 128) -> tuple[int, int]:
    """(operations, bytes) of one call on these inputs
    (``roofline.kernel_cost.ssd_cost``; x, B, C and y at x's itemsize)."""
    from repro_torch.roofline.kernel_cost import ssd_cost

    b, s, h, p = x.shape
    return ssd_cost(b, s, h, p, B.shape[-1], chunk, x.element_size())


def _ssd(x, dt, loga, B, C, chunk):
    if not takes_kernel(x, dt, loga, B, C, meta=True):
        # contiguous, as the kernel writes them, so what follows runs alike on every route
        return tuple(t.contiguous() for t in ssd_chunk_scan(x, dt, loga, B, C, chunk=chunk))
    b, s, h, p = x.shape
    n = B.shape[-1]
    if x.dtype not in DTYPES:
        raise TypeError(f"x: dtype {x.dtype}, kernel takes float32 or bfloat16")
    check_tensor("x", x, x.dtype, (b, s, h, p))
    check_tensor("dt", dt, torch.float32, (b, s, h))
    check_tensor("loga", loga, torch.float32, (b, s, h))
    check_tensor("B", B, x.dtype, (b, s, n))
    check_tensor("C", C, x.dtype, (b, s, n))
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes 1 to {MAX_CHUNK}")
    if p > MAX_P:
        raise ValueError(f"head dim P={p}: the kernel takes at most {MAX_P}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y, torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    chunks = -(-s // chunk)
    states = torch.empty((b, h, chunks, p, n), dtype=torch.float32, device=x.device)
    decay = torch.empty((b, h, chunks), dtype=torch.float32, device=x.device)
    if x.is_meta:
        return y, state
    lib = library().lib
    smem = lib.ssd_smem_bytes(p, n, chunk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"P={p} N={n} chunk={chunk} needs {smem} B of shared memory, "
                         f"a block has {MAX_SMEM_BYTES}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_forward(
            x.data_ptr(), dt.data_ptr(), loga.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), state.data_ptr(), states.data_ptr(), decay.data_ptr(),
            DTYPES[x.dtype], b, s, h, p, n, chunk, stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: cudaError_t {err}")
    ssd_kernel.launches += 1
    return y, state


ssd_kernel.launches = 0
