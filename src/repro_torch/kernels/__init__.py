"""Runtime policy shared by every hand-written kernel in this package.

A wrapper routes by where its tensors live, and by nothing else:

* CUDA tensors launch the hand-written kernel (built at first use by
  ``repro_torch.kernels._build``). If the kernel cannot build or launch, the
  call raises; there is no fallback to the plain version on a CUDA tensor.
* CPU tensors take the kernel's plain PyTorch version (``ref.py`` beside
  it) — the route the CPU tests use.
* Meta tensors (the dry run, ``repro_torch.launch.dryrun``) take the
  kernel's checks and allocations and launch nothing: the wrapper returns
  its outputs empty, of the kernel's shapes. Only the flash and SSD
  wrappers take this route; the GNN kernels raise on meta tensors.

Every call runs inside ``kernel_call``, which hands the call's cost to an
active operation counter (``repro_torch.roofline.counter``) on every route,
so that a CPU, a meta and a card run of one step count alike.

There is no environment override and no interpret mode. ``check_tensor``
is the wrappers' shared guard on what a kernel takes; ``plain_vjp`` is the
ops' shared backward (the TPU kernels had no backward kernel, so the ops
differentiate the plain version, as the JAX ops' custom VJPs do).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# the active operation counters (``roofline.counter.OpCounter``), innermost last
COUNTERS: list = []


def takes_kernel(*tensors: torch.Tensor, meta: bool = False) -> bool:
    """True for CUDA tensors (launch the kernel) and, where the wrapper has
    a meta route (``meta``), for meta tensors (allocate, launch nothing);
    False for CPU tensors (plain version). Tensors on mixed or other devices
    raise."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs must share one device, got {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cuda" or (meta and device.type == "meta"):
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


@contextlib.contextmanager
def kernel_call(name: str, cost):
    """Run one wrapper call as kernel ``name``'s: the innermost active
    counter attributes the ops dispatched inside to it and records
    ``cost()`` -> (operations, bytes), which is called only when a counter
    is active (it may read position vectors from the device)."""
    if not COUNTERS:
        yield
        return
    with COUNTERS[-1].kernel(name, cost):
        yield


def attach_values(t: torch.Tensor, values: np.ndarray) -> torch.Tensor:
    """Keep the numpy ``values`` of the meta tensor ``t`` beside it, for
    ``host_values`` (a meta tensor holds no data); returns ``t``."""
    t.host_values = np.ascontiguousarray(values)
    return t


def host_values(t: torch.Tensor) -> np.ndarray:
    """The values of ``t`` as numpy: read from its device (a host sync on a
    card), or for a meta tensor from those its maker attached to it or to the
    tensor it views (``attach_values``); raises for a meta tensor without."""
    if t.device.type != "meta":
        return t.detach().cpu().numpy()
    base = t if t._base is None else t._base
    values = getattr(base, "host_values", None)
    if values is None:
        raise ValueError("a meta tensor holds no values, and none were attached to it")
    flat = values.reshape(-1)
    view = np.lib.stride_tricks.as_strided(flat[t.storage_offset():], tuple(t.shape),
                                           [s * flat.itemsize for s in t.stride()])
    return view.copy()


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` has exactly ``dtype`` and ``shape`` and is
    contiguous — what a kernel's raw-pointer interface takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")


def plain_vjp(fn, primals, ct, needs=None):
    """Gradients of ``fn(*primals)`` against cotangent ``ct``, recomputed
    through ``fn`` (a plain version). ``needs`` (one bool per primal, as in
    ``ctx.needs_input_grad``) skips the primals that want no gradient; their
    entries come back None."""
    needs = [True] * len(primals) if needs is None else list(needs)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(n) for p, n in zip(primals, needs)]
        out = fn(*leaves)
        wanted = [leaf for leaf, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, ct) if wanted else ())
    return tuple(next(grads) if n else None for n in needs)
