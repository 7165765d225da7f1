"""Runtime policy shared by every hand-written kernel in this package.

A wrapper routes by where its tensors live, and by nothing else:

* CUDA tensors launch the hand-written kernel (built at first use by
  ``repro_torch.kernels._build``). If the kernel cannot build or launch, the
  call raises; there is no fallback to the plain version on a CUDA tensor.
* CPU tensors take the kernel's plain PyTorch version (``ref.py`` beside
  it) — the route the CPU tests use.

There is no environment override and no interpret mode. ``check_tensor``
is the wrappers' shared guard on what a kernel takes; ``plain_vjp`` is the
ops' shared backward (the TPU kernels had no backward kernel, so the ops
differentiate the plain version, as the JAX ops' custom VJPs do).
"""

from __future__ import annotations

import torch


def takes_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain version). Tensors on mixed or other devices raise."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs must share one device, got {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


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
