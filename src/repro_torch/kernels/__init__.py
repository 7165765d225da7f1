"""Runtime policy shared by every hand-written kernel in this package.

A wrapper routes by where its tensors live, and by nothing else:

* CUDA tensors launch the hand-written kernel (built at first use by
  ``repro_torch.kernels._build``). If the kernel cannot build or launch, the
  call raises; there is no fallback to the plain version on a CUDA tensor.
* CPU tensors take the kernel's plain PyTorch version (``ref.py`` beside
  it) — the route the CPU tests use.

There is no environment override and no interpret mode.
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
