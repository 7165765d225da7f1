"""Parameter exchange with the JAX package.

``jax.random`` bits cannot be reproduced with ``torch.Generator``s, so
cross-framework comparisons start from the JAX model's own init: its
``GNNModel.init_params`` leaves, taken as numpy arrays, become the port's
params unchanged (same names, same shapes, float32): GAT leaves (``w``,
``a_src``, ``a_dst``, ``b``), GCN leaves (``w``, ``b``) and the empty dicts
of the parameter-free layers alike.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(leaves: list[dict[str, np.ndarray]], device="cpu") -> list[dict]:
    """Per-layer dicts of numpy arrays -> per-layer dicts of float32 tensors
    on ``device``."""
    return [
        {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device) for k, v in p.items()}
        for p in leaves
    ]
