"""Parameter exchange with the JAX package.

``jax.random`` bits cannot be reproduced with ``torch.Generator``s, so
cross-framework comparisons start from the JAX model's own init: the
leaves of ``repro.models.transformer.model.init_params``, taken as numpy
arrays, become the port's params unchanged — same nested names, same
stacked (num_stages, layers_per_stage, ...) shapes, float32.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict, device="cpu") -> dict:
    """A nested dict of numpy arrays (the JAX params, or a cache) -> the
    same nested dict of float32 tensors on ``device``."""
    return {
        name: params_from_jax(leaf, device) if isinstance(leaf, dict)
        else torch.from_numpy(np.array(leaf, dtype=np.float32)).to(device)
        for name, leaf in tree.items()
    }
