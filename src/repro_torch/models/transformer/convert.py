"""Parameter exchange with the JAX package.

``jax.random`` bits cannot be reproduced with ``torch.Generator``s, so
cross-framework comparisons start from the JAX model's own init: the
leaves of ``repro.models.transformer.model.init_params``, taken as numpy
arrays, become the port's params unchanged — same nested names, same
stacked (num_stages, layers_per_stage, ...) shapes. A bfloat16 leaf
(numpy's ``bfloat16`` extension dtype, which ``ml_dtypes`` registers)
arrives as ``torch.bfloat16`` bit for bit; every other leaf as float32,
as before (a float32 leaf unchanged).
"""

from __future__ import annotations

import numpy as np
import torch


def leaf_from_numpy(leaf) -> torch.Tensor:
    """One array -> a CPU tensor: bfloat16 kept, anything else float32. A
    bfloat16 array is known by its dtype's name (its type lives in
    ``ml_dtypes``, which the port does not import): its 16-bit patterns are
    viewed as ``int16`` and then as ``torch.bfloat16``, so no value is
    rounded on the way."""
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(tree: dict, device="cpu") -> dict:
    """A nested dict of numpy arrays (the JAX params, or a cache) -> the
    same nested dict of tensors on ``device``: bfloat16 leaves bfloat16,
    the rest float32."""
    return {
        name: params_from_jax(leaf, device) if isinstance(leaf, dict)
        else leaf_from_numpy(leaf).to(device)
        for name, leaf in tree.items()
    }
