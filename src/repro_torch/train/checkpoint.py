"""npz checkpoints (no external deps), bf16-safe, in the JAX package's
on-disk format.

Counterpart of ``repro.train.checkpoint``. A directory holds
``arrays.npz``, one array per leaf under its dotted path (``"1.w"`` for
leaf ``w`` of layer 1 of a per-layer params list; dict keys and list
indices alike), and ``meta.json`` with ``step``, ``dtypes`` (the leaves
stored as uint16 views of bfloat16) and the caller's ``extra``. Either
package loads the other's files. ``treedef`` describes the tree in this
package's own terms (JAX's tree-structure string has no meaning here; the
reference's loader ignores the field).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """Leaves keyed by their dotted paths: dict keys, list and tuple
    indices, dataclass field names."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"checkpoint leaf at {prefix or '<root>'!r} is a {type(tree).__name__}")
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return flat


def _describe(tree: Any) -> str:
    """The tree's shape as a readable string (the ``treedef`` field)."""
    if isinstance(tree, torch.Tensor):
        return "*"
    if dataclasses.is_dataclass(tree):
        inner = ", ".join(f"{f.name}={_describe(getattr(tree, f.name))}"
                          for f in dataclasses.fields(tree))
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(v)}" for k, v in tree.items()) + "}"
    return "[" + ", ".join(_describe(v) for v in tree) + "]"


def save_checkpoint(path: str, params: Any, *, step: int = 0, extra: dict | None = None):
    """Write ``params`` (nested dicts, lists and dataclasses of tensors) to
    the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in _flatten(params).items():
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:  # numpy has no bfloat16: store the bits
            dtypes[k] = "bfloat16"
            arrays[k] = v.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[k] = v.numpy()
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    meta = {"step": step, "dtypes": dtypes, "treedef": f"repro_torch {_describe(params)}",
            **(extra or {})}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, *, device="cpu") -> tuple[dict, dict]:
    """Returns (nested dict of tensors on ``device``, meta). The nesting is
    rebuilt from the dotted keys, dicts all the way down (``tree_like``
    puts it back into a template's lists and dataclasses)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    out: dict = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k in data.files:
            a = data[k]
            if meta["dtypes"].get(k) == "bfloat16":
                t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(a))
            node = out
            parts = k.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t.to(device)
    return out, meta


def tree_like(template: Any, loaded: Any) -> Any:
    """``loaded`` (from ``load_checkpoint``) in ``template``'s structure:
    lists, tuples and dataclasses where the template has them, and the
    template's empty subtrees (parameter-free layers store no leaf)."""
    if isinstance(template, torch.Tensor):
        if not isinstance(loaded, torch.Tensor):
            raise ValueError(f"checkpoint has a subtree where a {tuple(template.shape)} leaf is")
        return loaded
    if dataclasses.is_dataclass(template):
        fields = {f.name: tree_like(getattr(template, f.name), loaded[f.name])
                  for f in dataclasses.fields(template)}
        return type(template)(**fields)
    if isinstance(template, dict):
        return {k: tree_like(v, loaded.get(str(k), {})) for k, v in template.items()}
    return type(template)(tree_like(v, loaded.get(str(i), {})) for i, v in enumerate(template))
