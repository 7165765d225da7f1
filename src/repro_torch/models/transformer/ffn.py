"""Feed-forward blocks: SwiGLU / GeGLU / GELU-MLP (counterpart of
``repro.models.transformer.ffn``). GELU is the tanh approximation, as
``jax.nn.gelu`` computes it by default."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.common import normal_init


def ffn_apply(p: dict, x: torch.Tensor, *, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if kind == "geglu":
        return (F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])) @ p["w_down"]
    if kind == "gelu":
        return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    raise KeyError(f"unknown mlp kind {kind!r}")


def ffn_init(gen: torch.Generator, d: int, ff: int, *, kind: str, lead=(), dtype=torch.float32) -> dict:
    """One FFN's weights, each with leading dims ``lead`` (stacked layers)."""
    lead = tuple(lead)
    p = {"w_up": normal_init(gen, (*lead, d, ff), dtype=dtype)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = normal_init(gen, (*lead, d, ff), dtype=dtype)
    p["w_down"] = normal_init(gen, (*lead, ff, d), dtype=dtype)
    return p
