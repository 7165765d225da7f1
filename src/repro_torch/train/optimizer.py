"""Optimizers over the port's parameter trees: Adam/AdamW, SGD, schedules.

Counterpart of ``repro.train.optimizer``, same API: ``init(params) ->
state``, ``update(grads, state, params) -> (updates, state)``, applied with
``apply_updates``. A tree is what the models use: a list with one dict of
tensors per layer. ``adam`` follows the JAX package's rule exactly — f32
moments, bias correction, and *decoupled* weight decay ``u -= lr·wd·p``
added to the update after the Adam step. ``torch.optim.Adam(weight_decay=)``
adds L2 to the gradient instead, a different optimizer, and
``torch.optim.AdamW`` orders the arithmetic differently; neither is used.
Updates are new tensors: nothing is changed in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

Tree = list  # list[dict[str, torch.Tensor]], one dict per layer


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf across trees of one structure."""
    return [
        {k: fn(v, *(r[i][k] for r in rest)) for k, v in layer.items()}
        for i, layer in enumerate(tree)
    ]


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    """The leaves in layer order, then key order."""
    return [v for layer in tree for v in layer.values()]


def requires_grad_leaves(tree: Tree) -> Tree:
    """Detached copies of ``tree``'s leaves that autograd tracks."""
    return tree_map(lambda v: v.detach().requires_grad_(True), tree)


def tree_grad(out: torch.Tensor, leaves: Tree, grad_output=None) -> Tree:
    """Gradients of ``out`` with respect to every leaf of ``leaves`` (from
    ``requires_grad_leaves``); a leaf ``out`` does not depend on gets zeros,
    as ``jax.grad`` gives."""
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(out, flat, grad_output, allow_unused=True) if flat else ()
    return fill_grads(leaves, grads)


def fill_grads(leaves: Tree, grads) -> Tree:
    """Flat gradients (leaf order, None where unused) as a tree shaped like
    ``leaves``, zeros in place of None."""
    it = iter(grads)

    def take(v):
        g = next(it)
        return torch.zeros_like(v) if g is None else g

    return tree_map(take, leaves)


class Optimizer(NamedTuple):
    """A pair of pure functions over parameter trees."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``params + updates``, cast back to each parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves))) if leaves else torch.zeros(())


def clip_by_global_norm(tree: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    """Scale ``tree`` so its global norm is at most ``max_norm``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale, tree), norm


@dataclasses.dataclass(frozen=True)
class AdamState:
    """Step count (int32, 0-d, host) and the f32 first and second moments."""

    step: torch.Tensor
    mu: Any
    nu: Any


def _lr_at(lr, step: torch.Tensor) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)


def adam(
    lr: float | Callable[[torch.Tensor], torch.Tensor],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: float | None = None,
) -> Optimizer:
    """Adam / AdamW with decoupled weight decay. Moments are kept in f32
    regardless of the parameter dtype."""

    def init(params):
        f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamState(
            step=torch.zeros((), dtype=torch.int32),
            mu=tree_map(f32, params),
            nu=tree_map(f32, params),
        )

    def update(grads, state, params):
        if grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        g32 = tree_map(lambda g: g.float(), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, g32)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, g32)
        stepf = step.float()
        mu_hat = tree_map(lambda m: m / (1 - b1 ** stepf), mu)
        nu_hat = tree_map(lambda v: v / (1 - b2 ** stepf), nu)

        def upd(m, v, p):
            u = -lr_t * m / (torch.sqrt(v) + eps)
            if weight_decay > 0.0:
                u = u - lr_t * weight_decay * p.float()
            return u.to(p.dtype)

        updates = tree_map(upd, mu_hat, nu_hat, params)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def sgd(lr: float | Callable, *, momentum: float = 0.0) -> Optimizer:
    """Plain SGD, with optional heavy-ball momentum kept in f32."""

    def init(params):
        if momentum == 0.0:
            return {"step": torch.zeros((), dtype=torch.int32)}
        return {
            "step": torch.zeros((), dtype=torch.int32),
            "vel": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        }

    def update(grads, state, params):
        del params
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum == 0.0:
            return tree_map(lambda g: -lr_t * g, grads), {"step": step}
        vel = tree_map(lambda v, g: momentum * v + g.float(), state["vel"], grads)
        return tree_map(lambda v: -lr_t * v, vel), {"step": step, "vel": vel}

    return Optimizer(init=init, update=update)


def cosine_schedule(peak: float, *, warmup: int, total: int, floor: float = 0.0):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor`` at ``total``; ``sched(step)`` takes a 0-d step tensor."""

    def sched(step):
        step = step.float()
        warm = peak * step / max(1.0, warmup)
        prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(torch.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return sched
