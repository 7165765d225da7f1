"""Loss functions: masked node classification + token cross entropy.

Counterpart of ``repro.train.losses``, same signatures and arithmetic.
"""

from __future__ import annotations

import torch


def masked_nll(log_probs: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood over masked nodes (the model emits
    log-softmax, matching the paper's final layer)."""
    nll = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    denom = mask.sum().clamp_min(1)
    return torch.sum(nll * mask) / denom


def masked_accuracy(
    log_probs: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Fraction of masked nodes whose argmax is the label."""
    pred = torch.argmax(log_probs, dim=-1)
    denom = mask.sum().clamp_min(1)
    return torch.sum((pred == labels.long()) & mask) / denom


def softmax_xent(
    logits: torch.Tensor, labels: torch.Tensor, *, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Token-level cross entropy, numerically stable, f32 accumulation."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        denom = mask.sum().clamp_min(1.0)
        return torch.sum(nll * mask) / denom
    return torch.mean(nll)
