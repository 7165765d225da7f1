"""Single-device training loop for the GNN experiments (paper Tables 1–2).

Counterpart of ``repro.train.loop``: the "single GPU" rows of the paper's
benchmarks and the correctness oracle the pipeline must agree with. The
pipelined loop lives in ``repro_torch.core.pipeline``. Dropout keys come
from ``fold_in(seed, epoch)``; the graph's device is the device of the run.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.graphs.data import GraphBatch
from repro_torch.models.gnn.net import GNNModel, fold_in
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.losses import masked_accuracy, masked_nll


@dataclass
class TrainResult:
    """Final params, per-epoch wall times and the closing metrics."""

    params: Any
    epoch_times_s: list[float] = field(default_factory=list)
    train_loss: float = 0.0
    train_acc: float = 0.0
    val_acc: float = 0.0
    test_acc: float = 0.0

    @property
    def first_epoch_s(self) -> float:
        """Wall time of epoch 0 (includes the kernels' first-use build)."""
        return self.epoch_times_s[0] if self.epoch_times_s else 0.0

    @property
    def rest_epochs_s(self) -> float:
        """Wall time of every epoch after the first."""
        return sum(self.epoch_times_s[1:])

    @property
    def avg_epoch_s(self) -> float:
        """Mean epoch time, epoch 0 excluded when there are others."""
        rest = self.epoch_times_s[1:] or self.epoch_times_s
        return sum(rest) / max(len(rest), 1)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_train_step(model: GNNModel, optimizer: opt_lib.Optimizer):
    """``step(params, opt_state, g, rng) -> (params, opt_state, loss)``:
    one full-batch Adam step; ``rng`` is the step's dropout key."""

    def step(params, opt_state, g: GraphBatch, rng):
        leaves = opt_lib.requires_grad_leaves(params)
        with torch.enable_grad():
            logp = model.apply(leaves, g, rng=rng, train=True)
            loss = masked_nll(logp, g.labels, g.train_mask)
            grads = opt_lib.tree_grad(loss, leaves)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = opt_lib.apply_updates(params, updates)
        return params, opt_state, loss.detach()

    return step


def make_eval(model: GNNModel):
    """``evaluate(params, g) -> {train_loss, train_acc, val_acc, test_acc}``
    (0-d tensors) from one forward without dropout."""

    def evaluate(params, g: GraphBatch):
        with torch.no_grad():
            logp = model.apply(params, g, train=False)
            return {
                "train_loss": masked_nll(logp, g.labels, g.train_mask),
                "train_acc": masked_accuracy(logp, g.labels, g.train_mask),
                "val_acc": masked_accuracy(logp, g.labels, g.val_mask),
                "test_acc": masked_accuracy(logp, g.labels, g.test_mask),
            }

    return evaluate


def train(
    model: GNNModel,
    g: GraphBatch,
    *,
    epochs: int = 300,
    lr: float = 5e-3,
    weight_decay: float = 5e-4,
    seed: int = 0,
    log_every: int = 0,
    time_epochs: bool = True,
) -> TrainResult:
    """Full-batch training, paper §7 protocol (300 epochs, fixed model), on
    ``g``'s device, from ``model.init_params(seed)``."""
    device = g.device
    params = model.init_params(seed, device=device)
    optimizer = opt_lib.adam(lr, weight_decay=weight_decay)
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer)
    evaluate = make_eval(model)

    result = TrainResult(params=params)
    for epoch in range(epochs):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, g, fold_in(seed, epoch))
        if time_epochs:
            synchronize(device)
            result.epoch_times_s.append(time.perf_counter() - t0)
        if log_every and (epoch % log_every == 0 or epoch == epochs - 1):
            m = evaluate(params, g)
            print(
                f"epoch {epoch:4d} loss {float(loss):.4f} "
                f"train {float(m['train_acc']):.3f} val {float(m['val_acc']):.3f}"
            )

    metrics = evaluate(params, g)
    result.params = params
    result.train_loss = float(metrics["train_loss"])
    result.train_acc = float(metrics["train_acc"])
    result.val_acc = float(metrics["val_acc"])
    result.test_acc = float(metrics["test_acc"])
    return result
