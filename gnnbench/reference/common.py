"""What every plain reference shares: the chunk graphs worked out again from
the raw graph, the dropout draws, the loss, Adam and the matmul precision.

Plain PyTorch in float32 with TF32 off. It imports neither JAX, the JAX
package nor the program: it follows the paper's and the configuration's
semantics, in an edge-list form of its own (no padded layout, no buckets).

* A chunk is a sequential node range; edges crossing its boundary are
  dropped (the paper's sequential split). Each node keeps a self-loop and
  its ``max_degree`` lowest-index neighbors; the GCN norm
  ``1/sqrt((d_i+1)(d_j+1))`` uses the untruncated within-chunk degree.
* Dropout draws ``torch.rand`` from a fresh generator seeded with the key of
  its (step, chunk, layer) on the device of its input, keeps what reads
  ``>= rate`` and scales it by ``1/(1-rate)``. The key of layer ``l`` of
  chunk ``c`` in a step whose key is ``k`` is ``fold_in(fold_in(k, c), l)``.
* The loss is the mean negative log-likelihood over the training nodes of
  every chunk.
* Adam keeps float32 moments with bias correction and adds decoupled weight
  decay ``-lr·wd·p`` to its update.
* ``Precision("tf32")`` rounds both operands of every matmul to TF32's 10-bit
  mantissa (round to nearest), as the tensor cores' TF32 path takes them: the
  control that computes one precision below the configuration's float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new non-negative 63-bit key from ``key`` and ``data`` (splitmix64)."""
    z = (key + (data + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def step_key(seed: int, step: int) -> int:
    """The dropout key of training step ``step`` (0-based) of a run."""
    return fold_in(seed, step)


def dropout_key(key: int, chunk: int, layer: int) -> int:
    """The key of dropout layer ``layer`` on ``chunk`` in a step keyed ``key``."""
    return fold_in(fold_in(key, chunk), layer)


def flat(params: list[dict]) -> dict:
    """``{"<layer>.<name>": tensor}`` of a per-layer weight list."""
    return {f"{i}.{k}": v for i, p in enumerate(params) for k, v in p.items()}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000 + ((bits >> 13) & 1) - 1) & ~0x1FFF
    return rounded.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` from TF32 operands, forward and backward, as the tensor
    cores' TF32 path multiplies both."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32(a), tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = tf32(grad)
        return grad @ b.T, a.T @ grad


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference multiplies: ``fp32`` or ``tf32`` operands."""

    name: str = "fp32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return _TF32MatMul.apply(a, b)
        return a @ b


@dataclasses.dataclass
class ChunkGraph:
    """One chunk on the device, as directed edges ``rows <- cols`` (self-loops
    included) with the GCN norm of each, the chunk's features, labels and
    training mask."""

    rows: torch.Tensor  # (E,) int64, the aggregating node
    cols: torch.Tensor  # (E,) int64, the neighbor it reads
    norm: torch.Tensor  # (E,) float32
    features: torch.Tensor  # (n, d)
    labels: torch.Tensor  # (n,) int64
    train: torch.Tensor  # (n,) bool

    @property
    def num_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def live(self) -> int:
        """Aggregated slots: kept neighbors and self-loops."""
        return int(self.rows.shape[0])


def chunk_graph(graph, lo: int, hi: int, max_degree: int, device) -> ChunkGraph:
    """Chunk ``[lo, hi)`` of ``graph`` (a ``gnnbench.graph.PowerlawGraph``)."""
    n = hi - lo
    e = graph.edges_within(lo, hi)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=n)
    first = np.concatenate([[0], np.cumsum(deg)[:-1]])
    keep = np.arange(len(src)) - first[src] < max_degree
    self_loops = np.arange(n)
    rows = np.concatenate([self_loops, src[keep]])
    cols = np.concatenate([self_loops, dst[keep]])
    inv = 1.0 / np.sqrt(deg + 1.0)
    norm = (inv[rows] * inv[cols]).astype(np.float32)
    labels, feats, train = graph.nodes(lo, hi)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return ChunkGraph(t(rows), t(cols), t(norm), t(feats), t(labels), t(train))


def chunk_graphs(graph, traffic, device) -> list[ChunkGraph]:
    return [chunk_graph(graph, lo, hi, traffic.max_degree, device)
            for lo, hi in traffic.chunk_ranges()]


def dropout(x: torch.Tensor, rate: float, key: int | None) -> torch.Tensor:
    if key is None or rate <= 0.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(key)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def segment_softmax(scores: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """Softmax of ``scores`` (E, H) over the edges of each row."""
    heads = scores.shape[1]
    top = torch.full((n, heads), -torch.inf, device=scores.device)
    top = top.scatter_reduce(0, rows[:, None].expand(-1, heads), scores.detach(), "amax")
    p = torch.exp(scores - top.index_select(0, rows))
    total = torch.zeros((n, heads), device=scores.device).index_add(0, rows, p)
    return p / total.index_select(0, rows)


def nll_sum(logp: torch.Tensor, g: ChunkGraph) -> tuple[torch.Tensor, int]:
    """(Σ of -log p(label) over the chunk's training nodes, their count)."""
    picked = logp.gather(1, g.labels[:, None])[:, 0]
    return -(picked * g.train).sum(), int(g.train.sum())


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict) -> dict:
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        return {"step": 0, "mu": zeros, "nu": dict(zeros)}

    def step(self, params: dict, grads: dict, state: dict) -> tuple[dict, dict]:
        t = state["step"] + 1
        mu = {k: self.b1 * state["mu"][k] + (1 - self.b1) * g for k, g in grads.items()}
        nu = {k: self.b2 * state["nu"][k] + (1 - self.b2) * g * g for k, g in grads.items()}
        new = {}
        for k, p in params.items():
            m_hat = mu[k] / (1 - self.b1 ** t)
            v_hat = nu[k] / (1 - self.b2 ** t)
            new[k] = p - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps) \
                - self.lr * self.weight_decay * p
        return new, {"step": t, "mu": mu, "nu": nu}


def glorot(gen: torch.Generator, shape: tuple, fan_in: int, fan_out: int, device) -> torch.Tensor:
    lim = (6.0 / (fan_in + fan_out)) ** 0.5
    return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * lim


def train_steps(model, params: dict, graphs: list, cfg: dict, seed: int, steps: int,
                precision: Precision = Precision(), chunks: list | None = None,
                hold: bool = False) -> dict:
    """``steps`` training steps of ``model`` (a reference module) from
    ``params`` (a flat dict of leaves, copied), one gradient over every chunk
    (or those listed in ``chunks``) a step: ``{"losses", "grads" (each
    step's), "params" (after each step), "mu1" (Adam's first moment after
    the first step)}``. ``hold`` plants a fault: each step returns the
    params and optimizer state it was given."""
    opt = Adam(cfg["lr"], cfg["weight_decay"])
    params = {k: v.detach().clone() for k, v in params.items()}
    state = opt.init(params)
    chunks = range(len(graphs)) if chunks is None else chunks
    count = sum(int(graphs[c].train.sum()) for c in chunks)
    out = {"losses": [], "grads": [], "params": []}
    for step in range(steps):
        key = step_key(seed, step)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        loss = 0.0
        for c in chunks:
            logp = model.forward(cfg, leaves, graphs[c], precision,
                                 keys=lambda layer, c=c: dropout_key(key, c, layer))
            total, _ = nll_sum(logp, graphs[c])
            got = torch.autograd.grad(total / count, list(leaves.values()))
            for k, g in zip(leaves, got):
                grads[k] += g
            loss += float(total.detach()) / count
        if not hold:
            params, state = opt.step(params, grads, state)
        if step == 0:
            out["mu1"] = state["mu"]
        out["losses"].append(loss)
        out["grads"].append(grads)
        out["params"].append(params)
    return out
