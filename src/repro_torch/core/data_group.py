"""The LM data axis: the replicas a step runs and the collectives between
them.

Counterpart of the reference's ``fsdp`` mesh axis inside its LM steps
(``repro.models.transformer.model``): ``lax.all_gather`` (the ZeRO-3 gather
of ``repro.core.spmd_pipe.make_gather_fn``, MoE's gathered tokens),
``lax.psum_scatter``, ``lax.all_to_all`` and ``lax.psum``/``lax.pmax`` over
that axis.

A ``DataGroup`` holds the replicas this process runs: all ``size`` of them
in one process (``Topology(data=dp)`` without a ring), or on a rank of a
``core.ranks.RankGrid(dp, D)`` its own, ``grid.replica``, whose peers are
the ranks of its ``data_group``. Every method takes a list with one tensor
per local replica, in replica order, and returns such a list. In one
process a collective is a concatenation or an ordered sum over the list;
on a rank it is the same arithmetic over the tensors an all-gather or an
all-to-all brought in. Every sum over replicas runs in ascending replica
order on both sides (no ``all_reduce`` or ``reduce_scatter`` sums in an
order the backend picks), so a rank grid equals the one-process form bit
for bit.

The collectives that carry gradients are ``torch.autograd.Function``\\ s
with one input and one output per local replica: ``gather`` (an all-gather
along dim 0, whose backward is the reduce-scatter of the gradient),
``scatter_sum`` (a reduce-scatter, whose backward is an all-gather) and
``exchange`` (an all-to-all, whose backward is the all-to-all of the
gradients). In one process every replica of a (stage, micro-batch) runs in
one autograd pass, so such a backward has every replica's gradient at
hand. ``fanout`` hands one tensor to several consumers and sums their
gradients in a fixed order, where a consumer's gradient passes through
one of these collectives: in one process that gradient arrives only when
every replica's has, and autograd would otherwise sum the arrivals in
that order.
"""

from __future__ import annotations

import torch


def ordered_sum(parts: list) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, in that order."""
    out = parts[0].clone()
    for p in parts[1:]:
        out.add_(p)
    return out


class DataGroup:
    """The replicas of a step in this process: ``local`` (replica indices)
    of ``size``. ``grid``: a rank grid, whose ``data_group`` joins this
    rank's peers; None in one process. ``axis="pod"`` makes it the grid's
    pod axis instead (the reference's ``pod_axis``): the pods of one
    (replica, position), joined by ``pod_group``, ``grid.pod`` this
    rank's."""

    def __init__(self, size: int, grid=None, axis: str = "data"):
        if axis not in ("data", "pod"):
            raise ValueError(f"a DataGroup's axis is data or pod, got {axis!r}")
        self.size, self.grid, self.axis = size, grid, axis
        self.ranked = grid is not None and size > 1
        if grid is None:
            self.local = list(range(size))
            return
        held = grid.dp if axis == "data" else getattr(grid, "pods", 1)
        if held != size:
            raise ValueError(f"a {axis} axis of {size} on a rank grid of {held}")
        self.local = [0 if size == 1 else grid.replica if axis == "data" else grid.pod]

    @property
    def process_group(self):
        """The torch process group of this rank's peers on the axis."""
        return self.grid.data_group if self.axis == "data" else self.grid.pod_group

    # --------------------------------------------------------- no gradient --

    def everyone(self, xs: list) -> list:
        """Every replica's tensor, in replica order (``xs`` has this
        process's)."""
        if not self.ranked:
            return list(xs)
        import torch.distributed as dist

        # one buffer the backend writes in place (a list of outputs makes
        # NCCL gather into a flat copy of its own first)
        x = xs[0].contiguous()
        got = torch.empty((self.size, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(got.view(-1), x.view(-1), group=self.process_group)
        return list(got.unbind(0))

    def sum(self, xs: list) -> list:
        """The ordered sum over replicas, for each local one."""
        total = ordered_sum(self.everyone(xs))
        return [total] * len(self.local)

    def max(self, xs: list) -> list:
        """The elementwise maximum over replicas, for each local one."""
        parts = self.everyone(xs)
        out = parts[0].clone()
        for p in parts[1:]:
            out = torch.maximum(out, p)
        return [out] * len(self.local)

    def concat(self, xs: list, dim: int = 0) -> list:
        """Every replica's tensor concatenated along ``dim`` (an all-gather)."""
        out = torch.cat(self.everyone(xs), dim)
        return [out] * len(self.local)

    def reduce_rows(self, xs: list, dim: int = 0) -> list:
        """Local replica r's chunk r along ``dim`` of the ordered sum over
        replicas (a reduce-scatter: a rank receives only its chunks)."""
        n = xs[0].shape[dim] // self.size
        chunk = lambda x, r: x.narrow(dim, r * n, n)
        if not self.ranked:
            return [ordered_sum([chunk(x, r) for x in xs]) for r in self.local]
        return [ordered_sum(self._all_to_all([chunk(xs[0], r) for r in range(self.size)]))]

    def _all_to_all(self, sends: list) -> list:
        """A rank's all-to-all: ``sends[r]`` goes to replica r; returns what
        each replica sent here, in replica order."""
        import torch.distributed as dist

        sends = [s.contiguous() for s in sends]
        got = [torch.empty_like(s) for s in sends]
        dist.all_to_all(got, sends, group=self.process_group)
        return got

    # ----------------------------------------------------------- gradients --

    def gather(self, xs: list) -> list:
        """Every replica's tensor concatenated along dim 0; the backward
        sums the replicas' gradients of each chunk and hands chunk r to
        replica r."""
        return list(_Gather.apply(self, *xs))

    def scatter_sum(self, ys: list) -> list:
        """Replica r's chunk (dim 0) of the ordered sum over replicas; the
        backward concatenates every replica's gradient."""
        return list(_ScatterSum.apply(self, *ys))

    def exchange(self, xs: list) -> list:
        """An all-to-all: ``xs[j]`` of leading dim ``size``, its row r for
        replica r; replica r receives (size, ...), row s from replica s."""
        return list(_Exchange.apply(self, *xs))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group, ctx.n = group, xs[0].shape[0]
        if group.ranked:
            return (torch.cat(group.everyone(xs)),)
        return tuple(torch.cat(xs) for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        group, n = ctx.group, ctx.n
        if group.ranked:
            return (None, ordered_sum(group._all_to_all(list(gs[0].split(n)))))
        return (None, *(ordered_sum([g[r * n:(r + 1) * n] for g in gs]) for r in group.local))


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *ys):
        ctx.group = group
        return tuple(group.reduce_rows(list(ys)))

    @staticmethod
    def backward(ctx, *gs):
        group = ctx.group
        if group.ranked:
            return (None, torch.cat(group.everyone(list(gs))))
        return (None, *(torch.cat(gs) for _ in gs))


def _exchange(group: DataGroup, xs: list) -> tuple:
    if group.ranked:
        return (torch.stack(group._all_to_all(list(xs[0].unbind(0)))),)
    return tuple(torch.stack([x[r] for x in xs]) for r in group.local)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return _exchange(group, list(xs))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_exchange(ctx.group, list(gs)))


class _Fanout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.clone() for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        return ordered_sum(list(gs)), None


def fanout(x: torch.Tensor, n: int) -> tuple:
    """``n`` copies of ``x`` whose gradients are summed in index order."""
    return _Fanout.apply(x, n)
