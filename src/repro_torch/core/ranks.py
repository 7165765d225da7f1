"""The ranks of a pipeline across processes: joining the process group and
the ``(data, stage)`` rank grid.

Counterpart of the reference's device grid: the ``("stage",)`` and
``("data", "stage")`` meshes ``repro.core.pipeline.CompiledGNNPipeline``
builds from ``jax.devices()`` (``_mesh_devices``, and the grid of
``_build_step_scheduled``), with ``launch/mesh.py``'s job of naming the
devices. Here a device is a process: one rank per card under NCCL, or per
CPU process under gloo, started by ``torchrun``.

``join`` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), binds rank r to
``cuda:LOCAL_RANK`` and joins with NCCL, or with gloo for ``--device cpu``.
The group takes an explicit timeout, so that a collective or a
point-to-point op whose peer never comes fails instead of hanging.
Nothing falls back: no card for a ``cuda`` rank, or a group whose backend
does not match the device asked for, raises.

``RankGrid(dp, D, device_order, pods)`` lays the world out as ``dp``
replicas of a ring of ``D`` positions in each of ``pods`` pods: rank
``(p·dp + r)·D + device_order[d]`` holds position d of replica r in pod p
(the reference's grid, its columns reordered by the placement's
``device_order``; the pod axis is the reference's multi-pod mesh). It
makes every ring's stage group, every position's data group in each pod
and every (replica, position)'s pod group on every rank, in the same
order, as ``torch.distributed.new_group`` requires. The reference takes the first
``D`` or ``dp·D`` devices and lets the rest idle; a rank left out of the
ring here would never join its collectives and would hang every other
rank's, so a world whose size is neither ``D`` nor ``dp·D`` raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in the group: its rank, its device, and
    whether ``join`` made the group (``leave`` then destroys it)."""

    rank: int
    device: torch.device
    owned: bool


def active() -> bool:
    """Whether a process group of more than one rank is joined."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _device_of(device, backend: str) -> torch.device:
    device = torch.device(device)
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(
            f"a {device.type} rank needs the {want} backend; the group runs {backend}"
        )
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def join(device="cuda") -> Ranks | None:
    """Join the process group torchrun describes; None when ``WORLD_SIZE``
    is unset or 1 and no group exists. A group joined before (a test's
    spawned ranks) is returned as it is, not owned."""
    if dist.is_available() and dist.is_initialized():
        return Ranks(dist.get_rank(), _device_of(device, dist.get_backend()), owned=False)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    device = torch.device(device)
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: --device cuda but no CUDA device is available")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: LOCAL_RANK {local} but {torch.cuda.device_count()} cards: "
                "NCCL takes one rank per card"
            )
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", rank=rank, world_size=world, timeout=timeout,
                                device_id=device)
    elif device.type == "cpu":
        dist.init_process_group("gloo", rank=rank, world_size=world, timeout=timeout)
    else:
        raise ValueError(f"ranks run on cuda or cpu, got {device}")
    # one collective every rank joins before any point-to-point op, as
    # batch_isend_irecv asks of a group's first call
    dist.all_reduce(torch.zeros(1, device=device))
    return Ranks(rank, device, owned=True)


def leave(ranks: Ranks | None) -> None:
    """Destroy the group ``join`` made (a group it found stays)."""
    if ranks is not None and ranks.owned:
        dist.destroy_process_group()


def planned_world_size() -> int:
    """The joined group's size, else the one torchrun announces
    (``WORLD_SIZE``; 1 without it): what ``join`` would join."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def world_size() -> int:
    """The joined group's size (1 without one)."""
    return dist.get_world_size() if active() else 1


def gathered(obj) -> list:
    """``obj`` of every rank, in rank order (``[obj]`` without a group)."""
    if not active():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def from_leader(fn):
    """``fn()`` run on rank 0 alone, its value broadcast to every rank
    (pickled; ``fn()`` itself without a group). An exception on rank 0 is
    raised there and reaches every other rank as a ``ValueError`` with its
    message, so no rank waits on one that failed; the other ranks wait in
    the broadcast while rank 0 works."""
    if not active():
        return fn()
    box, failed = [None], None
    if dist.get_rank() == 0:
        try:
            box[0] = ("ok", fn())
        except Exception as err:  # noqa: BLE001 — re-raised below, on every rank
            failed = err
            box[0] = ("error", f"rank 0: {type(err).__name__}: {err}"
                      if not isinstance(err, ValueError) else str(err))
    dist.broadcast_object_list(box, src=0)
    if failed is not None:
        raise failed
    status, value = box[0]
    if status == "error":
        raise ValueError(value)
    return value


def same_on_every_rank(obj, what: str) -> None:
    """Raise ``ValueError`` on every rank unless every rank's ``obj`` equals
    rank 0's (a gather; nothing without a group)."""
    everyone = gathered(obj)
    differ = [r for r, o in enumerate(everyone) if o != everyone[0]]
    if differ:
        raise ValueError(f"{what} differs between rank 0 and ranks {differ}")


def is_leader() -> bool:
    """Rank 0, or the only process: the one that prints results."""
    return not active() or dist.get_rank() == 0


class RankGrid:
    """``dp`` replicas of a ring of ``D`` positions over the joined world,
    in each of ``pods`` pods.

    ``position`` and ``replica`` are this rank's place in its pod, ``pod``
    the pod; ``row`` = ``pod·dp + replica`` indexes ``rows``, the rings in
    (pod, replica) order. ``rank_at(d)`` is the global rank at position d
    of this rank's ring (its neighbours are ``rank_at(position ± 1)``);
    ``stage_group`` joins this ring, ``data_group`` the ranks at this
    position across the replicas of this pod, and ``pod_group`` the ranks
    of this (replica, position) across pods: the reference's ``pod`` axis,
    whose pods each hold a whole ``(data, stage)`` grid. A group is None
    where its axis has one member (``stage_group``: where the world is the
    ring).
    """

    def __init__(self, dp: int, D: int, device_order: tuple | None = None, pods: int = 1):
        if not active():
            raise RuntimeError("RankGrid needs a joined process group of more than one rank")
        world, rank = dist.get_world_size(), dist.get_rank()
        if pods > 1:
            if world != pods * dp * D:
                raise ValueError(
                    f"world size {world} is not {pods} pods x data_parallel {dp} x {D} "
                    "ranks: a rank outside the grid would hang its collectives")
        elif world not in (D, dp * D):
            raise ValueError(
                f"world size {world} is neither the ring's {D} ranks nor data_parallel {dp} "
                f"x {D} ranks: a rank outside the grid would hang its collectives"
            )
        order = tuple(range(D))
        if device_order is not None and len(device_order) == D:
            if sorted(device_order) != list(order):
                raise ValueError(f"device_order {device_order} is not a permutation of 0..{D - 1}")
            order = tuple(device_order)
        self.D, self.pods = D, pods
        self.dp = world // (D * pods)
        self.rows = [[q * D + order[d] for d in range(D)] for q in range(pods * self.dp)]
        (self.row, self.position), = [
            (q, d) for q, row in enumerate(self.rows) for d, x in enumerate(row) if x == rank]
        self.pod, self.replica = divmod(self.row, self.dp)
        self.stage_group = self.data_group = self.pod_group = None
        # every rank makes every group, in one order: rings, then each pod's
        # data columns, then the pod columns
        if len(self.rows) > 1:
            for row in self.rows:
                group = dist.new_group(sorted(row))
                if rank in row:
                    self.stage_group = group
        if self.dp > 1:
            for p in range(pods):
                for d in range(D):
                    column = [self.rows[p * self.dp + r][d] for r in range(self.dp)]
                    group = dist.new_group(column)
                    if rank in column:
                        self.data_group = group
        if pods > 1:
            for r in range(self.dp):
                for d in range(D):
                    column = [self.rows[p * self.dp + r][d] for p in range(pods)]
                    group = dist.new_group(column)
                    if rank in column:
                        self.pod_group = group

    def __repr__(self) -> str:
        pods = f"pods={self.pods}, pod={self.pod}, " if self.pods > 1 else ""
        return (f"RankGrid({pods}data_parallel={self.dp}, ring={self.D}, "
                f"replica={self.replica}, position={self.position})")

    def rank_at(self, position: int) -> int:
        """The global rank at ring ``position`` of this rank's ring."""
        return self.rows[self.row][position % self.D]

    def describe(self) -> dict:
        """The grid for logs: its shape and this rank's place."""
        out = {"data_parallel": self.dp, "ring": self.D, "rows": self.rows,
               "replica": self.replica, "position": self.position}
        if self.pods > 1:
            out.update(pods=self.pods, pod=self.pod)
        return out
