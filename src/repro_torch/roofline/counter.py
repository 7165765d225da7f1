"""Operation counter for one eager step: the port's counterpart of the
reference's HLO walk (``repro.roofline.hlo_walk``).

The reference counts a compiled XLA program, whose ``while`` bodies its walk
multiplies by their trip counts. The port runs eagerly: ``OpCounter`` is a
``TorchDispatchMode`` that sees every aten op a step dispatches, every
iteration of every loop, so it needs no trip counts. It runs the same on CPU
tensors, on a card and on the ``meta`` device (shapes only: the dry run).
For one step it records:

* **FLOPs** per aten op, by ``torch.utils.flop_counter``'s formulas (the
  products: mm, bmm, addmm, baddbmm, convolutions, SDPA);
* **bytes** per op, its tensor inputs plus its outputs. View ops move
  nothing and are skipped, as is ``empty``. The eager program runs one
  kernel per op, so these are the bytes it moves, unfused;
* **the peak of live storage bytes** on the counted device: what is resident
  at entry (``resident``: params, optimizer state, cache, batch), plus every
  storage an op creates, minus each one when it is freed;
* **kernel calls** by name, with the operations and bytes their wrappers
  report (``roofline.kernel_cost``, through ``kernels.kernel_call``). Every
  op dispatched inside a call (the plain version on a CPU tensor, the
  output's allocation on a card or on meta) is the kernel's: it counts
  toward memory only, never toward the aten FLOPs or bytes;
* **collectives** by the reference's five kinds, from the
  ``_c10d_functional`` ops (and ``c10d`` point-to-point sends as
  collective-permute), by output bytes. One card dispatches none.

So a CPU run, a meta run and a card run of one step compare op for op.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "send": "collective-permute",
}
_aten = torch.ops.aten
# metadata queries: no data moves, and FlopCounterMode lets them through too
_METADATA = {
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default, _aten.sym_size.default,
    _aten.stride.default, _aten.sym_stride.default, _aten.storage_offset.default,
    _aten.sym_storage_offset.default, _aten.numel.default, _aten.sym_numel.default,
    _aten.dim.default, torch.ops.prim.layout.default,
}
# allocations that write nothing
_NO_BYTES = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.lift_fresh}


def _flat(args, kwargs=None) -> list:
    """An op's arguments, one level of lists and tuples opened (all an aten
    schema nests)."""
    out = []
    for a in (*args, *(kwargs or {}).values()):
        if isinstance(a, (list, tuple)):
            out.extend(a)
        else:
            out.append(a)
    return out


def _tensors(flat) -> list:
    return [t for t in flat if isinstance(t, torch.Tensor)]


def _signature(a):
    """What a meta kernel reads of one argument: a tensor's layout, a list's
    items, any other value itself."""
    if isinstance(a, torch.Tensor):
        return a.shape, a.stride(), a.dtype, a.storage_offset()
    if isinstance(a, (list, tuple)):
        return tuple(map(_signature, a))
    return type(a), a


def _outputs(out) -> list:
    return [out] if isinstance(out, torch.Tensor) else \
        [t for t in out if isinstance(t, torch.Tensor)] if isinstance(out, (list, tuple)) else []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@functools.cache
def _is_view(func) -> bool:
    """An op whose outputs alias an input without writing it (``_unsafe_view``
    declares no alias, but is one)."""
    return func._overloadpacket is _aten._unsafe_view or any(
        r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)


@functools.cache
def _decomposes(func) -> bool:
    """An op without a FLOP formula that has a CompositeImplicit
    decomposition (FlopCounterMode decomposes those: under inference mode,
    matmul arrives whole)."""
    return func._overloadpacket not in flop_registry and func is not torch.ops.prim.device.default \
        and torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)


class OpCounter(TorchDispatchMode):
    """Count one step's ops (module docstring). ``resident``: trees of the
    tensors live at entry (their storages count toward the peak from the
    start). The peak counts the storages on the first resident tensor's
    device (the CPU when there is none)."""

    def __init__(self, resident=()):
        super().__init__()
        leaves = [t for t in tree_flatten(resident)[0] if isinstance(t, torch.Tensor)]
        self.device = leaves[0].device if leaves else torch.device("cpu")
        self.flops_by_op: dict[str, int] = collections.Counter()
        self.bytes_by_op: dict[str, int] = collections.Counter()
        self.kernel_calls: dict[str, int] = collections.Counter()
        self.kernel_ops: dict[str, int] = collections.Counter()
        self.kernel_bytes: dict[str, int] = collections.Counter()
        self.collectives = {k: 0 for k in COLLECTIVES}
        self._live: dict[int, int] = {}
        self.live_bytes = self.peak_bytes = 0
        for t in leaves:
            self._track(t.untyped_storage())
        self.entry_bytes = self.peak_bytes = self.live_bytes
        self._in_kernel = 0
        self._layouts: dict = {}  # meta calls' output layouts (``_run``)

    # ------------------------------------------------------------ memory --

    def _track(self, storage) -> None:
        if storage.device != self.device:
            return
        key = storage._cdata
        if key in self._live:
            return
        nbytes = storage.nbytes()
        self._live[key] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # ----------------------------------------------------------- kernels --

    @contextlib.contextmanager
    def kernel(self, name: str, cost):
        """One call of kernel ``name``: ``cost()`` -> (operations, bytes)
        recorded; the ops dispatched inside are the kernel's. A call inside
        another is part of it."""
        if self._in_kernel:
            yield
            return
        self._in_kernel = 1
        try:
            ops, nbytes = cost()
            self.kernel_calls[name] += 1
            self.kernel_ops[name] += int(ops)
            self.kernel_bytes[name] += int(nbytes)
            yield
        finally:
            self._in_kernel = 0

    # ---------------------------------------------------------- dispatch --

    def __enter__(self):
        kernels.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        packet = func._overloadpacket
        if _decomposes(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        flat = _flat(args, kwargs)
        inputs = _tensors(flat)
        out = self._run(func, args, kwargs, flat, inputs)
        outputs = _outputs(out)
        seen = {t.untyped_storage()._cdata for t in inputs}
        for t in outputs:
            storage = t.untyped_storage()
            if storage._cdata not in seen:  # a new storage, not a view or an in-place write
                self._track(storage)
        namespace = func.namespace
        if namespace in ("_c10d_functional", "c10d"):
            kind = _COLLECTIVE_OPS.get(packet.__name__.split(".")[-1])
            if kind is not None:
                self.collectives[kind] += sum(map(_nbytes, outputs or inputs))
            return out
        if self._in_kernel:
            return out
        name = f"{namespace}.{packet.__name__.split('.')[-1]}"
        if packet in flop_registry:
            self.flops_by_op[name] += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if not _is_view(func) and packet not in _NO_BYTES:
            self.bytes_by_op[name] += sum(map(_nbytes, inputs)) + sum(map(_nbytes, outputs))
        return out

    def _run(self, func, args, kwargs, flat, tensors):
        """``func(*args, **kwargs)``. On meta tensors a call that repeats one
        seen before (same op, same shapes, strides, dtypes and other
        arguments) takes its outputs' layout from the first: fresh empty
        tensors, or the input an in-place op returns. A meta kernel is a
        pure function of that key, and many run in Python (a step repeats
        its layers, micro-batches and optimizer pieces), so the dry run is
        this much faster and counts the same."""
        if not (tensors and all(t.is_meta for t in tensors)) or _is_view(func):
            return func(*args, **kwargs)
        key = (func, tuple(map(_signature, args)),
               tuple((k, _signature(v)) for k, v in kwargs.items()))
        try:
            layout = self._layouts.get(key)
        except TypeError:  # an argument that cannot be hashed
            return func(*args, **kwargs)
        if layout is not None:
            kind, leaves = layout
            outs = [flat[leaf] if isinstance(leaf, int) else
                    torch.empty_strided(leaf[0], leaf[1], dtype=leaf[2], device="meta")
                    for leaf in leaves]
            return outs[0] if kind is None else kind(outs)
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            kind, out_flat = None, [out]
        elif isinstance(out, (list, tuple)) and type(out) in (list, tuple):
            kind, out_flat = type(out), list(out)
        else:
            return out
        leaves = []
        for t in out_flat:
            if not isinstance(t, torch.Tensor):
                return out
            same = [i for i, a in enumerate(flat) if a is t]
            if same:
                leaves.append(same[0])
            elif t.storage_offset() or any(
                    t.untyped_storage()._cdata == a.untyped_storage()._cdata for a in tensors):
                return out  # a view of an input: not cached
            else:
                leaves.append((tuple(t.shape), t.stride(), t.dtype))
        self._layouts[key] = (kind, leaves)
        return out

    # ------------------------------------------------------------ report --

    @property
    def aten_flops(self) -> int:
        return sum(self.flops_by_op.values())

    @property
    def aten_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    def collective_totals(self) -> dict:
        return {**self.collectives, "total": sum(self.collectives.values())}

    def report(self) -> dict:
        """The counts as plain numbers (the dry run's JSON fields)."""
        return {
            "flops": {"aten": self.aten_flops, "by_op": dict(self.flops_by_op),
                      "kernels": dict(self.kernel_ops)},
            "bytes": {"aten": self.aten_bytes, "kernels": dict(self.kernel_bytes)},
            "kernel_calls": dict(self.kernel_calls),
            "collectives": self.collective_totals(),
            "memory": {"entry_bytes": self.entry_bytes, "peak_bytes": self.peak_bytes},
        }
