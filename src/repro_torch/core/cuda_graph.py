"""CUDA-graph capture for the compiled engine: one replay per train step or
eval call.

The reference's compiled engine jits each step into one XLA program. Its
counterpart on a CUDA card is the same host-unrolled tick program
(``repro_torch.core.spmd_pipe``) captured once as a CUDA graph:

  * ``CapturedGraph`` runs a function once eagerly on a side stream (the
    warm-up: kernels build, cuBLAS and the allocator settle), then captures
    it with ``torch.cuda.graph``. A function that cannot be captured (an op
    that waits for the host, say) raises there; nothing falls back to
    running eagerly.
  * ``DrawSites`` gives every dropout draw of the program a CUDA generator
    of its own, registered with the graph and reseeded from the step's key
    before every replay (``CUDAGraph.register_generator_state``). A replay
    therefore draws exactly the masks a fresh generator seeded with that
    key draws, which is what the host engine does. The forward and each
    recompute of a (chunk, layer) are separate sites, because a registered
    generator advances its offset between the draws of one graph.
  * ``CapturedStep`` holds a train step's params and optimizer state in
    static buffers that the graph updates in place (``copy_``);
    ``GraphedForward`` holds an eval program's params and batch in static
    buffers that each call fills before the replay.

A program that forks work to another stream (the double-buffered wires of
``repro_torch.core.spmd_pipe`` post on a wire stream) is captured whole:
each fork (``wait_stream`` on the capture stream) and each join (an event
the capture stream waits on) becomes a graph edge, and the program must
join every fork before it returns, or the capture fails. A replay does not
keep the streams: CUDA runs the graph's independent branches on streams of
its own.

Each kernel wrapper counts its launches where it records them, so during a
capture each launch counts once and a replay adds nothing;
``CapturedGraph.launches`` keeps the per-replay counts seen at capture.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.gnn.net import fold_in, layer_keys


def map_tensors(fn: Callable, tree):
    """``fn`` applied to every tensor of a tree of lists, tuples, dicts and
    dataclasses (params, optimizer states, graph batches and layouts)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init
        })
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


def tree_tensors(tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` in ``map_tensors`` order."""
    found: list[torch.Tensor] = []
    map_tensors(found.append, tree)
    return found


def static_copy(tree, device: torch.device):
    """Fresh copies of ``tree``'s tensors on ``device``: a graph's static buffers."""
    return map_tensors(lambda t: t.detach().to(device, copy=True), tree)


def copy_into(static, tree) -> None:
    """Copy ``tree``'s tensors into the same-shaped ``static`` buffers,
    skipping any tensor that already is its buffer."""
    dst, src = tree_tensors(static), tree_tensors(tree)
    if len(dst) != len(src):
        raise ValueError(f"tree of {len(src)} tensors for {len(dst)} static buffers")
    for d, s in zip(dst, src):
        if d is s:
            continue
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"tensor {tuple(s.shape)} {s.dtype} for a static buffer "
                             f"{tuple(d.shape)} {d.dtype}")
        d.copy_(s)


def kernel_launches() -> dict[str, int]:
    """Every kernel wrapper's launch count."""
    from repro_torch.kernels.flash import kernel as flash
    from repro_torch.kernels.gat_edge import kernel as gat
    from repro_torch.kernels.spmm import kernel as spmm
    from repro_torch.kernels.ssd import kernel as ssd

    fns = (gat.gat_aggregate_kernel, gat.bucket_gat_kernel, spmm.padded_spmm_kernel,
           spmm.bucket_spmm_kernel, flash.flash_attention_kernel, ssd.ssd_kernel)
    return {fn.__name__: fn.launches for fn in fns}


class CapturedGraph:
    """``fn()`` captured once as a CUDA graph after one eager ``warmup()``
    (default ``fn``) on a side stream; ``replay()`` returns ``fn``'s
    outputs, which every replay overwrites. ``generators()`` names the
    generators to register before the capture begins."""

    def __init__(self, fn: Callable, *, warmup: Callable | None = None,
                 generators: Callable = tuple):
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            (warmup or fn)()
        current.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators():
            self.graph.register_generator_state(gen)
        before = kernel_launches()
        with torch.cuda.graph(self.graph):
            self.out = fn()
        after = kernel_launches()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def replay(self):
        """Run the graph once; returns the captured outputs."""
        self.graph.replay()
        return self.out


class _Site:
    def __init__(self, sites: "DrawSites"):
        self._sites = sites
        self.gen: torch.Generator | None = None

    def generator(self, device) -> torch.Generator:
        if self.gen is None:
            if self._sites.frozen:
                raise RuntimeError("a dropout draw site first drew during the CUDA-graph "
                                   "capture; its generator would not be registered")
            self.gen = torch.Generator(device=device)
        return self.gen


class DrawSites:
    """The dropout draw sites of one captured program. ``keys(chunk, site)``
    takes the place of ``net.chunk_keys``: per layer, a site object whose
    generator is made at its first draw (in the warm-up). ``seed(rng)``
    seeds each from the key the host engine would give that draw."""

    def __init__(self, n_layers: int, active: bool):
        self.n_layers = n_layers
        self.active = active  # False: the step has no key, nothing draws
        self.frozen = False
        self._sites: dict[tuple[int, int, str], _Site] = {}

    def keys(self, chunk: int, site: str) -> list:
        if not self.active:
            return [None] * self.n_layers
        return [self._sites.setdefault((chunk, i, site), _Site(self))
                for i in range(self.n_layers)]

    def generators(self) -> list[torch.Generator]:
        """The generators made so far; no new one may be made after this."""
        self.frozen = True
        return [s.gen for s in self._sites.values() if s.gen is not None]

    def seed(self, rng: int | None) -> None:
        for (chunk, layer, _), s in self._sites.items():
            if s.gen is not None:
                s.gen.manual_seed(layer_keys(fold_in(rng, chunk), self.n_layers)[layer])


class CapturedStep:
    """A train step ``step(params, opt_state, keys) -> (params, opt_state,
    loss)`` captured once. The params and optimizer state live in static
    buffers, which the graph overwrites with the step's results; ``__call__``
    copies in whatever the caller passes that is not those buffers, seeds
    the draw sites and replays. It returns the buffers themselves, so the
    next replay overwrites what it returned."""

    def __init__(self, step: Callable, params, opt_state, n_layers: int, active: bool,
                 device: torch.device):
        self.params = static_copy(params, device)
        self.opt_state = static_copy(opt_state, device)
        self.sites = DrawSites(n_layers, active)

        def run():
            return step(self.params, self.opt_state, self.sites.keys)

        def body():
            new_params, new_state, loss = run()
            copy_into(self.params, new_params)
            copy_into(self.opt_state, new_state)
            return loss

        self.captured = CapturedGraph(body, warmup=run, generators=self.sites.generators)

    def __call__(self, params, opt_state, rng: int | None):
        copy_into(self.params, params)
        copy_into(self.opt_state, opt_state)
        self.sites.seed(rng)
        loss = self.captured.replay()
        return self.params, self.opt_state, loss


class GraphedForward:
    """``forward(params, graph)`` replayed from a CUDA graph captured at the
    first call. The params and the batch are copied into static buffers
    before each replay (the batch only when it is another object than last
    time); the result is a copy of the graph's output."""

    def __init__(self, forward: Callable):
        self._forward = forward
        self.captured: CapturedGraph | None = None
        self._last_graph = None

    def __call__(self, params, graph) -> torch.Tensor:
        if self.captured is None:
            device = graph.features.device
            self._params = static_copy(params, device)
            self._graph = static_copy(graph, device)
            self.captured = CapturedGraph(lambda: self._forward(self._params, self._graph))
        copy_into(self._params, params)
        if graph is not self._last_graph:
            copy_into(self._graph, graph)
            self._last_graph = graph
        return self.captured.replay().clone()
