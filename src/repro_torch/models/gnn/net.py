"""Sequential GNN models (the paper's GAT, the GCN family), as stage-able
layer sequences.

Counterpart of ``repro.models.gnn.net`` (``SeqLayer``, ``GNNModel``,
``build_paper_gat``, ``build_gnn`` for ``gat``/``gcn``/``graphconv``/
``gatedgraphconv``, ``build_imbalanced_gcn`` and the compiled engine's params-explicit stage
slices, ``make_gnn_stage_slices`` and its split-backward halves
``make_gnn_stage_slices_bw``). The paper model (§6):

    dropout(0.6) -> GAT(8 heads, concat, attn-dropout 0.6) -> ELU
    -> dropout(0.6) -> GAT(8 heads, average, attn-dropout 0.6) -> log_softmax

Params are a list with one dict of tensors per layer, like the JAX
package's pytree, so a ``balance`` array partitions model and params alike.

Randomness is keyed, never drawn from shared state: ``apply`` takes an
integer key, ``fold_in`` derives one key per layer from it, and a dropout
layer seeds a fresh counter-based generator from its key on the device of
its input. The same key therefore redraws the same masks, which is what
lets the pipeline engine re-materialize a stage in its backward. A key may
also be a *draw site*, any object with ``generator(device)``: the compiled
engine's CUDA graphs hand each draw a generator they own and reseed from
the integer key before every replay (``repro_torch.core.cuda_graph``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.graphs.data import GraphBatch
from repro_torch.models.gnn import layers as L
from repro_torch.train.optimizer import fill_grads


_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new non-negative 63-bit key from ``key`` and ``data`` (the role of
    ``jax.random.fold_in``; a splitmix64 finalizer, not JAX's bits). The same
    pair always gives the same key."""
    z = (key + (data + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def layer_keys(key: int | None, n_layers: int) -> list[int | None]:
    """One key per layer (``fold_in(key, layer)``), or Nones without a key."""
    if key is None:
        return [None] * n_layers
    return [fold_in(key, i) for i in range(n_layers)]


def _generator(key, x: torch.Tensor, active: bool) -> torch.Generator | None:
    """The generator a draw uses, only where one will happen (training with
    a positive rate): a fresh one seeded from an integer ``key`` on ``x``'s
    device, or a draw site's own (``key.generator(device)``)."""
    if key is None or not active:
        return None
    if isinstance(key, int):
        return torch.Generator(device=x.device).manual_seed(key)
    return key.generator(x.device)


@dataclasses.dataclass(frozen=True)
class SeqLayer:
    """One element of a sequential model: ``init(generator) -> params`` and
    ``apply(params, graph, h, key, train) -> h`` (``key`` an int or None)."""

    name: str
    init: Callable[[torch.Generator | None], Any]
    apply: Callable[[Any, GraphBatch, torch.Tensor, int | None, bool], torch.Tensor]


def _no_params(generator):
    return {}


def _dropout_layer(rate: float, name: str) -> SeqLayer:
    def apply(p, g, h, key, train):
        return L.dropout(h, rate, _generator(key, h, train and rate > 0.0), train)

    return SeqLayer(name, _no_params, apply)


def _elu_layer() -> SeqLayer:
    return SeqLayer(
        "elu", _no_params, lambda p, g, h, key, train: torch.nn.functional.elu(h)
    )


def _log_softmax_layer() -> SeqLayer:
    return SeqLayer(
        "log_softmax", _no_params, lambda p, g, h, key, train: torch.log_softmax(h, dim=-1)
    )


def _gat_seq_layer(
    name: str,
    in_dim: int,
    out_dim: int,
    *,
    heads: int,
    concat: bool,
    attn_dropout: float,
    backend: str,
) -> SeqLayer:
    def apply(p, g, h, key, train):
        return L.gat_layer(
            p, g, h, concat=concat, attn_dropout=attn_dropout,
            generator=_generator(key, h, train and attn_dropout > 0.0),
            train=train, backend=backend,
        )

    return SeqLayer(
        name, lambda gen: L.init_gat(in_dim, out_dim, heads=heads, generator=gen), apply
    )


def _gcn_seq_layer(name: str, in_dim: int, out_dim: int, *, backend: str) -> SeqLayer:
    return SeqLayer(
        name,
        lambda gen: L.init_gcn(in_dim, out_dim, generator=gen),
        lambda p, g, h, key, train: L.gcn_layer(p, g, h, backend=backend),
    )


def _graph_conv_seq_layer(name: str, in_dim: int, out_dim: int, *, backend: str) -> SeqLayer:
    return SeqLayer(
        name,
        lambda gen: L.init_graph_conv(in_dim, out_dim, generator=gen),
        lambda p, g, h, key, train: L.graph_conv_layer(p, g, h, backend=backend),
    )


def _gated_graph_conv_seq_layer(name: str, dim: int, *, backend: str) -> SeqLayer:
    return SeqLayer(
        name,
        lambda gen: L.init_gated_graph_conv(dim, generator=gen),
        lambda p, g, h, key, train: L.gated_graph_conv_layer(p, g, h, backend=backend),
    )


@dataclasses.dataclass(frozen=True)
class GNNModel:
    """A sequential GNN: its layers and the model's input/output widths."""

    layers: tuple[SeqLayer, ...]
    in_dim: int
    out_dim: int

    def init_params(self, seed: int = 0, *, device="cpu") -> list[dict]:
        """Fresh per-layer params from a seeded ``torch.Generator`` (not the
        JAX package's random bits; ``convert.params_from_jax`` carries those
        across)."""
        gen = torch.Generator().manual_seed(seed)
        return [
            {k: v.to(device) for k, v in layer.init(gen).items()} for layer in self.layers
        ]

    def apply(
        self,
        params: list,
        g: GraphBatch,
        h: torch.Tensor | None = None,
        *,
        rng: int | None = None,
        train: bool = False,
    ) -> torch.Tensor:
        """Run every layer; when training, layer i's dropout draws from
        ``fold_in(rng, i)``."""
        h = g.features if h is None else h
        for layer, p, key in zip(self.layers, params, layer_keys(rng, len(self.layers))):
            h = layer.apply(p, g, h, key, train)
        return h


def build_paper_gat(
    num_features: int,
    num_classes: int,
    *,
    hidden_per_head: int = 8,
    heads: int = 8,
    feat_dropout: float = 0.6,
    attn_dropout: float = 0.6,
    backend: str = "padded",
) -> GNNModel:
    """The exact model of paper §6 (GAT defaults of Veličković et al.)."""
    L.canonical_backend(backend)
    layers = (
        _dropout_layer(feat_dropout, "dropout_0"),
        _gat_seq_layer(
            "gat_0", num_features, hidden_per_head, heads=heads, concat=True,
            attn_dropout=attn_dropout, backend=backend,
        ),
        _elu_layer(),
        _dropout_layer(feat_dropout, "dropout_1"),
        _gat_seq_layer(
            "gat_1", hidden_per_head * heads, num_classes, heads=heads, concat=False,
            attn_dropout=attn_dropout, backend=backend,
        ),
        _log_softmax_layer(),
    )
    return GNNModel(layers=layers, in_dim=num_features, out_dim=num_classes)


def build_imbalanced_gcn(
    num_features: int,
    num_classes: int,
    *,
    hidden: tuple[int, ...] = (256, 256, 32, 32, 32, 32),
    backend: str = "padded",
) -> GNNModel:
    """A deliberately cost-imbalanced GCN stack — the partitioner's benchmark
    and test fixture: the leading layers are an order of magnitude wider
    than the tail, so a layer-count-uniform ``balance`` packs the heavy
    layers into one stage."""
    L.canonical_backend(backend)
    dims = [num_features, *hidden, num_classes]
    layers = tuple(
        _gcn_seq_layer(f"gcn_{i}", dims[i], dims[i + 1], backend=backend)
        for i in range(len(dims) - 1)
    ) + (_log_softmax_layer(),)
    return GNNModel(layers=layers, in_dim=num_features, out_dim=num_classes)


def build_gnn(
    kind: str,
    num_features: int,
    num_classes: int,
    *,
    hidden: int = 64,
    depth: int = 2,
    backend: str = "padded",
) -> GNNModel:
    """Generic builder in the same sequential form: ``gat`` (the paper
    model), or ``depth`` layers of width ``hidden`` with ELU between them of
    ``gcn``, ``graphconv`` or ``gatedgraphconv`` (a GCN projection
    ``proj_i`` ahead of each GatedGraphConv whose width changes)."""
    if kind == "gat":
        return build_paper_gat(num_features, num_classes, backend=backend)
    L.canonical_backend(backend)
    layers: list[SeqLayer] = []
    dims = [num_features] + [hidden] * (depth - 1) + [num_classes]
    for i in range(depth):
        din, dout = dims[i], dims[i + 1]
        if kind == "gcn":
            layers.append(_gcn_seq_layer(f"gcn_{i}", din, dout, backend=backend))
        elif kind == "graphconv":
            layers.append(_graph_conv_seq_layer(f"graphconv_{i}", din, dout, backend=backend))
        elif kind == "gatedgraphconv":
            if din != dout:
                layers.append(_gcn_seq_layer(f"proj_{i}", din, dout, backend=backend))
            layers.append(_gated_graph_conv_seq_layer(f"ggc_{i}", dout, backend=backend))
        else:
            raise KeyError(f"unknown GNN kind {kind!r}")
        if i < depth - 1:
            layers.append(_elu_layer())
    layers.append(_log_softmax_layer())
    return GNNModel(layers=tuple(layers), in_dim=num_features, out_dim=num_classes)


# ------------------------------------------------------- stage slices --


def _one_node_graph(graph: GraphBatch) -> GraphBatch:
    """A one-node graph on the CPU with ``graph``'s feature width: its only
    neighbor slot is its self-loop."""
    one = torch.ones((1, 1), dtype=torch.bool)
    return GraphBatch(
        features=torch.zeros((1, graph.num_features)),
        neighbors=torch.zeros((1, 1), dtype=torch.int32),
        mask=one,
        norm=torch.ones((1, 1)),
        labels=torch.zeros((1,), dtype=torch.int32),
        train_mask=one[0],
        val_mask=one[0],
        test_mask=one[0],
        node_ids=torch.zeros((1,), dtype=torch.int32),
        num_classes=graph.num_classes,
    )


def activation_widths(model: GNNModel, params: list, graph: GraphBatch) -> list[int]:
    """Feature width at every layer boundary: ``widths[i]`` is the input
    width of layer ``i``, ``widths[len(layers)]`` the model's output width.
    Found by running each layer on a one-node graph on the CPU (no width
    depends on the node count), so it works for any SeqLayer mix."""
    probe = _one_node_graph(graph)
    h = probe.features
    widths = [h.shape[-1]]
    with torch.no_grad():
        for layer, p in zip(model.layers, params):
            h = layer.apply({k: v.detach().cpu() for k, v in p.items()}, probe, h, None, False)
            widths.append(h.shape[-1])
    return widths


def travel_width(bounds: list[tuple[int, int]], widths: list[int]) -> int:
    """Wire width of the traveling activation: the widest stage-boundary
    width (every stage's output). The model's input width is excluded:
    stage 0 reads the features by chunk id, they never ride the wire."""
    return max(widths[hi] for _, hi in bounds)


def chunk_keys(rng: int | None, n_layers: int) -> Callable:
    """``keys(chunk, site) -> per-layer keys`` from an integer step key,
    derived as the host engine derives them (``fold_in(rng, chunk)``, then
    ``layer_keys``). Every site of a chunk, forward or recompute, gets the
    same keys."""

    def keys(chunk: int, site: str) -> list:
        return layer_keys(None if rng is None else fold_in(rng, chunk), n_layers)

    return keys


def narrow(wire: torch.Tensor, width: int) -> torch.Tensor:
    """The true-width columns of a wire activation as a fresh contiguous
    tensor. A strided view would do for the math, but it can change the
    matmul algorithm the next layer gets, and with it the low bits."""
    return wire[:, :width].clone(memory_format=torch.contiguous_format)


def to_wire(h: torch.Tensor, width: int) -> torch.Tensor:
    """``h`` zero-padded on the right to the wire width."""
    if h.shape[-1] == width:
        return h
    return torch.nn.functional.pad(h, (0, width - h.shape[-1]))


def stage_forward(model, bounds, graphs, keys, train, s):
    """``run(params, chunk, h, site) -> h_out`` at true widths: stage ``s``'s
    layers on chunk ``chunk``; stage 0 reads the chunk's features."""
    lo, hi = bounds[s]

    def run(params, chunk, h, site):
        g = graphs[chunk]
        ks = keys(chunk, site)
        h = g.features if lo == 0 else h
        for i in range(lo, hi):
            h = model.layers[i].apply(params[i], g, h, ks[i], train)
        return h

    return run


def make_gnn_stage_slices(
    model: GNNModel,
    bounds: list[tuple[int, int]],
    widths: list[int],
    graphs,
    keys: Callable,
    *,
    train: bool = True,
):
    """Params-explicit per-stage slices for the compiled engine's tick
    executors: ``slices[s](params, chunk, h_in, site="fwd") -> h_out``
    applies stage ``s``'s contiguous layer slice ``[lo, hi)`` to chunk
    ``chunk`` (``graphs[chunk]`` is its graph). ``params`` is the full
    per-layer list. ``h_in`` and ``h_out`` are padded to the uniform wire
    width (``travel_width``); ``h_in`` is narrowed back (``narrow``) before
    the first layer, and stage 0 ignores it and reads the chunk's features.
    ``keys(chunk, site)`` gives the per-layer dropout keys (``chunk_keys``
    derives the host engine's)."""
    d_travel = travel_width(bounds, widths)

    def make(s):
        run = stage_forward(model, bounds, graphs, keys, train, s)
        lo = bounds[s][0]

        def apply_slice(params, chunk, h_in, site="fwd"):
            h = None if lo == 0 else narrow(h_in, widths[lo])
            return to_wire(run(params, chunk, h, site), d_travel)

        return apply_slice

    return [make(s) for s in range(len(bounds))]


def stage_vjp(
    run, params, lo: int, hi: int, chunk: int, h, ct_of, site: str,
    *, want_params: bool, want_input: bool,
):
    """Re-materialize a stage (``run`` from ``stage_forward``) from its
    true-width input ``h`` and pull a cotangent back. ``ct_of(y)`` gives
    ``(ct, loss_sum, count)`` from the recomputed output (the loss head at
    the last stage; a fixed cotangent elsewhere). Returns ``(d_params or
    None, d_h or None, loss_sum, count)``; ``d_params`` holds the stage's
    layers only."""
    leaves = [
        {k: v.detach().requires_grad_(want_params) for k, v in p.items()}
        for p in params[lo:hi]
    ]
    full = list(params[:lo]) + leaves + list(params[hi:])
    h = None if h is None else h.detach().requires_grad_(want_input)
    flat = [v for p in leaves for v in p.values()] if want_params else []
    inputs = flat + ([h] if want_input else [])
    with torch.enable_grad():
        y = run(full, chunk, h, site)
        ct, loss_sum, count = ct_of(y)
        grads = torch.autograd.grad(y, inputs, ct, allow_unused=True) if inputs else ()
    d_params = fill_grads(leaves, grads[: len(flat)]) if want_params else None
    return d_params, (grads[-1] if want_input else None), loss_sum, count


def make_gnn_stage_slices_bw(
    model: GNNModel,
    bounds: list[tuple[int, int]],
    widths: list[int],
    graphs,
    keys: Callable,
    *,
    train: bool = True,
    loss_ct: Callable | None = None,
):
    """Split-backward (zero-bubble) halves of ``make_gnn_stage_slices``:
    the stage backward cut along its two cotangent outputs so the tick
    executor can run them at different ticks. Returns ``(b_fns, w_fns)``:

      * ``b_fns[s](params, chunk, h_in, ct) -> (d_h, residual, loss_sum,
        count)``, the B (input-gradient) half: re-materialize the stage,
        differentiate it with respect to its input only and return the
        upstream cotangent (wire width; None at stage 0, whose input is
        the features and which therefore skips the work) plus the
        ``(h_in, ct_applied)`` residual the W half needs. At the last stage
        ``loss_ct(y, chunk) -> (ct, loss_sum, count)`` derives the applied
        cotangent from the recomputed output; elsewhere the wire ``ct`` is
        applied and ``loss_sum``/``count`` are None.
      * ``w_fns[s](params, chunk, residual) -> d_params``, the W half:
        re-materialize from the residual's input and differentiate with
        respect to the stage's params (the stage's layers only).

    B and W are separate draw sites (``"bwd_b"``, ``"bwd_w"``) of the same
    keys, so both recomputes redraw the forward's masks."""
    d_travel = travel_width(bounds, widths)
    n_stages = len(bounds)

    def make(s):
        lo, hi = bounds[s]
        run = stage_forward(model, bounds, graphs, keys, train, s)
        last = s == n_stages - 1 and loss_ct is not None
        w_out = widths[hi]

        def b_fn(params, chunk, h_in, ct):
            applied = []

            def ct_of(y):
                if last:
                    out = loss_ct(y, chunk)
                else:
                    out = (narrow(ct, w_out), None, None)
                applied.append(out[0])
                return out

            if lo == 0:  # the features need no cotangent: nothing to pull back
                if not last:
                    return None, (None, ct), None, None
                with torch.no_grad():  # a one-stage pipeline still owes its loss
                    _, loss_sum, count = ct_of(run(params, chunk, None, "bwd_b"))
                return None, (None, to_wire(applied[0], d_travel)), loss_sum, count
            h = narrow(h_in, widths[lo])
            _, d_h, loss_sum, count = stage_vjp(
                run, params, lo, hi, chunk, h, ct_of, "bwd_b",
                want_params=False, want_input=True,
            )
            residual = (h_in, to_wire(applied[0], d_travel) if last else ct)
            return to_wire(d_h, d_travel), residual, loss_sum, count

        def w_fn(params, chunk, residual):
            h_in, ct = residual
            h = None if lo == 0 else narrow(h_in, widths[lo])
            ct_true = narrow(ct, w_out)
            d_params, _, _, _ = stage_vjp(
                run, params, lo, hi, chunk, h, lambda y: (ct_true, None, None), "bwd_w",
                want_params=True, want_input=False,
            )
            return d_params

        return b_fn, w_fn

    halves = [make(s) for s in range(n_stages)]
    return [b for b, _ in halves], [w for _, w in halves]
