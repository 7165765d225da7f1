"""The port's model zoo against the JAX package: the ``dense`` backend,
GraphConv and GatedGraphConv, on the CPU at small sizes (karate).

Inputs come from numpy seeds and params from the JAX init through
``params_from_jax``. Across frameworks: rtol/atol 1e-5 in fp32 (the two sum
in other orders); layer names exactly. Inside the port: ``dense`` matches
``padded`` within the same tolerance, and the compiled engine is
bit-identical to host fill-drain with dropout on.
"""
# ruff: noqa: E402

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests
import jax.numpy as jnp

import repro.graphs as jg
from repro.core import microbatch as jmb
from repro.core.pipeline import GPipeConfig as JConfig
from repro.core.pipeline import make_engine as j_make_engine
from repro.models.gnn import layers as jlayers
from repro.models.gnn import net as jnet
from repro.train import optimizer as jopt
import repro_torch.graphs as tg
from repro_torch.core import microbatch as tmb
from repro_torch.core.costmodel import uniform_balance
from repro_torch.core.pipeline import GPipeConfig, make_engine
from repro_torch.graphs import partition as tpart
from repro_torch.models.gnn import layers as tlayers
from repro_torch.models.gnn import net as tnet
from repro_torch.models.gnn.convert import params_from_jax
from repro_torch.train import optimizer as topt

TOL = dict(rtol=1e-5, atol=1e-5)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def trees_equal(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


@pytest.fixture(scope="module")
def karate():
    return tg.load_dataset("karate"), jg.load_dataset("karate")


def _layer_case(kind, tgraph, jgraph, backend):
    """(JAX layer fn, port layer fn, JAX params, port params, input width)."""
    key = jax.random.PRNGKey(3)
    d = 8
    if kind == "gcn":
        jp = jlayers.init_gcn(key, tgraph.num_features, d)
        jf = lambda p, h: jlayers.gcn_layer(p, jgraph, h, backend=backend)  # noqa: E731
        tf = lambda p, h: tlayers.gcn_layer(p, tgraph, h, backend=backend)  # noqa: E731
    elif kind == "gat":
        jp = jlayers.init_gat(key, tgraph.num_features, d, heads=4)
        jf = lambda p, h: jlayers.gat_layer(p, jgraph, h, backend=backend)  # noqa: E731
        tf = lambda p, h: tlayers.gat_layer(p, tgraph, h, backend=backend)  # noqa: E731
    elif kind == "graphconv":
        jp = jlayers.init_graph_conv(key, tgraph.num_features, d)
        jf = lambda p, h: jlayers.graph_conv_layer(p, jgraph, h, backend=backend)  # noqa: E731
        tf = lambda p, h: tlayers.graph_conv_layer(p, tgraph, h, backend=backend)  # noqa: E731
    else:  # gated: width-preserving, so its input is projected features
        jp = jlayers.init_gated_graph_conv(key, d)
        jf = lambda p, h: jlayers.gated_graph_conv_layer(p, jgraph, h, backend=backend)  # noqa: E731
        tf = lambda p, h: tlayers.gated_graph_conv_layer(p, tgraph, h, backend=backend)  # noqa: E731
    width = d if kind == "gated" else tgraph.num_features
    (tp,) = params_from_jax([jax.tree_util.tree_map(np.asarray, jp)])
    return jf, tf, jp, tp, width


@pytest.mark.parametrize("kind, backend", [
    ("gcn", "dense"), ("gat", "dense"), ("graphconv", "padded"), ("graphconv", "dense"),
    ("gated", "padded"), ("gated", "dense"),
])
def test_layer_forward_and_grads_match_jax(karate, kind, backend):
    """Each layer against the reference's same backend (GCN and GAT on
    ``padded`` are ``test_torch_train.py``'s): output, and the gradients of
    a random projection of it with respect to every param leaf and the
    input."""
    tgraph, jgraph = karate
    jf, tf, jp, tp, width = _layer_case(kind, tgraph, jgraph, backend)
    rng = np.random.default_rng(7)
    h = rng.standard_normal((tgraph.num_nodes, width)).astype(np.float32)
    out = np.asarray(jf(jp, jnp.asarray(h)))
    ct = rng.standard_normal(out.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jf(p, x) * ct)

    jgp, jgh = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(h))
    leaves = topt.requires_grad_leaves([tp])
    x = torch.from_numpy(h).requires_grad_(True)
    tout = tf(leaves[0], x)
    close(tout.detach(), out)
    grads = torch.autograd.grad((tout * torch.from_numpy(ct)).sum(), [*leaves[0].values(), x])
    for k, g in zip(leaves[0], grads):
        close(g, jgp[k])
    close(grads[-1], jgh)


@pytest.mark.parametrize("kind", ["gcn", "gat", "graphconv", "gated"])
def test_dense_equals_padded_in_the_port(karate, kind):
    """Output and the gradients with respect to every param leaf and the
    input."""
    tgraph, jgraph = karate
    _, tf_dense, _, tp, width = _layer_case(kind, tgraph, jgraph, "dense")
    _, tf_padded, _, _, _ = _layer_case(kind, tgraph, jgraph, "padded")
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((tgraph.num_nodes, width)).astype(np.float32))
    outs = []
    for fn in (tf_dense, tf_padded):
        (leaves,) = topt.requires_grad_leaves([tp])
        x = h.clone().requires_grad_(True)
        out = fn(leaves, x)
        ct = torch.from_numpy(np.random.default_rng(2).standard_normal(
            tuple(out.shape)).astype(np.float32))
        outs.append((out.detach(), torch.autograd.grad((out * ct).sum(), [*leaves.values(), x])))
    (od, gd), (op, gp) = outs
    close(od, op)
    for a, b in zip(gd, gp):
        close(a, b)


def test_dense_adjacency_keeps_real_edges_to_row_zero(karate):
    """Padding slots point at row 0 with mask False and norm 0: the max
    decides duplicates, so a real edge to row 0 survives them."""
    tgraph, _ = karate
    adj, norm = tlayers._dense_adj(tgraph), tlayers._dense_norm(tgraph)
    nbr, msk, nrm = tgraph.neighbors.long(), tgraph.mask, tgraph.norm
    want = torch.zeros_like(norm)
    for i in range(tgraph.num_nodes):
        want[i, nbr[i][msk[i]]] = nrm[i][msk[i]]
    assert torch.equal(norm, want) and torch.equal(adj, want > 0)
    assert adj[0, 0] and int(adj.sum()) == int(msk.sum())


@pytest.mark.parametrize("kind", ["gcn", "graphconv", "gatedgraphconv"])
def test_build_gnn_layer_names_match_jax(kind):
    for depth in (2, 3):
        jm = jnet.build_gnn(kind, 34, 2, hidden=8, depth=depth)
        tm = tnet.build_gnn(kind, 34, 2, hidden=8, depth=depth)
        assert [layer.name for layer in tm.layers] == [layer.name for layer in jm.layers]
        jshapes = [{k: v.shape for k, v in p.items()}
                   for p in jm.init_params(jax.random.PRNGKey(0))]
        assert [{k: tuple(v.shape) for k, v in p.items()} for p in tm.init_params(0)] == jshapes
    with pytest.raises(KeyError):
        tnet.build_gnn("nope", 34, 2)


def _zoo_pair(kind, g, backend):
    """(JAX model, port model) with dropout off; ``kind`` ``gat`` is the
    paper model."""
    jb = "pallas" if backend == "kernel" else backend
    if kind == "gat":
        kw = dict(feat_dropout=0.0, attn_dropout=0.0)
        return (jnet.build_paper_gat(g.num_features, g.num_classes, backend=jb, **kw),
                tnet.build_paper_gat(g.num_features, g.num_classes, backend=backend, **kw))
    kw = dict(hidden=8, depth=2)
    return (jnet.build_gnn(kind, g.num_features, g.num_classes, backend=jb, **kw),
            tnet.build_gnn(kind, g.num_features, g.num_classes, backend=backend, **kw))


@pytest.mark.parametrize("kind, backend", [
    ("graphconv", "padded"), ("gatedgraphconv", "dense"), ("gatedgraphconv", "kernel"),
    ("gat", "dense"),
])
def test_host_fill_drain_three_steps_match_jax(karate, kind, backend):
    """Three host fill-drain steps on 4 halo chunks against the JAX GPipe
    engine (under ``kernel`` the GatedGraphConv projections run the SpMM
    op over the bucketed layout on both sides). SGD, not Adam: Adam's
    first steps scale each update to about ``lr`` whatever the gradient's
    size, so a leaf whose gradient is near 0 turns summation-order noise
    into 1e-5-sized parameter differences (Adam's own parity is
    ``test_torch_train.py``'s)."""
    tgraph, jgraph = karate
    jm, tm = _zoo_pair(kind, tgraph, backend)
    balance = uniform_balance(len(tm.layers), 4)
    jeng = j_make_engine(jm, JConfig(balance=balance, chunks=4,
                                     backend="pallas" if backend == "kernel" else backend))
    teng = make_engine(tm, GPipeConfig(balance=balance, chunks=4, backend=backend, device="cpu"))
    jplan = jmb.make_plan(jgraph, 4, strategy="halo")
    tplan = tmb.make_plan(tgraph, 4, strategy="halo")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    jo, to = jopt.sgd(0.05, momentum=0.9), topt.sgd(0.05, momentum=0.9)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        jp, js, jloss = jeng.train_step(jp, js, jplan, jax.random.PRNGKey(step), jo)
        tp, ts, tloss = teng.train_step(tp, ts, tplan, step, to)
        close(tloss, jloss)
        for t, j in zip(tp, jp):
            for k in t:
                close(t[k], j[k])


@pytest.mark.parametrize("kind, backend", [
    ("graphconv", "padded"), ("gatedgraphconv", "kernel"), ("gat", "dense"),
    ("gatedgraphconv", "dense"),
])
@pytest.mark.parametrize("schedule", ["fill_drain", "zb-h1"])
def test_compiled_bit_identical_to_host(karate, kind, backend, schedule):
    """Three steps with dropout on (the dense GAT keeps the paper's 0.6 on
    features and attention): the compiled engine's losses and params equal
    host fill-drain's bit for bit."""
    tgraph, _ = karate
    if kind == "gat":
        model = tnet.build_paper_gat(tgraph.num_features, tgraph.num_classes, backend=backend)
    else:
        model = tnet.build_gnn(kind, tgraph.num_features, tgraph.num_classes, hidden=8,
                               backend=backend)
    balance = uniform_balance(len(model.layers), 4)
    plan = tmb.make_plan(tgraph, 4, strategy="halo")
    runs = []
    for engine, sched in (("host", "fill_drain"), ("compiled", schedule)):
        eng = make_engine(model, GPipeConfig(balance=balance, chunks=4, schedule=sched,
                                             engine=engine, backend=backend, device="cpu"))
        opt = topt.adam(5e-3, weight_decay=5e-4)
        params = model.init_params(0)
        state = opt.init(params)
        losses = []
        for step in range(3):
            params, state, loss = eng.train_step(params, state, plan, 11 + step, opt)
            losses.append(loss)
        runs.append((params, losses, eng.evaluate(params, plan)))
    (hp, hl, he), (cp, cl, ce) = runs
    assert all(torch.equal(a, b) for a, b in zip(hl, cl))
    assert trees_equal(cp, hp)
    assert {k: float(v) for k, v in ce.items()} == {k: float(v) for k, v in he.items()}


def test_kernel_backend_keeps_bucketed_layout_for_graph_layers(karate):
    """Under ``kernel`` the GraphConv and GatedGraphConv layers read the
    bucketed wrapper's padded fields, so their output equals ``padded``."""
    tgraph, _ = karate
    layout = tpart.degree_bucketed_layout(tgraph)
    for kind in ("graphconv", "gatedgraphconv"):
        km = tnet.build_gnn(kind, tgraph.num_features, tgraph.num_classes, hidden=8,
                            backend="kernel")
        pm = tnet.build_gnn(kind, tgraph.num_features, tgraph.num_classes, hidden=8)
        params = pm.init_params(0)
        close(km.apply(params, layout), pm.apply(params, tgraph))
