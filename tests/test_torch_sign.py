"""The port's SIGN precompute against the JAX package's, and the exactness
claim under sequential chunking, on the CPU (karate).

Features from both packages' karate agree within rtol/atol 1e-5 (the two
sum the diffusion in other orders); layer names and shapes exactly. One
sign-MLP step over 4 sequential chunks equals the full-batch step within
1e-5 (``tests/test_sign.py``'s claim, held in the port).
"""
# ruff: noqa: E402

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests

import repro.graphs as jg
from repro.graphs import sign as jsign
import repro_torch.graphs as tg
from repro_torch.core import microbatch as tmb
from repro_torch.core.pipeline import GPipeConfig, make_engine
from repro_torch.graphs import sign as tsign
from repro_torch.train import losses as tlosses
from repro_torch.train import optimizer as topt

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def karate():
    return tg.load_dataset("karate"), jg.load_dataset("karate")


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_sign_features_and_graph_match_jax(karate, hops):
    tgraph, jgraph = karate
    np.testing.assert_allclose(tsign.sign_features(tgraph, hops=hops),
                               np.asarray(jsign.sign_features(jgraph, hops=hops)), **TOL)
    t, j = tsign.as_sign_graph(tgraph, hops=hops), jsign.as_sign_graph(jgraph, hops=hops)
    np.testing.assert_allclose(t.features, np.asarray(j.features), **TOL)
    for name in ("neighbors", "mask", "norm", "labels", "train_mask"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t.features.shape == (tgraph.num_nodes, (hops + 1) * tgraph.num_features)


def test_sign_mlp_names_and_shapes_match_jax():
    jm = jsign.build_sign_mlp(102, 2, hidden=16)
    tm = tsign.build_sign_mlp(102, 2, hidden=16)
    assert [layer.name for layer in tm.layers] == [layer.name for layer in jm.layers]
    jshapes = [{k: v.shape for k, v in p.items()} for p in jm.init_params(jax.random.PRNGKey(0))]
    assert [{k: tuple(v.shape) for k, v in p.items()} for p in tm.init_params(0)] == jshapes
    with pytest.raises(ValueError, match="repro_torch.graphs.sign"):
        tmb.make_plan(tg.load_dataset("karate"), 2, strategy="sign")


def test_sign_chunking_is_exact_even_sequential(karate):
    """With SIGN the paper's lossy sequential split loses nothing: one step
    over 4 sequential chunks equals the full-batch step (dropout off: the
    claim is about batching, not the masks)."""
    g = tsign.as_sign_graph(karate[0], hops=2)
    m = tsign.build_sign_mlp(g.num_features, g.num_classes, hidden=16, dropout=0.0)
    params = m.init_params(0)
    opt = topt.adam(1e-2)
    leaves = topt.requires_grad_leaves(params)
    ref_loss = tlosses.masked_nll(m.apply(leaves, g, train=True), g.labels, g.train_mask)
    upd, _ = opt.update(topt.tree_grad(ref_loss, leaves), opt.init(params), params)
    want = topt.apply_updates(params, upd)

    pipe = make_engine(m, GPipeConfig(balance=(2, 2), chunks=4, device="cpu"))
    plan = tmb.make_plan(g, 4, strategy="sequential")
    assert plan.edge_cut == 0.0  # nothing left to lose: structure-free
    got, _, loss = pipe.train_step(params, opt.init(params), plan, 1, opt)
    assert abs(float(loss) - float(ref_loss.detach())) < 1e-5
    for a, b in zip(topt.tree_leaves(got), topt.tree_leaves(want)):
        np.testing.assert_allclose(a, b.detach(), rtol=0, atol=1e-5)
