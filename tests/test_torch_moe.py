"""The MoE layer against the JAX package, at smoke size on the CPU.

From the JAX ``moe_init`` carried across by ``params_from_jax``: ``_route``
for both router kinds (the top-k indices exactly, after checking that every
token's k-th and (k+1)-th selection scores are more than 1e-6 apart, so
that the choice is not a near tie), ``_dispatch_tables`` exactly, and
``moe_apply`` with its gradients within 1e-5, at the default capacity and
at ``capacity_factor=0.5``, where tokens are dropped; and the port's own
init of both MoE archs against the JAX ``init_params`` tree. The whole
archs are held to the JAX steps by the parametrized tests of
``tests/test_torch_serve_lm.py`` (the greedy loop) and
``tests/test_torch_lm_train.py`` (three train steps, and arctic's 1 vs 2
stages bit for bit).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests
import jax.numpy as jnp

from repro.configs import get_arch as jax_arch
from repro.models.transformer import model as JM
from repro.models.transformer import moe as JMoE
from repro_torch.configs import get_arch
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer import moe as TMoE
from repro_torch.models.transformer.convert import params_from_jax
from repro_torch.train.optimizer import tree_map

ARCHS = ["arctic-480b", "deepseek-v3-671b"]
ATOL = 1e-5
TIE_GAP = 1e-6  # the least gap between a token's k-th and (k+1)-th score
TOKENS = 64  # one call's tokens in the layer tests


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size ops on one intra-op thread: the suite's parallel workers
    oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rng_array(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=atol)


def flat(tree, prefix=""):
    """{path: numpy leaf} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().numpy().copy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    return out


# ------------------------------------------------------------ the layer --


def moe_kwargs(cfg):
    return dict(num_experts=cfg.num_experts, k=cfg.experts_per_token,
                router_kind=cfg.router_kind, mlp_kind=cfg.mlp_kind)


def layer(arch):
    """(config, numpy MoE params from the JAX ``moe_init``, tokens (T, d)).
    The sigmoid router's bias, zeros at init, is drawn so that it moves
    the selection."""
    cfg = get_arch(arch, smoke=True)
    p = jax.tree_util.tree_map(np.asarray, JMoE.moe_init(
        jax.random.PRNGKey(3), cfg.d_model, cfg.d_ff, num_experts=cfg.num_experts,
        num_shared=cfg.num_shared_experts, dense_residual=cfg.moe_dense_residual,
        router_kind=cfg.router_kind, mlp_kind=cfg.mlp_kind, dtype=jnp.float32))
    if "router_bias" in p:
        p["router_bias"] = rng_array(p["router_bias"].shape, 4, 0.02)
    return cfg, p, rng_array((TOKENS, cfg.d_model), 5)


def assert_no_near_tie(p, x, cfg):
    """Every token's k-th and (k+1)-th selection scores differ by more than
    ``TIE_GAP``: top-k is discontinuous, so the exact comparison of the
    routing means something only away from ties."""
    logits = x @ p["router"]
    if cfg.router_kind == "sigmoid":
        sel = 1.0 / (1.0 + np.exp(-logits)) + p["router_bias"][None, :]
    else:
        sel = np.exp(logits - logits.max(-1, keepdims=True))
        sel /= sel.sum(-1, keepdims=True)
    top = -np.sort(-sel, axis=-1)
    gap = top[:, cfg.experts_per_token - 1] - top[:, cfg.experts_per_token]
    worst = int(gap.argmin())
    assert gap[worst] > TIE_GAP, f"token {worst}: k-th and (k+1)-th scores {gap[worst]} apart"


@pytest.mark.parametrize("arch", ARCHS)
def test_route_and_dispatch_tables_match_jax(arch):
    cfg, p, x = layer(arch)
    assert_no_near_tie(p, x, cfg)
    k, e = cfg.experts_per_token, cfg.num_experts
    idx, w, aux = TMoE._route(params_from_jax(p), torch.from_numpy(x), k=k,
                              router_kind=cfg.router_kind)
    j_idx, j_w, j_aux = JMoE._route(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                                    k=k, router_kind=cfg.router_kind)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    close(w, j_w)
    close(aux, j_aux)
    for factor in (1.25, 0.5):
        capacity = max(8, int(np.ceil(TOKENS * k / e * factor)))
        tok, wt, inverse = TMoE._dispatch_tables(idx, w, num_experts=e, capacity=capacity)
        j_tok, j_wt = JMoE._dispatch_tables(j_idx, j_w, num_experts=e, e0=0, e_local=e,
                                            capacity=capacity)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
        np.testing.assert_array_equal(wt.numpy() == 0, np.asarray(j_wt) == 0)
        close(wt, j_wt)
        # the inverse map: each kept pair's slot holds its token and weight
        kept = inverse < e * capacity
        rows = np.nonzero(kept.numpy())
        np.testing.assert_array_equal(tok.reshape(-1)[inverse[kept]].numpy(), rows[0])
        np.testing.assert_array_equal(wt.reshape(-1)[inverse[kept]].numpy(), w[kept].numpy())
        assert int(kept.sum()) == int((np.asarray(j_wt) != 0).sum())
        if factor == 0.5:
            assert not bool(kept.all())  # tokens were dropped


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_and_its_gradients_match_jax(arch, factor):
    """The output and the gradients of a random projection of it, as to the
    tokens and every leaf (router, experts, shared or dense FFN)."""
    cfg, p, x = layer(arch)
    r = rng_array((TOKENS, cfg.d_model), 6)
    kw = moe_kwargs(cfg)

    def j_loss(p, x):
        out, _ = JMoE.moe_apply(p, x, capacity_factor=factor, **kw)
        return (out * r).sum(), out

    (_, j_out), (j_gp, j_gx) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = tree_map(lambda t: t.requires_grad_(True), params_from_jax(p))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = TMoE.moe_apply(tp, tx, capacity_factor=factor, **kw)
    (out * torch.from_numpy(r)).sum().backward()
    close(out.detach(), j_out)
    close(tx.grad, j_gx)
    # the router bias only selects (no gradient reaches it): zeros in JAX
    got = flat(tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, tp))
    want = flat(j_gp)
    assert set(got) == set(want)
    for name in want:
        scale = float(np.abs(want[name]).max())
        assert float(np.abs(got[name] - want[name]).max()) <= ATOL * max(scale, 1.0), name


# The reference's expert-parallel call on a ("data",) mesh of 2 forced host
# devices, in a process of its own (the device count is set before JAX starts).
EP_SCRIPT = r"""
import os, pickle, sys
# one compute thread: the suite's workers share the cores
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.core import compat
from repro.models.transformer import moe as JMoE
with open(sys.argv[1], "rb") as f:
    p, x, kw = pickle.load(f)
mesh = jax.make_mesh((2,), ("data",), axis_types=(AxisType.Auto,))
p = jax.tree_util.tree_map(jnp.asarray, p)
spec = {k: P("data") if k.startswith("we_") else jax.tree_util.tree_map(lambda _: P(), v)
        for k, v in p.items()}
out = {}
for mode in ("gathered", "a2a"):
    fn = lambda p, x: JMoE.moe_apply(p, x, ep_axis="data", ep_size=2, mode=mode, **kw)[0]
    sharded = compat.shard_map(fn, mesh=mesh, in_specs=(spec, P("data")), out_specs=P("data"))
    out[mode] = np.asarray(jax.jit(sharded)(p, jnp.asarray(x)))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _ep_rank(rank, port, p, x, kw, out_dir):
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.core.data_group import DataGroup
    from repro_torch.core.ranks import RankGrid

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=60))
    try:
        group = DataGroup(2, RankGrid(2, 1))
        own = {k: v.chunk(2)[rank] if k.startswith("we_") else v for k, v in p.items()}
        out = {mode: TMoE.moe_apply(own, x.chunk(2)[rank], ep_axis=group, mode=mode, **kw)[0]
               for mode in ("gathered", "a2a")}
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def test_moe_apply_refuses_expert_parallel():
    """``moe_apply`` refuses an expert-parallel call it cannot run: a data
    group (``ep_axis``) that does not split the experts, or a mode that is
    not one of the reference's three."""
    from repro_torch.core.data_group import DataGroup

    cfg, p, x = layer("arctic-480b")
    kw = moe_kwargs(cfg)
    with pytest.raises(ValueError, match="do not split"):
        TMoE.moe_apply(params_from_jax(p), torch.from_numpy(x), ep_axis=DataGroup(3), **kw)
    with pytest.raises(ValueError, match="moe mode"):
        TMoE.moe_apply(params_from_jax(p), torch.from_numpy(x), ep_axis=DataGroup(2),
                       mode="scattered", **kw)


def test_moe_apply_expert_parallel_matches_jax_dp2():
    """``moe_apply`` over a data group (``ep_axis``) on a 2-rank gloo world,
    each rank holding half of arctic's experts and half of the tokens: the
    ``gathered`` and ``a2a`` modes equal the reference's dp 2 call
    (``ep_axis`` on a 2-device mesh) within 1e-5."""
    import os
    import pickle
    import socket
    import subprocess
    import sys
    import tempfile

    import torch.multiprocessing as mp

    cfg, p, x = layer("arctic-480b")
    kw = moe_kwargs(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump((p, x, kw), f)
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": f"{root}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}
        ref = subprocess.Popen([sys.executable, "-c", EP_SCRIPT, src, dst], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        try:
            mp.start_processes(_ep_rank, args=(port, params_from_jax(p), torch.from_numpy(x),
                                               kw, tmp), nprocs=2, start_method="spawn")
            log, _ = ref.communicate(timeout=120)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
        assert ref.returncode == 0, log
        with open(dst, "rb") as f:
            want = pickle.load(f)
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    for mode in ("gathered", "a2a"):
        close(torch.cat([g[mode] for g in got]), want[mode])


# ---------------------------------------------------------- whole archs --


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's own init builds the reference's leaves and shapes
    (``moe/*``, ``router_bias``, MLA's ``w_dq``…``w_uv``, ``mtp_proj``)."""
    shapes = jax.eval_shape(lambda key: JM.init_params(jax_arch(arch, smoke=True), key,
                                                       num_stages=2), jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in flat(jax.tree_util.tree_map(
        lambda a: np.empty(a.shape, np.float32), shapes)).items()}
    got = {k: v.shape for k, v in flat(TM.init_params(get_arch(arch, smoke=True),
                                                      num_stages=2)).items()}
    assert got == want
