"""The port's npz checkpoints: round trips (bf16 included) and the JAX
package's on-disk format in both directions, on the CPU.

Arrays must come back bit-identical, ``step`` and ``dtypes`` equal, whichever
package wrote the file.
"""
# ruff: noqa: E402

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests
import jax.numpy as jnp

from repro.train import checkpoint as jckpt
from repro_torch.models.gnn.net import build_paper_gat
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt


def _tree():
    gen = torch.Generator().manual_seed(0)
    return [
        {},
        {"w": torch.randn((4, 3), generator=gen), "b": torch.zeros(3)},
        {"w": torch.randn((5,), generator=gen).to(torch.bfloat16),
         "n": torch.arange(6, dtype=torch.int32).reshape(2, 3)},
    ]


def test_round_trip_with_bf16_and_adam_state(tmp_path):
    model = build_paper_gat(34, 2)
    params = model.init_params(0)
    state = topt.adam(5e-3).init(params)
    tree = {"params": params, "opt": state, "extra_leaf": _tree()}
    tckpt.save_checkpoint(str(tmp_path), tree, step=7, extra={"dataset": "karate"})
    loaded, meta = tckpt.load_checkpoint(str(tmp_path))
    assert meta["step"] == 7 and meta["dataset"] == "karate"
    assert meta["dtypes"] == {"extra_leaf.2.w": "bfloat16"}
    assert meta["treedef"].startswith("repro_torch ")
    back = tckpt.tree_like(tree, loaded)
    assert isinstance(back["opt"], type(state)) and back["params"][0] == {}
    flat_a, flat_b = tckpt._flatten(tree), tckpt._flatten(back)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert flat_a[k].dtype == flat_b[k].dtype and torch.equal(flat_a[k], flat_b[k]), k


def test_reference_file_loads_into_the_port(tmp_path):
    rng = np.random.default_rng(0)
    jtree = [{}, {"w": jnp.asarray(rng.standard_normal((4, 3)), jnp.float32)},
             {"w": jnp.asarray(rng.standard_normal((5,)), jnp.bfloat16),
              "n": jnp.arange(6, dtype=jnp.int32)}]
    jckpt.save_checkpoint(str(tmp_path), jtree, step=3)
    loaded, meta = tckpt.load_checkpoint(str(tmp_path))
    jloaded, jmeta = jckpt.load_checkpoint(str(tmp_path))
    assert (meta["step"], meta["dtypes"]) == (jmeta["step"], jmeta["dtypes"]) == (
        3, {"2.w": "bfloat16"})
    assert loaded.keys() == jloaded.keys() == {"1", "2"}
    for layer in loaded:
        for k, t in loaded[layer].items():
            j = jloaded[layer][k]
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
            np.testing.assert_array_equal(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                                          else t.numpy(),
                                          np.asarray(j).view(np.int16) if j.dtype == jnp.bfloat16
                                          else np.asarray(j))


def test_port_file_loads_into_the_reference(tmp_path):
    tree = _tree()
    tckpt.save_checkpoint(str(tmp_path), tree, step=11, extra={"note": "x"})
    jloaded, jmeta = jckpt.load_checkpoint(str(tmp_path))
    assert jmeta["step"] == 11 and jmeta["dtypes"] == {"2.w": "bfloat16"}
    assert jmeta["note"] == "x"
    for layer, p in enumerate(tree):
        for k, t in p.items():
            j = jloaded[str(layer)][k]
            assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
            want = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
            got = np.asarray(j).view(np.int16) if j.dtype == jnp.bfloat16 else np.asarray(j)
            np.testing.assert_array_equal(got, want)
