"""The port's copies of the framework-free config and data modules equal
the JAX package's: every arch's fields, parameter count, layer kinds and
windows (full and smoke), the shape table, the pipeline padding and stacked
shape plans, and the synthetic token stream."""

import dataclasses

import numpy as np
import pytest

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.configs.base import pipeline_padding as jax_padding
from repro.data.tokens import token_batch as jax_token_batch
from repro.models.transformer.model import stacked_shape_plan as jax_plan
from repro_torch.configs.base import pipeline_padding
from repro_torch.data.tokens import token_batch
from repro_torch.models.transformer.model import stacked_shape_plan

ARCHS = jconfigs.list_archs()


def test_same_registry():
    assert tconfigs.list_archs() == ARCHS and len(ARCHS) == 10
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_matches(arch, smoke):
    got, want = tconfigs.get_arch(arch, smoke=smoke), jconfigs.get_arch(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.layer_kinds() == want.layer_kinds()
    for long_context in (False, True):
        assert got.layer_windows(long_context=long_context) == \
            want.layer_windows(long_context=long_context)
    for stages in (1, 2, 4):
        assert stacked_shape_plan(got, stages) == jax_plan(want, stages)


def test_full_widths_of_the_served_archs():
    qwen = tconfigs.get_arch("codeqwen1.5-7b")
    assert (qwen.num_layers, qwen.d_model, qwen.num_heads, qwen.head_dim, qwen.d_ff,
            qwen.vocab_size) == (32, 4096, 32, 128, 13440, 92416)
    mamba = tconfigs.get_arch("mamba2-130m")
    assert (mamba.num_layers, mamba.d_model, mamba.ssm_state, mamba.ssm_chunk,
            mamba.vocab_size) == (24, 768, 128, 128, 50280)


def test_pipeline_padding_matches():
    for layers in (1, 2, 5, 24, 46, 61):
        for stages in (1, 2, 3, 4, 16):
            assert pipeline_padding(layers, stages) == jax_padding(layers, stages)


@pytest.mark.parametrize("batch,seq,vocab,seed,step", [(4, 32, 512, 0, 0), (3, 7, 92416, 5, 2),
                                                       (1, 513, 50280, 1, 0)])
def test_token_batch_matches(batch, seq, vocab, seed, step):
    got = token_batch(batch=batch, seq=seq, vocab=vocab, seed=seed, step=step)
    want = jax_token_batch(batch=batch, seq=seq, vocab=vocab, seed=seed, step=step)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
