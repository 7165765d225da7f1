"""The port's schedules against the JAX package's: exact equality.

``repro_torch.core.schedule`` is the JAX package's numpy-only module carried
over whole, so every timeline, bubble fraction, peak-live count, predicted
step time and lowered index array must be identical — no tolerance.
"""
# ruff: noqa: E402

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX side of the parity tests

from repro.core import schedule as jsched
from repro_torch.core import schedule as tsched

SCHEDULES = ("fill_drain", "gpipe", "1f1b", "interleaved", "zb-h1", "zb-v")
ROUND_ROBIN = ("interleaved", "zb-v")  # placed on num_devices=2


def _pair(name):
    nd = 2 if name in ROUND_ROBIN else None
    return (jsched.get_schedule(name, num_devices=nd), tsched.get_schedule(name, num_devices=nd))


def _items(timeline):
    return [(it.tick, it.stage, it.chunk, it.phase, it.device) for it in timeline]


def _lowered_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
        else:
            assert x == y, f.name


def test_registry_matches():
    assert tsched.SCHEDULES == jsched.SCHEDULES == SCHEDULES


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("C", [1, 4, 8])
def test_schedule_accounting_and_lowering_identical(name, S, C):
    js, ts = _pair(name)
    try:
        jt = js.timeline(S, C)
    except (ValueError, KeyError) as exc:
        with pytest.raises(type(exc)):
            ts.timeline(S, C)
        return
    tt = ts.timeline(S, C)
    assert _items(tt) == _items(jt)
    tsched.validate_timeline(tt, S, C)
    assert ts.bubble_fraction(S, C) == js.bubble_fraction(S, C)
    assert ts.peak_live_activations(S, C) == js.peak_live_activations(S, C)
    assert tsched.peak_live_activations(tt) == jsched.peak_live_activations(jt)
    assert ts.describe(S, C) == js.describe(S, C)
    costs = dict(fwd_cost_per_chunk=1.3, bwd_cost_per_chunk=2.1, transfer_cost=0.2,
                 rebuild_cost_per_chunk=0.05)
    assert ts.predicted_step_time(S, C, **costs) == js.predicted_step_time(S, C, **costs)
    _lowered_equal(tsched.lower_timeline(tt, S, C), jsched.lower_timeline(jt, S, C))
    rt, rj = tsched.retime_timeline(tt, S, C), jsched.retime_timeline(jt, S, C)
    assert _items(rt) == _items(rj)
    _lowered_equal(tsched.lower_timeline(rt, S, C, wire_latency=2),
                   jsched.lower_timeline(rj, S, C, wire_latency=2))


@pytest.mark.parametrize("S, C", [(2, 4), (4, 8)])
def test_fill_drain_shorthand_and_rotated_placement_identical(S, C):
    assert tsched.bubble_fraction(S, C) == jsched.bubble_fraction(S, C)
    assert _items(tsched.fill_drain_timeline(S, C)) == _items(jsched.fill_drain_timeline(S, C))
    kw = dict(fwd_cost_per_chunk=3.0, bwd_cost_per_chunk=5.0, rebuild_cost_per_chunk=0.5)
    assert tsched.predicted_step_time(S, C, **kw) == jsched.predicted_step_time(S, C, **kw)
    tp = tsched.Placement.ring(S, rotation=1)
    jp = jsched.Placement.ring(S, rotation=1)
    assert tp.stage_to_device == jp.stage_to_device
    tt = tp.apply(tsched.get_schedule("1f1b").timeline(S, C))
    jt = jp.apply(jsched.get_schedule("1f1b").timeline(S, C))
    assert _items(tt) == _items(jt)
    _lowered_equal(tsched.lower_timeline(tt, S, C), jsched.lower_timeline(jt, S, C))
    with pytest.raises(ValueError, match="ring-compatible"):
        tsched.Placement((0, 2, 1, 3)).validate(4)
