"""The yardstick's arithmetic on hand-built inputs: TF32 rounding, the work
counts, the window's busy and idle time, and each per-layer reader."""

import pytest
import torch
from conftest import ROOT

from gnnbench import costs
from gnnbench.harness import Reading, load_module
from gnnbench.reference.common import tf32
from gnnbench.trace import Window, union

H100 = costs.PEAKS["NVIDIA H100 80GB HBM3"]


def reader(name):
    return load_module(ROOT / "gnnbench" / "metrics" / f"{name}.py", "m_" + name.replace(".", "_"))


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-12)])
    assert tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0]


def test_union_and_gaps():
    assert union([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    w = Window(window_s=10.0, busy_s=3.0, device=[("k_a", 1.0, 2.0), ("k_b", 1.4, 3.0),
                                                   ("k_a", 6.0, 6.5)],
               spans=[("step", 0.0, 5.0), ("pass", 5.0, 10.0)],
               gaps=[(0.0, 1.0), (3.0, 6.0), (6.5, 10.0)])
    assert w.seconds_of(("k_a",)) == 1.5
    b = w.breakdown()
    assert b["device_ops"] == [["k_b", pytest.approx(1.6)], ["k_a", 1.5]]
    assert b["idle_gaps"] == [["pass", 3.5], ["step", 3.0], ["step", 1.0]]


class _Chunk:
    def __init__(self, num_nodes, live):
        self.num_nodes, self.live = num_nodes, live


def test_gat_and_gcn_counts():
    from gnnbench.reference import gat, gcn

    cfg = {"heads": 2, "hidden_per_head": 3, "output_heads": 2, "num_features": 4,
           "num_classes": 5}
    w = gat.work(cfg, [_Chunk(10, 30), _Chunk(10, 30)])
    # per chunk: layer 1 (4 -> 2 x 3), layer 2 (6 -> 2 x 5)
    ops = 30 * 2 * (7 + 6) + 30 * 2 * (7 + 10)
    nbytes = 4 * (60 + 40 + 30 + 60) + 4 * (100 + 40 + 30 + 100)
    assert w["gat_agg"] == (2 * ops, 2 * nbytes, 4)
    assert w["model_fwd"] == 2 * (2 * 10 * 4 * 6 + 4 * 60 + 2 * 10 * 6 * 10 + 4 * 100 + ops)
    s = gcn.work({"hidden": 3, "depth": 2, "num_features": 4, "num_classes": 5}, [_Chunk(10, 30)])
    assert s["spmm_agg"] == (2 * 30 * 3 + 2 * 30 * 5, 4 * (30 + 60 + 30) + 4 * (50 + 60 + 50), 2)
    assert s["model_fwd"] == 2 * 10 * 4 * 3 + 2 * 10 * 3 * 5 + 180 + 300
    assert costs.least_seconds(67e12, 0, H100) == 1.0
    assert costs.least_seconds(0, 3.35e12, H100) == 1.0


def test_calls_are_runs_of_back_to_back_launches():
    dev = [("gemm", 0.0, 0.1), ("gat_edge_kernel<1>", 0.1, 0.2), ("Memset (Device)", 0.2, 0.21),
           ("gat_edge_kernel<2>", 0.21, 0.3), ("cat", 0.3, 0.4), ("gat_edge_kernel<1>", 0.4, 0.5),
           ("gemm", 0.5, 0.6), ("gat_edge_kernel<1>", 0.6, 0.7)]
    w = Window(window_s=1.0, busy_s=0.7, device=dev, spans=[], gaps=[])
    assert w.calls_of(("gat_edge_kernel",)) == 3
    assert w.calls_of(("absent",)) == 0


def _reading(device, window_s=2.0, units=4, work=None):
    busy = sum(t - s for _, s, t in device)
    win = Window(window_s=window_s, busy_s=busy, device=device, spans=[], gaps=[])
    return Reading(units, win, work or {}, H100, 12.5)


def test_readers_on_a_hand_built_window():
    # 4 steps; each forward pass over the graph makes 2 aggregation calls
    gat = [(f"void gat_edge_kernel<8, {i % 2}>(...)", 0.01 * i, 0.01 * i + 0.005)
           for i in range(16)]  # back to back: 1 call
    dev = [("gemm", 0.0, 0.0)] + gat + [
        ("indexing_backward_kernel", 0.2, 0.9), ("DeviceRadixSortOnesweepKernel", 0.9, 1.0),
        ("void spmm_kernel<1>(...)", 1.0, 1.5)]
    work = {"gat_agg": (0, 3.35e12 * 0.01, 2), "spmm_agg": (67e12 * 0.05, 0, 2),
            "model_fwd": 67e12 * 0.002}
    r = _reading(dev, work=work)
    assert reader("device_idle.train").read(r) == pytest.approx(100 * (1 - 1.38 / 2))
    assert reader("gather_grad_ms.train").read(r) == pytest.approx(1e3 * 0.8 / 4)
    # one call of the two a pass asks for: 0.005 s least over 0.08 s of kernel
    assert reader("gat_agg_roofline.train").read(r) == pytest.approx(100 * 0.005 / 0.08)
    assert reader("spmm_agg_roofline.train").read(r) == pytest.approx(100 * 0.025 / 0.5)
    # 4 steps x 3 forwards x 0.002 s at peak over 2 s
    assert reader("mfu.train").read(r) == pytest.approx(1.2)
    assert reader("plan_build_s").read(r) == 12.5


def test_a_recompute_moves_the_kernels_time_and_work_together():
    def launches(calls):  # each call: 4 bucket launches, then a kernel of another name
        dev, t = [], 0.0
        for _ in range(calls):
            for _ in range(4):
                dev.append(("gat_edge_kernel", t, t + 0.01))
                t += 0.01
            dev.append(("gemm", t, t + 0.01))
            t += 0.01
        return dev

    work = {"gat_agg": (0, 3.35e12 * 0.02, 8)}
    once = reader("gat_agg_roofline.train").read(_reading(launches(8), units=1,
                                                          work=work))
    twice = reader("gat_agg_roofline.train").read(_reading(launches(16), units=1,
                                                           work=work))
    assert once == pytest.approx(twice) == pytest.approx(100 * 0.02 / 0.32)


def test_readers_find_nothing_without_device_activity():
    r = _reading([], work={"gat_agg": (1, 1, 1), "model_fwd": 1})
    for name in ("device_idle.train", "gather_grad_ms.train", "gat_agg_roofline.train",
                 "mfu.train"):
        assert reader(name).read(r) is None
