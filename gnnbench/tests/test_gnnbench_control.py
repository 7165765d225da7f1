"""The comparison fails what it must: the reference at TF32 put in the
program's place (the control), and the program broken underneath a run, one
fault at a time, each come out not correct under the cell's own limits."""

import pytest
import torch
from conftest import SEED, SMALL, find

from gnnbench import control
from gnnbench.harness import run_cell
from gnnbench.reference import common as ref


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("workload", ["gat-products-train", "gcn-products-train"])
def test_control_and_planted_faults_fail_the_limits(workload):
    cell = find(workload, overrides=SMALL)
    graph = cell.traffic.make_graph().draw()
    graphs = ref.chunk_graphs(graph, cell.traffic, "cpu")
    p0 = ref.flat(cell.reference.make_params(cell.config, SEED, "cpu"))
    readings = control.reference_variants(cell, p0, graphs, SEED)
    assert set(readings) == {"control", "half_batch", "unchanged"}
    for name, numbers in readings.items():
        assert _fails(numbers, cell.limits), (name, numbers)


def _unchanged_state(monkeypatch):
    from repro_torch.core.pipeline import CompiledGNNPipeline

    step = CompiledGNNPipeline.train_step

    def held(self, params, opt_state, *args, **kwargs):
        _, _, loss = step(self, params, opt_state, *args, **kwargs)
        return params, opt_state, loss

    monkeypatch.setattr(CompiledGNNPipeline, "train_step", held)


def _half_batch(monkeypatch):
    from repro_torch.core.pipeline import CompiledGNNPipeline

    inputs = CompiledGNNPipeline._plan_inputs

    def half(self, plan):
        graphs, masks, skip, shape = inputs(self, plan)
        keep = len(masks) // 2
        return graphs, masks[:keep] + [torch.zeros_like(m) for m in masks[keep:]], skip, shape

    monkeypatch.setattr(CompiledGNNPipeline, "_plan_inputs", half)


@pytest.mark.parametrize("workload,fault", [
    ("gat-products-train", _unchanged_state), ("gat-products-train", _half_batch),
    ("gcn-products-train", _unchanged_state), ("gcn-products-train", _half_batch),
], ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_a_broken_program_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result, *_ = run_cell(find(workload, overrides=SMALL), SEED, 0.2, False, "cpu")
    assert result["correct"] is False
