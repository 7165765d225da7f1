"""The plain reference against the program's GAT and GCN steps and its
forward, on the CPU at a small size: the run's compared numbers sit far
under their limits."""

import pytest
import torch
from conftest import SEED, SMALL, find

from gnnbench.harness import run_cell
from gnnbench.reference import common as ref

# float32 agreement of two orders of summation: loss and gradients to ~1e-6
# relative, Adam's three-step change to ~1e-4
CLOSE = {"loss_gap": 1e-6, "grad_gap": 1e-5, "change_gap": 1e-4}


@pytest.mark.parametrize("workload", ["gat-products-train", "gcn-products-train"])
def test_program_matches_the_reference(workload):
    result, *_ = run_cell(find(workload, overrides=SMALL), SEED, 0.2, False, "cpu")
    assert result["correct"] and result["failed"] == 0
    for name, check in result["checks"].items():
        assert check["value"] < CLOSE[name], (name, check)


def test_reference_eval_equals_the_programs_forward():
    """The GAT reference's log-probabilities against the program's model
    applied to one chunk's padded batch (plain backend, no engine)."""
    from repro_torch.graphs import streamed_plan
    from repro_torch.models.gnn.net import build_paper_gat

    from gnnbench.harness import port_dataset

    cell = find("gat-products-train", overrides=SMALL)
    cfg, graph = cell.config, cell.traffic.make_graph().draw()
    plan = streamed_plan(port_dataset(graph), cell.traffic.chunks, max_degree=32)
    params = cell.reference.make_params(cfg, SEED, "cpu")
    model = build_paper_gat(cfg["num_features"], cfg["num_classes"], attn_dropout=0.0)
    graphs = ref.chunk_graphs(graph, cell.traffic, "cpu")
    for c in (0, cell.traffic.chunks - 1):
        got = model.apply(params, plan.batches[c].graph)
        with torch.no_grad():
            want = cell.reference.forward(cfg, ref.flat(params), graphs[c], ref.Precision())
        assert torch.allclose(got, want, atol=1e-5)


def test_dropout_keys_follow_the_programs():
    """The reference's keys are the program's (``net.fold_in`` per step,
    chunk and layer), and a key redraws the same mask."""
    from repro_torch.models.gnn.net import chunk_keys, fold_in

    assert ref.fold_in(SEED, 3) == fold_in(SEED, 3)
    key = ref.step_key(SEED, 2)
    assert chunk_keys(key, 6)(5, "fwd")[3] == ref.dropout_key(key, 5, 3)
    x = torch.ones(64, 8)
    assert torch.equal(ref.dropout(x, 0.6, 11), ref.dropout(x, 0.6, 11))
