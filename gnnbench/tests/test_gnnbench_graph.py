"""The benchmark's generator against the program's, and the reference's
chunks against the program's plan."""

import numpy as np
import pytest
import torch
from conftest import SEED

from gnnbench.graph import PowerlawGraph
from gnnbench.harness import Cell, port_dataset
from gnnbench.reference import common as ref


def _graph(seed, n=10_000, block=4096):
    return PowerlawGraph(name="powerlaw-1m", num_nodes=n, num_features=64, num_classes=16,
                         zipf_a=1.7, deg_cap=48, seed=seed, block_size=block)


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_generator_equals_the_programs(seed):
    from repro_torch.graphs import open_streamed

    ours = _graph(seed)
    theirs = open_streamed("powerlaw-1m", seed=seed, num_nodes=10_000)
    assert ours.num_blocks == theirs.num_blocks == 3  # the last block is short
    for b in range(ours.num_blocks):
        for a, t in zip(ours.block(b), theirs.generate_block(b), strict=True):
            assert a.dtype == t.dtype and np.array_equal(a, t)


def test_generator_equals_the_programs_at_the_traffics_law():
    from repro_torch.graphs.datasets import StreamedPowerlaw

    cell = Cell.find("gat-products-train", overrides={"graph": {"num_nodes": 9000,
                                                                "block_size": 4096}})
    ours = cell.traffic.make_graph()
    theirs = StreamedPowerlaw(**cell.traffic.graph)
    for b in range(ours.num_blocks):
        for a, t in zip(ours.block(b), theirs.generate_block(b), strict=True):
            assert a.dtype == t.dtype and np.array_equal(a, t)


def test_the_drawn_graph_has_the_configurations_mean_degree():
    """Two blocks of the full-size graph: each undirected edge counted at
    both ends, over the blocks' nodes, within 2% of the configuration's."""
    cell = Cell.find("gat-products-train")
    graph = cell.traffic.make_graph()
    pairs = sum(len(graph.block(b)[1]) for b in (0, 1))
    nodes = 2 * graph.block_size
    assert 2 * pairs / nodes == pytest.approx(cell.config["mean_degree"], rel=0.02)


def test_reference_chunks_equal_the_programs_plan():
    from repro_torch.graphs import streamed_plan

    # chunks of one 2,048-node block: enough of each class to pass the 32 slots
    traffic = Cell.find("gcn-products-train",
                        overrides={"graph": {"num_nodes": 16384, "block_size": 2048}}).traffic
    graph = traffic.make_graph().draw()
    plan = streamed_plan(port_dataset(graph), traffic.chunks, max_degree=traffic.max_degree)
    ours = ref.chunk_graphs(graph, traffic, "cpu")
    assert len(ours) == len(plan.batches) == traffic.chunks
    for g, mb in zip(ours, plan.batches):
        pg = mb.graph
        rows = torch.arange(pg.num_nodes)[:, None].expand_as(pg.neighbors)[pg.mask]
        theirs = sorted(zip(rows.tolist(), pg.neighbors[pg.mask].tolist(),
                            pg.norm[pg.mask].tolist()))
        mine = sorted(zip(g.rows.tolist(), g.cols.tolist(), g.norm.tolist()))
        assert [x[:2] for x in mine] == [x[:2] for x in theirs]
        assert np.allclose([x[2] for x in mine], [x[2] for x in theirs], rtol=1e-6)
        assert torch.equal(g.features, pg.features)
        assert torch.equal(g.labels, pg.labels.long())
        assert torch.equal(g.train, pg.train_mask)
    assert max(int(mb.graph.mask.sum(1).max()) for mb in plan.batches) == traffic.max_degree + 1
