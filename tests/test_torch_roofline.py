"""The per-stage roofline of the port, on the CPU.

The slot accounting (``layout_slots``, ``live_slots``) and each stage's
roof FLOPs and bytes are numpy arithmetic on the same layouts and params
as the reference's, so they must equal ``repro.roofline``'s exactly. The
measured fields are device times: on the CPU they are None. ``HW`` knows
only cards its data-sheet table holds.
"""
# ruff: noqa: E402

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX side of the parity tests

from repro.core.microbatch import make_plan as j_make_plan
from repro.graphs import bucketize_stacked as j_bucketize
from repro.graphs import load_dataset as j_load
from repro.models.gnn.net import build_gnn as j_build_gnn
from repro.models.gnn.net import build_paper_gat as j_build_gat
from repro.roofline import layout_slots as j_layout_slots
from repro.roofline import live_slots as j_live_slots
from repro.roofline import sparse_stage_report as j_sparse_stage_report
from repro.roofline import stage_report as j_stage_report
from repro_torch.core.microbatch import make_plan
from repro_torch.graphs import load_dataset
from repro_torch.graphs.partition import bucketize_stacked
from repro_torch.models.gnn.convert import params_from_jax
from repro_torch.models.gnn.net import build_gnn, build_paper_gat
from repro_torch.roofline import (
    HW,
    layout_slots,
    live_slots,
    sparse_stage_report,
    stage_report,
)

MEASURED = ("measured_ms", "roof_ms", "roof_share")


def _case(name, j_model, t_model, chunks):
    jg, tg = j_load(name), load_dataset(name)
    jm, tm = j_model(jg), t_model(tg)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    js = j_make_plan(jg, chunks, strategy="sequential").stacked().graph
    ts = make_plan(tg, chunks, strategy="sequential").stacked().graph
    return (jm, jparams, js), (tm, params, ts)


def test_sparse_stage_report_equals_the_reference():
    """The reference's own fixture (``tests/test_roofline.py``'s sparse
    report): the GCN of depth 2 on skewed-mini, 2 sequential chunks."""
    (jm, jp, js), (tm, tp, ts) = _case(
        "skewed-mini",
        lambda g: j_build_gnn("gcn", g.num_features, g.num_classes, hidden=16, depth=2,
                              backend="pallas"),
        lambda g: build_gnn("gcn", g.num_features, g.num_classes, hidden=16, depth=2,
                            backend="pallas"),
        2,
    )
    jb, tb = j_bucketize(js), bucketize_stacked(ts)
    assert layout_slots(ts) == j_layout_slots(js) and layout_slots(tb) == j_layout_slots(jb)
    assert live_slots(ts) == j_live_slots(js) == live_slots(tb)
    want = j_sparse_stage_report(jm, jp, js, jb, (2, 2))
    got = sparse_stage_report(tm, tp, ts, tb, (2, 2))
    assert got["slots"] == want["slots"]
    assert len(got["stages"]) == len(want["stages"]) == 2
    for g, w in zip(got["stages"], want["stages"]):
        for key in ("stage", "layers", "roof_flops", "roof_bytes"):
            assert g[key] == w[key], key
        assert g["roof_ms"] is None
        for layout in ("padded", "bucketed"):
            assert g[layout] == {"measured_ms": None, "roof_share": None}


def test_stage_report_gat_roof_equals_the_reference():
    """The multi-head GAT branch of the roof (a 3-D ``w``) on karate, 3
    stages."""
    (jm, jp, js), (tm, tp, ts) = _case(
        "karate", lambda g: j_build_gat(g.num_features, g.num_classes),
        lambda g: build_paper_gat(g.num_features, g.num_classes), 2)
    want = j_stage_report(jm, jp, js, (2, 2, 2))
    got = stage_report(tm, tp, ts, (2, 2, 2))
    assert [(r["stage"], r["layers"], r["roof_flops"], r["roof_bytes"]) for r in got] == [
        (r["stage"], r["layers"], r["roof_flops"], r["roof_bytes"]) for r in want]
    assert all(r[k] is None for r in got for k in MEASURED)
    assert sum(r["roof_flops"] for r in got) > 0


def test_hw_reads_the_data_sheet_and_refuses_unknown_cards():
    h100 = HW.of("NVIDIA H100 80GB HBM3")
    assert (h100.hbm_bw, h100.fp32_flops, h100.tf32_flops) == (3.35e12, 67e12, 495e12)
    with pytest.raises(KeyError, match="no data-sheet rates"):
        HW.of("NVIDIA GeForce GTX 1080")
