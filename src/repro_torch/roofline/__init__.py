"""Per-stage roofline of the GNN pipeline on the card (counterpart of
``repro.roofline``'s GNN half): the data-sheet constants of the card the
device query names, and each stage's measured device time beside the floor
its live edge slots set; and the transformer's analytic model FLOPs."""

from repro_torch.roofline.analysis import HW, model_flops
from repro_torch.roofline.stage_report import (
    device_ms,
    layout_slots,
    live_slots,
    sparse_stage_report,
    stage_report,
)

__all__ = ["HW", "device_ms", "layout_slots", "live_slots", "model_flops", "sparse_stage_report",
           "stage_report"]
