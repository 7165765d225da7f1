"""The card's peak rates, from its data sheet, and the three-term roofline.

Counterpart of ``repro.roofline.analysis``. Its ``HW`` holds a TPU v5e's
constants; here they are those of the CUDA card the device query names
(``torch.cuda.get_device_name``), looked up in a table of data-sheet
values; a card the table does not hold raises rather than borrowing
another card's rates. ``model_flops`` is the reference's analytic count,
copied. ``roofline_report`` and ``collective_bytes`` serve the dry run
(``launch/dryrun.py``): they read the counts of ``roofline.counter``, which
takes the place of the reference's HLO walk. Per step, on one card:

    compute    = aten FLOPs / fp32 rate + Σ kernel operations · 3 / TF32 rate
    memory     = counted bytes (aten and kernels) / memory rate
    collective = collective bytes / NVLink rate
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.roofline.counter import COLLECTIVES
from repro_torch.roofline.kernel_cost import TF32_PASSES


@dataclasses.dataclass(frozen=True)
class HW:
    """Peak rates of one card: device-memory bytes/s, fp32 FLOP/s on the
    CUDA cores, dense TF32 FLOP/s on the tensor cores (no sparsity), the
    card's total NVLink bytes/s, and its device-memory bytes. The rates
    assume the card's full power limit."""

    name: str
    hbm_bw: float
    fp32_flops: float
    tf32_flops: float
    nvlink_bw: float
    hbm_bytes: float

    @classmethod
    def of(cls, device_name: str | None = None) -> "HW":
        """The data-sheet rates of the card named ``device_name`` (default:
        CUDA device 0's name). Raises ``KeyError`` for a card the table
        does not hold."""
        if device_name is None:
            device_name = torch.cuda.get_device_name(0)
        try:
            return DATA_SHEET[device_name]
        except KeyError:
            raise KeyError(
                f"no data-sheet rates for {device_name!r}; known cards: {sorted(DATA_SHEET)}"
            ) from None


def model_flops(cfg, shape, *, training: bool) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D for a
    forward/serve step (D = tokens processed in the step; ``shape.kind``
    decides, ``training`` is the reference's unused flag)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active * tokens


def collective_bytes(counted: dict) -> dict[str, int]:
    """Bytes per collective kind, with their ``total``: the counter's
    collectives (``OpCounter.collectives``, output bytes of each op, as the
    reference sums the HLO's output shapes)."""
    out = {k: int(counted.get(k, 0)) for k in COLLECTIVES}
    out["total"] = sum(out.values())
    return out


def roofline_report(*, aten_flops: float, kernel_ops: dict, device_bytes: float,
                    device_collective: dict, chips: int, model_flops_global: float,
                    hw: HW) -> dict:
    """The three-term roofline of one step, with the reference's keys. The
    compute term is the aten FLOPs at the fp32 rate plus each kernel's
    operations as ``TF32_PASSES`` TF32 products at the TF32 rate (the
    3xTF32 scheme its bound uses); memory is the counted bytes at the memory rate;
    collective is the collective bytes at the NVLink rate."""
    kernel_flops = TF32_PASSES * sum(kernel_ops.values())
    compute_s = aten_flops / hw.fp32_flops + kernel_flops / hw.tf32_flops
    memory_s = device_bytes / hw.hbm_bw
    coll_s = device_collective["total"] / hw.nvlink_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    device_flops = aten_flops + sum(kernel_ops.values())
    return {
        **terms,
        "dominant": dominant,
        "bound_s": max(terms.values()),
        "model_flops_global": model_flops_global,
        "hlo_flops_global": device_flops * chips,
        "useful_flops_ratio": model_flops_global / max(device_flops * chips, 1.0),
        "collective_breakdown": {
            k: v for k, v in device_collective.items() if k != "total" and v
        },
    }


# NVIDIA H100 data sheet, SXM part (the name the device query gives the
# 80 GB HBM3 SXM card): 3.35 TB/s HBM3, 67 TFLOP/s fp32, 495 TFLOP/s dense
# TF32, 900 GB/s NVLink 4 (18 links, total of both directions), 80 GB HBM3
# (binary gigabytes: 80 GiB)
DATA_SHEET = {
    "NVIDIA H100 80GB HBM3": HW("NVIDIA H100 80GB HBM3", 3.35e12, 67e12, 495e12, 900e9,
                                80 * 2**30),
}
