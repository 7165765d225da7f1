"""The card's peak rates, from its data sheet, and the three-term roofline.

Counterpart of ``repro.roofline.analysis``. Its ``HW`` holds a TPU v5e's
constants; here they are those of the CUDA card the device query names
(``torch.cuda.get_device_name``), looked up in a table of data-sheet
values; a card the table does not hold raises rather than borrowing
another card's rates. ``model_flops`` is the reference's analytic count,
copied. ``roofline_report`` and ``collective_bytes`` serve the dry run
(``launch/dryrun.py``): they read the counts of ``roofline.counter``, which
takes the place of the reference's HLO walk. Per step, on one card:

    compute    = Σ aten FLOPs of each dtype / that dtype's rate
                 + Σ kernel operations · passes / the rate of their precision
    memory     = counted bytes (aten and kernels) / memory rate
    collective = collective bytes / NVLink rate

A bfloat16 product runs at the dense bf16 tensor-core rate, every other
aten product at the fp32 rate (the port runs float32 with TF32 off); a
kernel's operations are three TF32 products each in the fp32-accurate
scheme, or one bf16 product each (``kernel_cost.PASSES``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.roofline.counter import COLLECTIVES
from repro_torch.roofline.kernel_cost import PASSES


@dataclasses.dataclass(frozen=True)
class HW:
    """Peak rates of one card: device-memory bytes/s, fp32 FLOP/s on the
    CUDA cores, dense TF32 FLOP/s on the tensor cores (no sparsity), the
    card's total NVLink bytes/s, its device-memory bytes, and dense bf16
    FLOP/s on the tensor cores. The rates assume the card's full power
    limit."""

    name: str
    hbm_bw: float
    fp32_flops: float
    tf32_flops: float
    nvlink_bw: float
    hbm_bytes: float
    bf16_flops: float

    def flops_of(self, dtype: str) -> float:
        """The rate of an aten product whose operands are ``dtype`` (its
        name, as ``OpCounter.flops_by_dtype`` keys it): bf16 at the bf16
        tensor-core rate, anything else at the fp32 rate."""
        return self.bf16_flops if dtype == "bfloat16" else self.fp32_flops

    def rate_of(self, precision: str) -> float:
        """The tensor-core rate a kernel's ``precision`` issues its products
        at (``kernel_cost.PASSES``' keys)."""
        return {"tf32x3": self.tf32_flops, "bf16": self.bf16_flops}[precision]

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
                    hw: HW, aten_flops_by_dtype: dict | None = None,
                    kernel_ops_by_precision: dict | None = None) -> dict:
    """The three-term roofline of one step, with the reference's keys. The
    compute term is the aten FLOPs of each operand dtype at its rate
    (``aten_flops_by_dtype``; without it all of ``aten_flops`` at the fp32
    rate) plus the kernels' operations of each precision as that
    precision's products at its rate (``kernel_ops_by_precision``; without
    it all of ``kernel_ops`` as three TF32 products, the 3xTF32 scheme);
    memory is the counted bytes at the memory rate; collective is the
    collective bytes at the NVLink rate."""
    by_dtype = aten_flops_by_dtype or {"float32": aten_flops}
    by_precision = kernel_ops_by_precision or {"tf32x3": sum(kernel_ops.values())}
    compute_s = sum(f / hw.flops_of(d) for d, f in by_dtype.items()) + sum(
        PASSES[p] * ops / hw.rate_of(p) for p, ops in by_precision.items())
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
# (binary gigabytes: 80 GiB), 989 TFLOP/s dense bf16
DATA_SHEET = {
    "NVIDIA H100 80GB HBM3": HW("NVIDIA H100 80GB HBM3", 3.35e12, 67e12, 495e12, 900e9,
                                80 * 2**30, 989e12),
}
