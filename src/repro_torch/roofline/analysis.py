"""The card's peak rates, from its data sheet.

Counterpart of ``repro.roofline.analysis.HW``, whose constants are a TPU
v5e's. Here the constants are those of the CUDA card the device query
names (``torch.cuda.get_device_name``), looked up in a table of data-sheet
values; a card the table does not hold raises rather than borrowing
another card's rates. ``model_flops`` is the reference's analytic count,
copied. The reference's HLO walk, ``roofline_report`` and
``collective_bytes`` serve the transformer dry run and are not ported here.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class HW:
    """Peak rates of one card: device-memory bytes/s, fp32 FLOP/s on the
    CUDA cores and dense TF32 FLOP/s on the tensor cores (no sparsity). The
    rates assume the card's full power limit."""

    name: str
    hbm_bw: float
    fp32_flops: float
    tf32_flops: float

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


# NVIDIA H100 data sheet, SXM part (the name the device query gives the
# 80 GB HBM3 SXM card): 3.35 TB/s HBM3, 67 TFLOP/s fp32, 495 TFLOP/s dense TF32
DATA_SHEET = {
    "NVIDIA H100 80GB HBM3": HW("NVIDIA H100 80GB HBM3", 3.35e12, 67e12, 495e12),
}
