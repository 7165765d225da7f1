"""The work each hand-written LM kernel does, counted from its shapes.

One count serves three readers: the smoke's bounds (``chip_smoke.py``
phase 5), the operation counter that the dry run walks a step with
(``roofline.counter``; each kernel wrapper reports its call's cost), and the
dry run's roofline. Each function takes shapes (and, for flash, the window
and the position vectors as numpy arrays) and returns ``(operations,
bytes)``: bytes are each input read once and each output written once;
operations are those of the needed work, which the fp32-accurate kernels
issue as three TF32 tensor-core products each (``TF32_PASSES``). ``bound``
divides them by a card's data-sheet rates (``roofline.analysis.HW``).
"""

from __future__ import annotations

import numpy as np

# the flash and SSD kernels' fp32 scheme: three TF32 tensor-core products per
# operation (3xTF32)
TF32_PASSES = 3


def _tri(n: int) -> int:
    """1 + 2 + ... + n (0 for n <= 0)."""
    return n * (n + 1) // 2 if n > 0 else 0


def flash_pairs(sq: int, skv: int, window: int, q_pos=None, kv_pos=None) -> int:
    """(query, key) pairs that causal (windowed) attention needs, per head.
    By row index (key j for row i when j <= i and, with a window, i - j <
    window), in closed form; or by the position vectors (numpy, non-decreasing:
    key j for row i when kv_pos[j] <= q_pos[i], within the window)."""
    if q_pos is not None:
        qp, kp = np.asarray(q_pos), np.asarray(kv_pos)
        hi = np.searchsorted(kp, qp, side="right")
        lo = np.searchsorted(kp, qp - window, side="right") if window > 0 else 0
        return int((hi - lo).sum())
    m = min(sq, skv)  # rows i < skv see keys max(0, i - w + 1) .. i
    extra = sq - m  # rows i >= skv see keys up to skv - 1
    if window <= 0:
        return _tri(m) + extra * skv
    a = min(m, window)
    total = _tri(a) + (m - a) * window
    if extra:  # row skv + j sees min(skv, window - 1 - j) keys, where positive
        full = max(0, min(extra, window - skv))
        end = max(full, min(extra, window - 1))
        total += full * skv + _tri(window - 1 - full) - _tri(window - 1 - end)
    return total


def flash_cost(b: int, sq: int, skv: int, h: int, kv: int, hd: int, hd_v: int, itemsize: int,
               window: int = 0, q_pos=None, kv_pos=None) -> tuple[int, int]:
    """(operations, bytes) of one flash launch: q, k, v read once and the
    output written once (and the two int32 position vectors, where given);
    per needed (query, key) pair and head a hd-long dot product and a
    hd_v-long multiply-add (2 operations each) plus 4 softmax operations
    (max, subtract, exp, sum)."""
    nbytes = (b * sq * h * hd + b * skv * kv * (hd + hd_v) + b * sq * h * hd_v) * itemsize
    if q_pos is not None:
        nbytes += 4 * (len(q_pos) + len(kv_pos))
    ops = b * h * flash_pairs(sq, skv, window, q_pos, kv_pos) * (2 * hd + 2 * hd_v + 4)
    return ops, nbytes


def ssd_cost(b: int, s: int, h: int, p: int, n: int, chunk: int) -> tuple[int, int]:
    """(operations, bytes) of one SSD call: x, dt, loga, B, C read once, y
    and the final state written once; per chunk and head the causal half of
    C·Bᵀ and of G·(x·dt), C·Hᵀ and the state update, as multiply-adds (2
    operations). The last chunk's padding does no needed work."""
    nbytes = 4 * (2 * b * s * h * p + 2 * b * s * h + 2 * b * s * n + b * h * p * n)
    full, rest = divmod(s, chunk)

    def per_chunk(q):
        t = _tri(q)
        return 2 * (t * n + t * p + 2 * q * p * n)

    ops = b * h * (full * per_chunk(chunk) + (per_chunk(rest) if rest else 0))
    return ops, nbytes


def bound(ops: int, nbytes: int, hw) -> tuple[float, float]:
    """(seconds by bytes, seconds by operations) of a kernel's work on the
    card ``hw``: bytes over its memory rate, ``TF32_PASSES`` TF32 products per
    operation over its TF32 rate. The bound is the larger."""
    return nbytes / hw.hbm_bw, TF32_PASSES * ops / hw.tf32_flops
