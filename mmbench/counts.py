"""The card's published peaks and the work each layer needs.

Peaks: one NVIDIA H100 (SXM part, data sheet, dense rates, at the full
700 W power limit): 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside
the tensor cores. The share of a roofline is the least time those peaks
allow for the work, the larger of bytes over the memory rate and
operations over the f32 rate, divided by the device time the work took.

The counts are what the algorithm needs from its inputs, whatever a
kernel reads: each input byte read once and each output byte written
once, at the real fleet's rows ``n`` and pods ``m`` (a bucket's padding
is the program's choice, not work the problem needs).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

BF16 = 2
F32 = 4


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S)


def cost_bytes(n: int, m: int) -> int:
    """The bf16 cost matrix: one pass over it."""
    return BF16 * n * m


def transport_work(n: int, m: int, iters: int) -> tuple[int, int]:
    """(bytes, f32 operations) of one dense transport solve: each
    iteration reads C once and reads and writes the two potentials; per
    element the row and the column log-sum-exp each take a subtract, a
    scale, an exp and an add."""
    pots = F32 * 2 * (n + m)
    return iters * (cost_bytes(n, m) + pots), iters * 8 * n * m


def id_bytes(m: int) -> int:
    """The narrowest integer that holds a pod index below ``m``, at most
    int32."""
    return 1 if m <= 2**8 else 2 if m <= 2**16 else 4


def implied_load_work(n: int, m: int, entries: int) -> tuple[int, int]:
    """(bytes, f32 operations) of one implied load: the ``entries`` valid
    (row, pod) slots of the assignment, each a pod index of ``id_bytes(m)``
    and an add of its row's size, the f32 size of each of the ``n`` rows
    read once, the f32 load of each pod written once."""
    return entries * id_bytes(m) + F32 * n + F32 * m, entries
