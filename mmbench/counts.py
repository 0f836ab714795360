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

On several cards the rule is the same: the work is the whole problem's,
counted once (not once a card), the peaks are one card's, and the device
time is the kernels' summed over the cards. So a share of a roofline
reads as on one card when the cards split the work without doing more
of it between them, and falls by what a shard repeats (a combine each
card runs over every card's partials) or waits.
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


def select_work(n: int, m: int, k: int) -> tuple[int, int]:
    """(bytes, f32 operations) of one top-K selection: the bf16 cost
    matrix read once, each row's ``k`` candidate indices (of
    ``id_bytes(m)``) and their f32 keys written; per element the key's
    scale and subtract of the noise."""
    return cost_bytes(n, m) + n * k * (id_bytes(m) + F32), 2 * n * m


def masked_row_work(n: int, m: int, k: int) -> tuple[int, int]:
    """(bytes, f32 operations) of one row product of the masked Sinkhorn:
    the row's ``k`` candidates' bf16 costs, the candidate mask as one bit
    an entry, the column potential read and the row's written (f32);
    per candidate a subtract, a scale, an exp, a multiply and an add."""
    return (n * k * BF16 + -(-n * m // 8) + F32 * (n + m),
            5 * n * k)


def masked_iteration_work(n: int, m: int, k: int) -> tuple[int, int]:
    """(bytes, f32 operations) of one masked Sinkhorn iteration: the row
    and the column product over the ``k`` candidates of each row, which
    one pass can take together: the candidates' costs and the mask read
    once, the row mass read, both potentials read and written; per
    candidate the row product's five operations and the column
    product's three (a scale, a multiply, an add)."""
    return (n * k * BF16 + -(-n * m // 8) + F32 * (3 * n + 2 * m),
            8 * n * k)
