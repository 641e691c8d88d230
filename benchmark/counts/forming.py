"""The bytes one forming pass needs: what the normal equations of a window
must read and write, whatever implements them.

Rule. Each weighted measurement (an inlier on an active pixel) is read
once: its row, its two knot indices, its two half-Jacobians of ``3 order``
values each, and its dx, dy and residual. The blocks are written once, at
the rows the measurements touch, the active pixels the pass reports: a row
of A12 (``2 dim_pose`` values: the Gx and the Gy plane) and the pixel's
five A22 and b2 sums; and A11 (``dim_pose`` squared) and b1 once. Reading
measurements that carry no weight, writing rows no measurement touches,
sorting and scratch are not needed and are not counted, so an
implementation that skips them reads no higher against this bound.
"""

from __future__ import annotations

from . import F32_FLOP_PER_S, HBM_BYTES_PER_S

VALUE_BYTES = 4  # float32, the program's dtype
INDEX_BYTES = 4  # int32


def measurement_bytes(order: int = 2, value_bytes: int = VALUE_BYTES,
                      index_bytes: int = INDEX_BYTES) -> int:
    """Bytes read for one weighted measurement."""
    return 3 * index_bytes + (2 * 3 * order + 3) * value_bytes


def pass_bytes(weighted: float, active_rows: float, dim_pose: int, order: int = 2,
               value_bytes: int = VALUE_BYTES, index_bytes: int = INDEX_BYTES) -> float:
    """Bytes a forming pass needs: ``weighted`` measurements read once,
    ``active_rows`` rows written once, A11 and b1 written once."""
    reads = weighted * measurement_bytes(order, value_bytes, index_bytes)
    writes = (active_rows * (2 * dim_pose + 5) + dim_pose * dim_pose + dim_pose) * value_bytes
    return reads + writes


def pass_flops(weighted: float, order: int = 2) -> float:
    """Flops a forming pass needs: for each weighted measurement, with
    ``n = 6 order`` Jacobian values, the upper triangle of its A11 outer
    product, its b1 and A12 products and its five pixel sums, a multiply
    and an add each."""
    n = 6 * order
    return weighted * 2 * (n * (n + 1) // 2 + n + 2 * n + 5)


def pass_bound_s(weighted: float, active_rows: float, dim_pose: int, order: int = 2) -> float:
    """The least time of a forming pass on the card: the larger of its
    bytes at the HBM bandwidth and its flops at the float32 peak."""
    return max(pass_bytes(weighted, active_rows, dim_pose, order) / HBM_BYTES_PER_S,
               pass_flops(weighted, order) / F32_FLOP_PER_S)
