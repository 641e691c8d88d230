"""The forming pass's byte and flop counts against counts worked by hand."""

import pytest

from benchmark.counts import HBM_BYTES_PER_S, forming


def test_forming_bytes_by_hand():
    # a window of 2 knots (dim_pose 6), order 2: 10 weighted measurements on
    # 3 active rows. A measurement: row, i_c, i_p (3 x 4 bytes), Jc and Jp
    # (2 x 6 x 4), dx, dy, e (3 x 4): 72 bytes. A row: 2 x 6 A12 values and
    # 5 sums (17 x 4 = 68 bytes); A11 36 and b1 6 values (168 bytes).
    assert forming.measurement_bytes(2) == 72
    assert forming.pass_bytes(10, 3, 6, 2) == 10 * 72 + 3 * 68 + 168
    assert forming.pass_flops(10, 2) == 10 * 2 * (78 + 12 + 24 + 5)
    assert forming.pass_bound_s(10, 3, 6) == pytest.approx(1092 / HBM_BYTES_PER_S)


def test_bound_follows_the_work_not_the_rows_of_the_map():
    # the same measurements on more rows of a bigger map: only the rows
    # touched count
    assert forming.pass_bytes(1e6, 5e4, 291) == forming.pass_bytes(1e6, 5e4, 291)
    assert forming.pass_bytes(1e6, 5e4, 291) < forming.pass_bytes(1e6, 1e5, 291)
