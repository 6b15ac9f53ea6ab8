"""The control, the reference one precision below the configuration's
(float32 for the tracker's float64, TF32 products in the ALS), put in the
program's place at a small size, is not correct by the cells' limits."""
import pytest

from bench_support import SMALL, small_cell
from mocap_bench import check, control


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_a_limit(workload):
    cell = small_cell(workload)
    numbers = control.control_reading(cell, 2**31 + 31, 8, "cpu", SMALL[workload])
    assert numbers["frames_judged"] >= 3
    assert not check.verdict(numbers, cell.limits["limits"]), numbers
