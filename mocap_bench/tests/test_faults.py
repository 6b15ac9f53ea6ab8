"""The judge sees a broken timed path: each fault that a tracker cell can
have (`mocap_bench/faults.py`), planted under a run on the CPU at a small
size, makes `correct` false."""
import time

import pytest

from bench_support import SMALL, small_cell
from mocap_bench import faults, run


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_fault_makes_the_run_incorrect(workload, fault):
    with faults.planted(fault):
        out = run.run_cell(small_cell(workload), 2**31 + 21, 1.0, False, device="cpu",
                           t_start=time.perf_counter(), overrides=SMALL[workload])
    assert out["line"]["correct"] is False, out["numbers"]
