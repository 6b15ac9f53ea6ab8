"""Each cell end to end on the CPU at a small size, through the port's plain
kernels: the result line's shape, the judge and the trace's readers."""
import time

import pytest

from bench_support import SMALL, small_cell
from mocap_bench import run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_cell_runs_and_is_correct(workload, trace):
    cell = small_cell(workload)
    out = run.run_cell(cell, 2**31 + 11, 1.5, bool(trace), device="cpu",
                       t_start=time.perf_counter(), overrides=SMALL[workload])
    line = out["line"]
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, out["numbers"]
    assert line["attempted"] == out["counts"]["frames"] > 0 and line["failed"] == 0
    assert out["numbers"]["pose_err_ulp_max"] <= 0.5 + 1e-6
    if trace:
        # on the CPU only the program's own count is there to read
        names = {m.name for m in cell.per_layer}
        assert set(line["metrics"]) <= names
        assert any(n.startswith("als_iters_per_frame") for n in line["metrics"])
        assert "breakdown" in line and "busy_s" in line["device"]
    else:
        assert set(line["metrics"]) == {m.name for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in line["metrics"].values())
