"""A pytest plug-in that records each test's CPU seconds (every thread of
the worker process: `getrusage(RUSAGE_SELF)`, user + system) beside its
wall seconds and start time, one JSON line a test, to show where a
parallel run's CPU goes (the tier-1 run is CPU-bound: PERF.md section 7).

    python -m pytest tests/ -n 6 --dist loadfile -p tests.cpu_times

writes `<pid>.jsonl` into `$CPU_TIMES_DIR` (default `build/cpu_times/` in
the checkout; empty it before a run); `python -m tests.cpu_times [DIR]`
prints the CPU and wall seconds of each file, most CPU first.
"""
import collections
import json
import os
import resource
import sys
import time
from pathlib import Path

import pytest

DIR = Path(os.environ.get("CPU_TIMES_DIR",
                         Path(__file__).resolve().parents[1] / "build" / "cpu_times"))


def _cpu_seconds() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def pytest_configure(config):
    DIR.mkdir(parents=True, exist_ok=True)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    c0, t0 = _cpu_seconds(), time.time()
    yield
    line = {"id": item.nodeid, "cpu": _cpu_seconds() - c0, "wall": time.time() - t0,
            "start": t0}
    with open(DIR / f"{os.getpid()}.jsonl", "a") as f:
        f.write(json.dumps(line) + "\n")


def per_file(directory) -> list:
    """[(file, cpu s, wall s, tests)] over every JSON line in `directory`,
    most CPU first."""
    files = collections.defaultdict(lambda: [0.0, 0.0, 0])
    for path in Path(directory).glob("*.jsonl"):
        for text in path.read_text().splitlines():
            rec = json.loads(text)
            row = files[rec["id"].split("::")[0]]
            row[0] += rec["cpu"]
            row[1] += rec["wall"]
            row[2] += 1
    return sorted(((k, *v) for k, v in files.items()), key=lambda r: -r[1])


if __name__ == "__main__":
    rows = per_file(sys.argv[1] if len(sys.argv) > 1 else DIR)
    print(f"{sum(r[1] for r in rows):.0f} CPU s, {sum(r[2] for r in rows):.0f} wall s in all")
    for name, cpu, wall, n in rows:
        print(f"{cpu:9.1f} {wall:9.1f} {n:4d} {name}")
