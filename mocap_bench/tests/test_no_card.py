"""The run command needs a card: without one it exits non-zero and prints
no result; it never falls back to the CPU."""
import subprocess
import sys

import pytest
import torch

from bench_support import ROOT


@pytest.mark.parametrize("workload", ["dome128-tri-offline", "rig32-tri-online"])
def test_exits_without_a_card(workload):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "mocap_bench.run", "--workload", workload,
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_unknown_workload_fails():
    p = subprocess.run([sys.executable, "-m", "mocap_bench.run", "--workload", "nope",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
