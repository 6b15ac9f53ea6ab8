"""Nothing the harness, the traffic or the reference loads is the JAX
package or JAX (top-level module names compared whole: the port's name
begins with the JAX package's), and the reference loads nothing of the
port."""
import json
import subprocess
import sys

import pytest

from bench_support import ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "multiview_motion_capture_tpu"]
PROBE = """
import json, sys
for m in {mods!r}:
    __import__(m)
print(json.dumps(sorted({{k.split('.')[0] for k in sys.modules}})))
"""


def _top_level(mods):
    p = subprocess.run([sys.executable, "-c", PROBE.format(mods=mods)], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    loaded = _top_level(["mocap_bench.run", "mocap_bench.drivers", "mocap_bench.scene",
                         "mocap_bench.trace", "mocap_bench.control", "mocap_bench.check",
                         "multiview_motion_capture_torch.tracker"])
    assert not loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level(["mocap_bench.reference", "mocap_bench.check", "mocap_bench.scene",
                         "mocap_bench.roofline"])
    assert not loaded & set(FORBIDDEN + ["multiview_motion_capture_torch"])


def test_metric_readers_load_no_program():
    from mocap_bench import spec

    names = [m["name"] for m in spec.load_benchmark()["per_layer"]]
    code = ("import sys, json; sys.path.insert(0, '.'); from mocap_bench import spec\n"
            f"[spec.reader(n) for n in {names!r}]\n"
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN + ["multiview_motion_capture_torch"])


@pytest.mark.parametrize("name", FORBIDDEN)
def test_the_run_refuses_a_loaded_forbidden_module(name, monkeypatch):
    from mocap_bench import run

    monkeypatch.setitem(sys.modules, name + ".sub", object())
    assert name in run.forbidden_modules()
    monkeypatch.delitem(sys.modules, name + ".sub")
    monkeypatch.setitem(sys.modules, name + "_x", object())
    assert name not in run.forbidden_modules()
