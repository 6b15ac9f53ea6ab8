"""The port's detect+track benchmark (`scripts/torch_bench_detect.py`) and
profilers (`scripts/torch_profile_bench.py`, `scripts/torch_profile_cam128.py`)
on the CPU.

- `torch_bench_detect.main` at 2 frames and 2 views prints one JSON line
  with the keys of the JAX program's line (read from its source), and its
  tracking stage gives exactly the tracklets of `pipeline.run` on the same
  batch; its configurations are the JAX program's.
- The profilers' report on a CPU trace of 3 SHELF_BENCH frames written in
  the Shelf dataset's layout: rows of name, ms and count (the host
  operators' own times: on the CPU the host is the device), the totals and
  both idle shares; the traced pass's outputs and tracklets equal the
  steady pass's.  A missing `--data_dir` raises FileNotFoundError naming
  it; `torch_profile_cam128`'s configuration is the JAX program's.
- The B-kernels' labels in the report.
"""
import ast
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multiview_motion_capture_torch import pipeline
from multiview_motion_capture_torch import tracker as TT
from multiview_motion_capture_torch.config import SHELF_BENCH, PipelineConfig
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import chip_smoke  # noqa: E402  (the Shelf-layout scene writer)
import torch_bench_detect  # noqa: E402
import torch_profile_bench  # noqa: E402
import torch_profile_cam128  # noqa: E402
from tests.torch_study_scene import one_thread  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _jax_source(name: str) -> ast.Module:
    return ast.parse((ROOT / "scripts" / name).read_text())


def _dict_keys(node: ast.Dict) -> set:
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def _jax_line_keys():
    """The keys of scripts/bench_detect.py's JSON line and of its `extra`."""
    for node in ast.walk(_jax_source("bench_detect.py")):
        if isinstance(node, ast.Dict) and "metric" in _dict_keys(node):
            extra = node.values[[k.value for k in node.keys].index("extra")]
            return _dict_keys(node), _dict_keys(extra)
    raise AssertionError("no JSON line in scripts/bench_detect.py")


def _jax_config_kwargs(name: str) -> dict:
    """The literal keyword arguments of the PipelineConfig call in a JAX
    script."""
    for node in ast.walk(_jax_source(name)):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "PipelineConfig":
            return {k.arg: ast.literal_eval(k.value) for k in node.keywords
                    if k.arg and isinstance(k.value, ast.Constant)}
    raise AssertionError(f"no PipelineConfig in scripts/{name}")


def test_bench_detect_line_and_tracking(monkeypatch, capsys):
    runs = []
    real = pipeline.run

    def recording(batch, cams, cfg, **kwargs):
        runs.append((batch, cams, cfg, kwargs, real(batch, cams, cfg, **kwargs)))
        return runs[-1][-1]

    monkeypatch.setattr(pipeline, "run", recording)
    line = torch_bench_detect.main(n_frames=2, n_views=2, device="cpu")
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(printed) == 1 and json.loads(printed[0]) == json.loads(json.dumps(line))
    keys, extra = _jax_line_keys()
    assert set(line) == keys and extra <= set(line["extra"])
    assert line["metric"] == "detect_track_e2e_fps" and line["extra"]["backend"] == "cpu"
    assert line["extra"]["n_frames"] == 2 and line["extra"]["n_views"] == 2
    assert all(v > 0 for k, v in line["extra"].items() if k.endswith("fps") or k.endswith("_fps_staged"))
    assert tuple(line["extra"]["frame_hw"]) == torch_bench_detect.FRAME_HW
    # the tracking stage is pipeline.run on the ground-truth batch at scale
    (batch, cams, cfg, kwargs, res), = runs
    assert kwargs == {"use_ik": True, "device": CPU}
    want = _jax_config_kwargs("bench_detect.py")
    assert {k: getattr(cfg, k) for k in want} == want and cfg.n_views == 2
    cfg2, seq, cams2, kps_px, _ = torch_bench_detect.make_frames(2, 3, 2)
    ref_batch = torch_bench_detect.tracking_batch(seq, kps_px)
    assert np.array_equal(batch.kps, ref_batch.kps) and np.array_equal(batch.valid, ref_batch.valid)
    ref = real(ref_batch, cams2, cfg2, use_ik=True, device="cpu")
    assert len(res.tracklets) == len(ref.tracklets) > 0
    for a, b in zip(res.tracklets, ref.tracklets):
        assert a.frame_idxs == b.frame_idxs and np.array_equal(a.poses_3d, b.poses_3d)


@pytest.fixture(scope="module")
def shelf3(tmp_path_factory):
    """3 SHELF_BENCH frames in the Shelf dataset's layout."""
    root = tmp_path_factory.mktemp("shelf3")
    seq = synthetic_sequence(cfg=dataclasses.replace(SHELF_BENCH, max_frames=None),
                             n_frames=3, n_people=3, n_views=5, seed=2)
    chip_smoke.write_scene_files(seq, root, 3, kps_dir="kps_opn")
    return root


def test_profile_bench_report_on_a_cpu_trace(shelf3, capsys):
    rep = torch_profile_bench.main(["--data_dir", str(shelf3), "--cpu"])
    out = capsys.readouterr().out
    assert "steady-state:" in out and "== device cpu" in out
    assert rep["frames"] == 3 and rep["device"] == "cpu"
    rows = rep["rows"]
    assert 0 < len(rows) <= torch_profile_bench.N_TOP
    assert all(set(r) == {"name", "ms", "count"} and r["ms"] >= 0 and r["count"] > 0
               for r in rows)
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows), reverse=True)
    assert 0 < sum(r["ms"] for r in rows) <= rep["total_ms"] + 1e-9
    assert 0 <= rep["idle_share"] < 1 and rep["idle_share_unprofiled"] < 1
    assert rep["b_kernel_launches"] == {k: 0 for k in rep["b_kernel_launches"]}
    # the traced pass computes what the steady pass computed
    steady, traced = rep["outputs"]
    for f in TT.FrameOutput._fields:
        assert np.array_equal(getattr(steady, f), getattr(traced, f)), f
    a, b = TT.assemble_tracklets(steady), TT.assemble_tracklets(traced)
    assert len(a) == len(b) > 0
    for s, t in zip(a, b):
        assert s.frame_idxs == t.frame_idxs and np.array_equal(s.poses_3d, t.poses_3d)
    # the report's JSON line
    line = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    assert line["total_ms"] == rep["total_ms"] and "rows" not in line


def test_device_events_read_a_cpu_trace_as_the_profiler_does():
    """The report reads a trace from the profiler's raw records (its own
    parse takes seconds for every ~20,000 events); on the CPU it takes each
    host operator's own time, its span less its direct children's.  The
    profiler's parse (`key_averages()`) of the same trace gives the same
    operators and own times.  It counts fewer calls: it folds a record that
    is the only child of a record of its own name into that record (the
    levels of aten::eye, for one), which keeps the name's own time; the raw
    records count each level."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(32, 32, generator=g)

    def work():
        for _ in range(5):
            a = torch.linalg.solve(x @ x.T + torch.eye(32), x)
            torch.nn.functional.layer_norm(torch.cdist(a, x), (32,)).sum()

    prof, _, _ = torch_profile_bench.trace(work, CPU)
    ours = {}
    for name, ns in torch_profile_bench.device_events(prof, CPU):
        t, n = ours.get(name, (0, 0))
        ours[name] = (t + ns, n + 1)
    theirs = {e.key: (e.self_cpu_time_total * 1e3, e.count) for e in prof.key_averages()}
    assert "aten::linalg_solve" in ours and len(ours) > 10
    assert sorted(ours) == sorted(theirs)
    for k, (ns, n) in ours.items():
        assert n >= theirs[k][1] and abs(ns - theirs[k][0]) <= 1e-3 * n, k


def test_profile_bench_needs_its_data(tmp_path):
    missing = tmp_path / "no_shelf_here"
    with pytest.raises(FileNotFoundError, match=str(missing)):
        torch_profile_bench.main(["--data_dir", str(missing), "--cpu"])
    with pytest.raises(FileNotFoundError, match=str(missing)):
        torch_profile_bench.load(missing)


def test_profile_cam128_config_is_the_jax_programs():
    want = _jax_config_kwargs("profile_cam128.py")
    for levers in (False, True):
        cfg = torch_profile_cam128.cam128_config(levers)
        assert {k: getattr(cfg, k) for k in want} == want
        default = PipelineConfig()
        assert (cfg.ik_cold_stages, cfg.ik_warm_iters) == (
            (1, 3) if levers else (default.ik_cold_stages, default.ik_warm_iters))
    assert want["n_views"] == 128 and want["assoc_clusters"] == 4


@pytest.mark.parametrize("name,label", [
    ("void (anonymous namespace)::als_kernel(float const*, unsigned char const*)", "B1/B3"),
    ("void gj_solve_kernel<5>(float const*, float const*, float*, int)", "B2/B5"),
    ("fused_normal_gj_kernel(float const*, float const*, float const*, float*, int, int)", "B4"),
])
def test_report_names_the_b_kernels(name, label):
    assert torch_profile_bench.kernel_label(name).startswith(label + " ")
    assert torch_profile_bench.kernel_label("aten::mul") == "aten::mul"
