"""`scripts/torch_oracle_parity_study.py` against `scripts/parity_study.py`
on the CPU, on a 12-frame scene written in Shelf's layout in which tracks
die and respawn (tests/torch_study_scene.py, drop probability 0.2).  The
JAX script reads Shelf from a fixed path and writes docs/parity_study.json;
the test hands it the scene through its loaders and its output directory
(monkeypatch).  The oracle is one host program in both packages
(tests/test_torch_oracle_copy.py holds the port's copy equal to it), so it
runs once for this file and tests/test_torch_fragmentation_study.py
together: the JAX script's `run_oracle` reads the port's copy's run on the
scene written once for the test run (`torch_study_scene.shared_oracle`),
and the port's study is handed that run, after its inputs are checked to
be the same.

- The parity summary: the tracker's and the oracle's tracklet counts, top
  lengths, coverage and active tracks, the matched pairs, the frame-131
  zoom and the fragment events equal, MPJPE within MPJPE_TOL_CM.  The
  zoom reads frames 120-145, which the JAX script indexes unguarded, so it
  runs with `range(120, 146)` clipped to the scene's frames (the port's
  study clips it itself).  The port writes its JSON to `--out`.
"""
import builtins
import contextlib
import io
import json

import jax
import numpy as np
import pytest

from multiview_motion_capture_tpu.data.ingest import load_openpose_dir as j_load
from tests.torch_study_scene import JaxCameras, N_FRAMES, one_thread, shared_deaths_scene
from tests.torch_study_scene import shared_oracle

import parity_study as j_parity  # noqa: E402  (scripts/ on the path)
import torch_oracle_parity_study as t_parity  # noqa: E402

# the JAX script sets the compilation cache at import; keep the suite's
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")

MPJPE_TOL_CM = 1e-2
SETTLED_CAP = 1000      # PipelineConfig's ALS cap


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The JAX script's JSON and its one oracle run, and the port's study
    handed that run."""
    root = shared_deaths_scene(tmp_path_factory)
    out_dir = tmp_path_factory.mktemp("oracle_parity")
    (out_dir / "docs").mkdir(parents=True)
    j_runs = []

    def run_oracle(kps, valid, cams, n_frames, use_ik=True):
        j_runs.append(((np.asarray(kps)[:n_frames], np.asarray(valid)[:n_frames], n_frames),
                       shared_oracle(kps, valid, cams, n_frames, root, use_ik)))
        return j_runs[-1][1]

    def run_oracle_cached(kps, valid, cams, n_frames, data_dir, cache_dir=None):
        (j_kps, j_valid, j_n), tlets = j_runs[0]
        assert n_frames == j_n and data_dir == root
        np.testing.assert_array_equal(np.asarray(kps)[:n_frames], j_kps)
        np.testing.assert_array_equal(np.asarray(valid)[:n_frames], j_valid)
        return tlets

    path, got = out_dir / "port_parity.json", {}
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(j_parity, "N_FRAMES", N_FRAMES)
        mp.setattr(j_parity, "REPO", out_dir)
        mp.setattr(j_parity, "load_openpose_dir",
                   lambda _path, cfg: j_load(root / "kps_opn", cfg))
        mp.setattr(j_parity, "CameraBank", JaxCameras(root))
        mp.setattr(j_parity, "range", lambda *a: builtins.range(
            *((a[0], min(a[1], N_FRAMES)) if a == (120, 146) else a)), raising=False)
        mp.setattr(j_parity, "run_oracle", run_oracle)
        j_parity.main()
        j_out = json.loads((out_dir / "docs" / "parity_study.json").read_text())
        mp.setattr(t_parity, "run_oracle_cached", run_oracle_cached)
        out = t_parity.main(["--data_dir", str(root), "--max_frames", str(N_FRAMES),
                             "--oracle_cache", str(out_dir), "--out", str(path), "--cpu"],
                            outputs=got)
    return dict(j_out=j_out, j_runs=j_runs, out=out, got=got, path=path)


def test_oracle_run_once_and_json_written(parity):
    out, j_out = parity["out"], parity["j_out"]
    assert parity["got"]["oracle"] is parity["j_runs"][0][1] and len(parity["j_runs"]) == 1
    assert json.loads(parity["path"].read_text()) == json.loads(json.dumps(out))
    assert set(out) == set(j_out) | {"backend"} and out["backend"] == "cpu"


@pytest.mark.parametrize("side", ["tpu", "oracle"])
def test_oracle_parity_study_matches_jax(parity, side):
    out, j_out = parity["out"], parity["j_out"]
    assert set(out[side]) == set(j_out[side])
    for k in ("n_tracklets", "lengths_top10", "coverage", "mean_active"):
        assert out[side][k] == j_out[side][k], (side, k)


def test_matches_zoom_and_events_equal(parity):
    out, j_out = parity["out"], parity["j_out"]
    for k in ("n_frames", "matched_pairs", "matched_oracle_frames", "frame131_zoom",
              "tpu_events_120_145", "oracle_events_120_145", "active_count_agreement"):
        assert json.loads(json.dumps(out[k])) == j_out[k], k
    assert out["matched_pairs"] >= 2


def test_mpjpe_matches_jax(parity):
    out, j_out = parity["out"], parity["j_out"]
    print("MPJPE cm, port / JAX:", out["mpjpe_cm"], j_out["mpjpe_cm"])
    for k, v in j_out["mpjpe_cm"].items():
        assert abs(out["mpjpe_cm"][k] - v) <= MPJPE_TOL_CM, (k, out["mpjpe_cm"][k], v)
