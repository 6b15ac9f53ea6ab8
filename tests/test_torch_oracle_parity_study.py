"""`scripts/torch_oracle_parity_study.py` against `scripts/parity_study.py`
on the CPU, on a 12-frame scene written in Shelf's layout in which tracks
die and respawn (tests/torch_study_scene.py, drop probability 0.2).  The
JAX script reads Shelf from a fixed path and writes docs/parity_study.json;
the test hands it the scene through its loaders and its output directory
(monkeypatch).  The oracle is one host program in both packages
(tests/test_torch_oracle_copy.py holds the port's copy equal to it), so it
runs once: the port's study is handed the JAX script's run, after its
inputs are checked to be the same.

- The parity summary: the tracker's and the oracle's tracklet counts, top
  lengths, coverage and active tracks, the matched pairs, the frame-131
  zoom and the fragment events equal, MPJPE within MPJPE_TOL_CM.  The
  zoom reads frames 120-145, which the JAX script indexes unguarded, so it
  runs with `range(120, 146)` clipped to the scene's frames (the port's
  study clips it itself).  The port writes its JSON to `--out`.
"""
import builtins
import json

import jax
import numpy as np
import pytest
import torch

from multiview_motion_capture_tpu.data.ingest import load_openpose_dir as j_load
from tests import oracle_pipeline as j_oracle
from tests.torch_study_scene import DEATHS_DROP_PROB, JaxCameras, N_FRAMES, one_thread, write_scene

import parity_study as j_parity  # noqa: E402  (scripts/ on the path)
import torch_oracle_parity_study as t_parity  # noqa: E402

# the JAX script sets the compilation cache at import; keep the suite's
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")

MPJPE_TOL_CM = 1e-2
SETTLED_CAP = 1000      # PipelineConfig's ALS cap


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def test_oracle_parity_study_matches_jax(tmp_path, monkeypatch, capsys):
    root = write_scene(tmp_path / "scene", DEATHS_DROP_PROB)
    out_dir = tmp_path / "out"
    (out_dir / "docs").mkdir(parents=True)
    monkeypatch.setattr(j_parity, "N_FRAMES", N_FRAMES)
    monkeypatch.setattr(j_parity, "REPO", out_dir)
    monkeypatch.setattr(j_parity, "load_openpose_dir",
                        lambda _path, cfg: j_load(root / "kps_opn", cfg))
    monkeypatch.setattr(j_parity, "CameraBank", JaxCameras(root))
    monkeypatch.setattr(j_parity, "range", lambda *a: builtins.range(
        *((a[0], min(a[1], N_FRAMES)) if a == (120, 146) else a)), raising=False)
    j_runs = []

    def run_oracle(kps, valid, cams, n_frames, use_ik=True):
        j_runs.append(((np.asarray(kps)[:n_frames], np.asarray(valid)[:n_frames], n_frames),
                       j_oracle.run_oracle(kps, valid, cams, n_frames, use_ik=use_ik)))
        return j_runs[-1][1]

    def run_oracle_cached(kps, valid, cams, n_frames, data_dir, cache_dir=None):
        (j_kps, j_valid, j_n), tlets = j_runs[0]
        assert n_frames == j_n and data_dir == root
        np.testing.assert_array_equal(np.asarray(kps)[:n_frames], j_kps)
        np.testing.assert_array_equal(np.asarray(valid)[:n_frames], j_valid)
        return tlets

    monkeypatch.setattr(j_parity, "run_oracle", run_oracle)
    j_parity.main()
    capsys.readouterr()
    j_out = json.loads((out_dir / "docs" / "parity_study.json").read_text())

    monkeypatch.setattr(t_parity, "run_oracle_cached", run_oracle_cached)
    path = out_dir / "port_parity.json"
    got = {}
    out = t_parity.main(["--data_dir", str(root), "--max_frames", str(N_FRAMES),
                         "--oracle_cache", str(out_dir), "--out", str(path), "--cpu"],
                        outputs=got)
    capsys.readouterr()

    assert got["oracle"] is j_runs[0][1] and len(j_runs) == 1
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    assert set(out) == set(j_out) | {"backend"} and out["backend"] == "cpu"
    for side in ("tpu", "oracle"):
        assert set(out[side]) == set(j_out[side])
        for k in ("n_tracklets", "lengths_top10", "coverage", "mean_active"):
            assert out[side][k] == j_out[side][k], (side, k)
    for k in ("n_frames", "matched_pairs", "matched_oracle_frames", "frame131_zoom",
              "tpu_events_120_145", "oracle_events_120_145", "active_count_agreement"):
        assert json.loads(json.dumps(out[k])) == j_out[k], k
    assert out["matched_pairs"] >= 2
    print("MPJPE cm, port / JAX:", out["mpjpe_cm"], j_out["mpjpe_cm"])
    for k, v in j_out["mpjpe_cm"].items():
        assert abs(out["mpjpe_cm"][k] - v) <= MPJPE_TOL_CM, (k, out["mpjpe_cm"][k], v)
