"""`scripts/torch_bench_quality_bisect.py` against `scripts/
bench_quality_bisect.py` on the CPU: the benchmark's pipeline (SHELF_BENCH,
IK on, `load_openpose_dir` -> `pipeline.run` -> `reprojection_metrics`)
under the four config variants, on the first BISECT_FRAMES frames of
tests/test_torch_bench.py's scene written in Shelf's layout
(tests/torch_study_scene.py).  The JAX
script reads Shelf from a fixed path; the test hands it the scene through
its loaders (monkeypatch).

SHELF_BENCH runs with the ALS cap at 1,000 in both packages (the config
modules' preset replaced, as tests/test_torch_bench.py does: at the
preset's 100 no small scene settles frame 0, and an unsettled frame groups
by rounding in either package); every frame settles.  For each variant:
the JSON keys, tracklet count, top lengths and each tracklet's frames
equal, the mean and median reprojection within REPROJ_TOL_PX.  The JAX
package compiles one tracker program a variant (~10 s each on this CPU)
when its compilation cache is cold, ~5 s warm; the programs' Pallas
interpret callbacks keep some of it from the cache) and the port tracks
each variant twice (`pipeline.run`'s two passes, ~2 s a variant and
frame on one CPU thread), so the test takes BISECT_FRAMES of the scene's
12 frames to stay near a minute alone (57 s warm, 80 s cold, here).  At
6 frames the median reprojection parts by 5.8e-4 px in `current_r4`:
the median of so few residuals sits on single samples, where
SHELF_BENCH's 5-iteration warm LM leaves the two packages' poses apart
by their rounding (ROADMAP C, tests/test_torch_bench.py's seeds 1 and 3);
at 8 frames the gaps are 3.6e-6 px (mean) and 2.3e-5 px (median).
"""
import contextlib
import dataclasses
import io
import json

import jax
import pytest

from multiview_motion_capture_torch import config as t_config
from multiview_motion_capture_torch.cameras import CameraBank
from multiview_motion_capture_torch.config import SHELF_BENCH as T_SHELF
from multiview_motion_capture_torch.data.ingest import load_openpose_dir
from multiview_motion_capture_torch.eval import reprojection_metrics
from multiview_motion_capture_torch.tracker import outputs_to_numpy
from multiview_motion_capture_tpu.config import SHELF_BENCH as J_SHELF
from multiview_motion_capture_tpu.data.ingest import load_openpose_dir as j_load
from tests.torch_study_scene import JaxCameras, chip_smoke, one_thread, write_scene

import bench_quality_bisect as j_bisect  # noqa: E402  (scripts/ on the path)
import torch_bench_quality_bisect as t_bisect  # noqa: E402

# the JAX script sets the compilation cache at import; keep the suite's
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")

BISECT_FRAMES = 8
SETTLED_CAP = 1000
REPROJ_TOL_PX = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def bisect(tmp_path_factory):
    """Both scripts on the scene: the JAX script's JSON line with its
    `pipeline.run` results and metrics, the port's, and the port's tracker
    passes."""
    root = write_scene(tmp_path_factory.mktemp("bisect_scene"))
    j_runs, j_metrics = [], []
    real_run, real_metrics = j_bisect.run, j_bisect.reprojection_metrics

    def run(*a, **k):
        j_runs.append(real_run(*a, **k))
        return j_runs[-1]

    def metrics(*a, **k):
        j_metrics.append(real_metrics(*a, **k))
        return j_metrics[-1]

    results, printed = {}, io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_bisect, "SHELF_BENCH", dataclasses.replace(J_SHELF, als_max_iter=SETTLED_CAP))
        mp.setattr(j_bisect, "load_openpose_dir",
                   lambda _path, cfg: j_load(root / "kps_opn", cfg, max_frames=BISECT_FRAMES))
        mp.setattr(j_bisect, "CameraBank", JaxCameras(root))
        mp.setattr(j_bisect, "run", run)
        mp.setattr(j_bisect, "reprojection_metrics", metrics)
        with contextlib.redirect_stdout(printed):
            j_bisect.main()
        j_out = json.loads(printed.getvalue().strip().splitlines()[-1])
        mp.setattr(t_config, "SHELF_BENCH", dataclasses.replace(T_SHELF, als_max_iter=SETTLED_CAP))
        with chip_smoke.recording_run_offline() as passes, \
                contextlib.redirect_stdout(io.StringIO()):
            out = t_bisect.main(["--data_dir", str(root), "--max_frames", str(BISECT_FRAMES),
                                 "--cpu"], outputs=results)
    cfg = dataclasses.replace(T_SHELF, max_frames=BISECT_FRAMES)
    return dict(out=out, j_out=j_out, results=results, passes=passes, j_runs=j_runs,
                j_metrics=j_metrics, batch=load_openpose_dir(root / "kps_opn", cfg),
                cams=CameraBank.from_json_dir(root / "calibs"))


def test_variants_and_keys_match_jax(bisect):
    assert list(bisect["out"]) == list(bisect["j_out"]) == list(t_bisect.VARIANTS)
    assert len(bisect["j_runs"]) == len(bisect["j_metrics"]) == len(t_bisect.VARIANTS)


def test_every_frame_settles(bisect):
    # each variant's timed pass settles every frame's ALS below the cap
    assert len(bisect["passes"]) == 2 * len(t_bisect.VARIANTS)
    for _, o in bisect["passes"][1::2]:
        iters = outputs_to_numpy(o).als_iters
        assert len(iters) == BISECT_FRAMES and (iters < SETTLED_CAP).all(), iters


@pytest.mark.parametrize("i,name", list(enumerate(t_bisect.VARIANTS)))
def test_bench_quality_bisect_matches_jax(bisect, i, name):
    got, ref = bisect["out"][name], bisect["j_out"][name]
    assert set(got) == set(ref)
    assert got["n_tracklets"] == ref["n_tracklets"] >= 3, name
    assert got["top_lengths"] == ref["top_lengths"], name
    res = bisect["results"][name]
    assert [list(t.frame_idxs) for t in res.tracklets] == \
        [list(t.frame_idxs) for t in bisect["j_runs"][i].tracklets], name
    m = reprojection_metrics(res.tracklets, bisect["batch"], bisect["cams"])
    jm = bisect["j_metrics"][i]
    assert abs(m.mean_reproj_px - jm.mean_reproj_px) <= REPROJ_TOL_PX, name
    assert abs(m.median_reproj_px - jm.median_reproj_px) <= REPROJ_TOL_PX, name
