"""The port's benchmark programs against the JAX package on the CPU: the
CLI's `bench` mode (`multiview_motion_capture_torch.bench`), the scaled-rig
benchmark (`scripts/torch_bench_scaled.py`) and the streaming curve
(`scripts/torch_bench_streaming.py`).

- `bench.measure` on a small scene written as files in the Shelf dataset's
  layout (`kps_opn/`, `calibs/`), against the JAX package's
  `load_openpose_dir` + `pipeline.run` + `eval.reprojection_metrics` on
  the same files: tracklets, frames and lengths equal, reprojection within
  REPROJ_TOL_PX.  SHELF_BENCH caps the ALS at 100 iterations, where no
  small scene settles on every frame (frame 0's empty track rows keep it
  moving), and an unsettled frame groups by rounding in either package; so
  the comparison runs SHELF_BENCH with the ALS cap at 1,000 (the config
  module's SHELF_BENCH replaced for the test), and asserts that every frame
  settles below it.
- The same at seeds 1 and 3, where the decisions are equal too but the
  poses part by more than rounding shows in the reprojection
  (`scripts/torch_parity_study.py --study bench`): at seed 3 the poses stay
  within 4e-5 m and the median reprojection still differs by 2e-4 px; at
  seed 1 slot 0's pose parts from frame 2 on and reaches 0.11 m.  The study
  names the cause: SHELF_BENCH's warm LM stops after 5 iterations far from
  its minimum (cost 1,745 where 200 iterations reach 185), on a normal
  matrix with a null direction, so each frame's pose depends on where the
  last one left it, and a 1e-5 m difference of the two packages' f32
  rounding grows by ~7x a frame.  A float64 LM (the witness) follows the
  port's poses, which lie 6 mm from the truth where JAX's lie 15-35 mm.
  So the test holds what the study found: equal decisions; every frame
  stepped by both packages from the JAX run's state equal within
  STEP_TOL_M (the gap is not made in any one step); and the port's mean
  reprojection no worse than JAX's beyond REPROJ_TOL_PX.  At seed 0 frame
  0 groups otherwise: W differs by 5e-7 between the packages, and the ALS
  then binarizes 4 entries 0.01 from 0.5 otherwise; neither grouping is the
  ground truth's, so seed 0 holds nothing to compare.
- `bench.main` prints bench.py's JSON line; a missing directory raises
  FileNotFoundError (no other scene is put in its place).  Its
  `vs_baseline` rounds the unrounded frames/s (as bench.py does), so the
  check accepts the two values that rounding can give beside the printed
  `value`; a frames/s in [x.x45, x.x50) gives the lower one, which
  `round(value / 100, 3)` misses.
- `bench_config` on a 12-view, 5-cluster rig (non-divisible: clusters of
  3 views with dead pad views), 3 people, `ik_max_views=4`, 3 frames,
  against the JAX package's tracker on the same scene: decisions, tracklets
  and long tracklets equal in both modes.  The JAX package's functions are
  called directly (its script sets a TPU compilation cache at import).
- The streaming curve at k in {1, 4} on 6 frames: every k's outputs equal
  `run_offline`'s on those frames, bit for bit.
"""
import dataclasses
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch import bench
from multiview_motion_capture_torch import config as t_config
from multiview_motion_capture_torch import tracker as TT
from multiview_motion_capture_torch.cameras import CameraBank as TCameraBank
from multiview_motion_capture_torch.config import SHELF_BENCH as T_SHELF
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth
from multiview_motion_capture_tpu import eval as j_eval
from multiview_motion_capture_tpu import pipeline as j_pipeline
from multiview_motion_capture_tpu import tracker as JT
from multiview_motion_capture_tpu.cameras import CameraBank as JCameraBank
from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
from multiview_motion_capture_tpu.config import SHELF_BENCH as J_SHELF
from multiview_motion_capture_tpu.data.ingest import filter_bad_poses as j_filter
from multiview_motion_capture_tpu.data.ingest import load_openpose_dir as j_load
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import chip_smoke  # noqa: E402  (the scene writer the card's bench phase uses)
import torch_bench_scaled  # noqa: E402
import torch_bench_streaming  # noqa: E402
from tests.torch_study_scene import one_thread, shared_jax_contexts  # noqa: E402

DECISIONS = ("track_id", "active", "updated", "spawned", "died_track_id", "matched_pose")
REPROJ_TOL_PX = 1e-4
STEP_TOL_M = 1e-4
N_FRAMES = 12
SCENE = dict(n_frames=N_FRAMES, n_people=3, n_views=5, seed=2)
SETTLED_CAP = 1000
# bench.py's JSON line (bench.py:75-100); quality_gate only when it fails
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
EXTRA_KEYS = {"n_frames", "n_tracklets", "top_track_lengths", "reproj_px_mean",
              "reproj_px_median", "n_degenerate_poses", "track_time_s", "compile_s",
              "backend", "reproj_mean_trend", "quality_ok"}
GATE_KEYS = {"median_le", "mean_le", "tracklet_band", "long_tracks", "no_degenerate"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_contexts():
    """The seeds' scenes share the rig and the config, so JAX's scan and
    step are traced and compiled once for the file."""
    with shared_jax_contexts():
        yield


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step jitted once per context."""
    steps = {}

    def get(jctx):
        if id(jctx) not in steps:
            steps[id(jctx)] = (jctx, jax.jit(JT.make_step(jctx)))
        return steps[id(jctx)][1]

    return get


def write_scene(root, **scene):
    seq = t_synth(cfg=dataclasses.replace(T_SHELF, max_frames=None), **scene)
    chip_smoke.write_scene_files(seq, root, scene["n_frames"], kps_dir="kps_opn")
    return root


@pytest.fixture(scope="module")
def shelf_dir(tmp_path_factory):
    """SCENE written in the Shelf dataset's layout."""
    return write_scene(tmp_path_factory.mktemp("shelf_scene"), **SCENE)


def jax_bench(data_dir):
    """bench.py's run of the JAX package on `data_dir` at the settled cap:
    (config, batch, cameras, RunResult, reprojection metrics)."""
    jcfg = dataclasses.replace(J_SHELF, als_max_iter=SETTLED_CAP, max_frames=N_FRAMES)
    jbatch = j_load(data_dir / "kps_opn", jcfg)
    jcams = JCameraBank.from_json_dir(data_dir / "calibs")
    jres = j_pipeline.run(jbatch, jcams, jcfg, use_ik=True)
    return jcfg, jbatch, jcams, jres, j_eval.reprojection_metrics(jres.tracklets, jbatch, jcams)


def test_measure_matches_jax(shelf_dir, monkeypatch):
    # `measure` runs SHELF_BENCH as the config module holds it
    monkeypatch.setattr(t_config, "SHELF_BENCH",
                        dataclasses.replace(T_SHELF, als_max_iter=SETTLED_CAP))
    with chip_smoke.recording_run_offline() as passes:
        out = bench.measure(shelf_dir, max_frames=N_FRAMES, device="cpu")
    res, m = out["result"], out["metrics"]

    _, _, _, jres, jm = jax_bench(shelf_dir)

    assert res.n_frames == jres.n_frames == N_FRAMES
    assert len(res.tracklets) == len(jres.tracklets) >= 3
    assert m.lengths == jm.lengths and m.frames_covered == jm.frames_covered
    assert [list(t.frame_idxs) for t in res.tracklets] == \
        [list(t.frame_idxs) for t in jres.tracklets]
    assert abs(m.mean_reproj_px - jm.mean_reproj_px) <= REPROJ_TOL_PX
    assert abs(m.median_reproj_px - jm.median_reproj_px) <= REPROJ_TOL_PX
    assert m.n_degenerate_poses == jm.n_degenerate_poses == 0
    assert set(out["gate"]) == GATE_KEYS and out["quality_ok"] == all(out["gate"].values())
    assert out["backend"] == "cpu"

    # every frame's ALS settles below the cap, so its grouping is the
    # solve's, not the rounding's
    iters = TT.outputs_to_numpy(passes[-1][1]).als_iters
    assert len(iters) == N_FRAMES and (iters < SETTLED_CAP).all(), iters


@pytest.mark.parametrize("seed", [1, 3])
def test_measure_lm_gap_is_bounded(seed, tmp_path, monkeypatch, jax_step):
    data_dir = write_scene(tmp_path, **dict(SCENE, seed=seed))
    monkeypatch.setattr(t_config, "SHELF_BENCH",
                        dataclasses.replace(T_SHELF, als_max_iter=SETTLED_CAP))
    out = bench.measure(data_dir, max_frames=N_FRAMES, device="cpu")
    res, m = out["result"], out["metrics"]
    jcfg, jbatch, jcams, jres, jm = jax_bench(data_dir)
    assert len(res.tracklets) == len(jres.tracklets) >= 3
    assert m.lengths == jm.lengths and m.frames_covered == jm.frames_covered
    assert [list(t.frame_idxs) for t in res.tracklets] == \
        [list(t.frame_idxs) for t in jres.tracklets]
    assert m.mean_reproj_px <= jm.mean_reproj_px + REPROJ_TOL_PX

    # every frame stepped by both packages from the JAX run's state
    jb = j_filter(jbatch, jcfg)
    jctx = JT.TrackerContext.build(jcams, jcfg)
    tcfg = dataclasses.replace(t_config.SHELF_BENCH, max_frames=N_FRAMES)
    tctx = TT.TrackerContext.build(TCameraBank.from_json_dir(data_dir / "calibs"), tcfg,
                                   device="cpu")
    jstep, tstep = jax_step(jctx), TT.make_step(tctx)
    jstate = JT.TrackerState.zeros(jcfg)
    fields = TT.TrackerState.__dataclass_fields__
    for f in range(N_FRAMES):
        ts = TT.from_numpy_state({k: np.asarray(getattr(jstate, k)) for k in fields},
                                 device="cpu")
        _, to = tstep(ts, torch.as_tensor(jb.kps[f]), torch.as_tensor(jb.valid[f]))
        jstate, jo = jstep(jstate, (jnp.asarray(jb.kps[f]), jnp.asarray(jb.valid[f])))
        jo = jax.device_get(jo)
        for k in DECISIONS:
            np.testing.assert_array_equal(getattr(to, k).numpy(), np.asarray(getattr(jo, k)),
                                          err_msg=f"frame {f}: {k}")
        upd = np.asarray(jo.updated)
        np.testing.assert_allclose(to.pose3d.numpy()[upd], np.asarray(jo.pose3d)[upd],
                                   rtol=0, atol=STEP_TOL_M, err_msg=f"frame {f}")


def test_main_prints_the_bench_line(shelf_dir, capsys):
    """SHELF_BENCH as it ships: the line has bench.py's keys; the small
    scene misses the Shelf bands, so the gate fails with bench.py's
    message after the line is printed."""
    with pytest.raises(SystemExit, match="bench quality gate FAILED"):
        bench.main(shelf_dir, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS
    assert (line["metric"], line["unit"]) == ("shelf_e2e_fps_5cam_ik", "frames/s")
    assert set(line["extra"]) == EXTRA_KEYS | {"quality_gate"}
    assert set(line["extra"]["quality_gate"]) == GATE_KEYS
    assert line["extra"]["n_frames"] == N_FRAMES and line["extra"]["backend"] == "cpu"
    assert line["vs_baseline"] in reachable_ratios(line["value"])
    trend = line["extra"]["reproj_mean_trend"]
    assert trend["r05"] == 9.1 and trend["now"] == line["extra"]["reproj_px_mean"]


def reachable_ratios(value: float) -> set:
    """The `vs_baseline` values that bench.py's rounding can print beside
    `value`: `round(fps / 100, 3)` for any frames/s that `round(fps, 2)`
    prints as `value`, i.e. at the two edges of [value - 0.005, value +
    0.005] (the band is 1e-4 wide after the division, so at most two)."""
    return {round((value - 0.005) / 100.0, 3), round((value + 0.005) / 100.0, 3)}


@pytest.mark.parametrize("fps", [1.247, 2.346, 3.1475])
def test_bench_line_ratio_in_the_rounding_band(fps, capsys, monkeypatch):
    """`bench.main`'s line at a frames/s in [x.x45, x.x50): `value` rounds
    up to x.x5 while `vs_baseline` rounds the unrounded frames/s down, so
    it differs from `round(value / 100, 3)` (the check before, which such
    a CPU speed failed) and lies in `reachable_ratios(value)`."""
    res = types.SimpleNamespace(fps=fps, n_frames=N_FRAMES, tracklets=[],
                                track_time_s=N_FRAMES / fps)
    metrics = types.SimpleNamespace(lengths=[], mean_reproj_px=1.0, median_reproj_px=1.0,
                                    n_degenerate_poses=0)
    monkeypatch.setattr(bench, "measure", lambda data_dir, device: {
        "result": res, "metrics": metrics, "gate": dict.fromkeys(GATE_KEYS, True),
        "quality_ok": True, "compile_s": 0.0, "backend": "cpu"})
    line = bench.main(Path("unused"), device="cpu")
    printed = json.loads(capsys.readouterr().out.strip())
    assert printed == line and printed["value"] == round(fps, 2)
    assert printed["vs_baseline"] == round(fps / 100.0, 3)
    assert printed["vs_baseline"] != round(printed["value"] / 100.0, 3)
    assert printed["vs_baseline"] in reachable_ratios(printed["value"])
    assert reachable_ratios(printed["value"]) == {round(printed["vs_baseline"], 3),
                                                  round(printed["vs_baseline"] + 0.001, 3)}


def test_missing_data_dir_raises(tmp_path):
    missing = tmp_path / "no_shelf"
    with pytest.raises(FileNotFoundError, match="no_shelf"):
        bench.measure(missing, device="cpu")
    with pytest.raises(FileNotFoundError, match="no_shelf"):
        bench.main(missing, device="cpu")
    with pytest.raises(FileNotFoundError, match="no_shelf"):
        torch_bench_streaming.main(["--data_dir", str(missing), "--cpu"])


def test_bench_config_matches_jax_on_a_nondivisible_rig():
    kw = dict(clusters=5, ik_max_views=4)
    outs = {}
    got = torch_bench_scaled.bench_config(12, 3, n_frames=3, device="cpu", outputs=outs, **kw)
    tcfg = torch_bench_scaled.scaled_config(12, 3, **kw)
    # the JAX side of scripts/bench_scaled.py:39-48, its XLA ALS on the CPU
    jcfg = JConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(JConfig)})
    js = j_synth(n_frames=3, n_people=3, n_views=12, cfg=jcfg, seed=0, noise_px=1.0,
                 drop_prob=0.05)
    assert tcfg.n_matrix == jcfg.n_matrix == 16 + 12 * 3
    for use_ik, mode in torch_bench_scaled.MODES:
        ctx = JT.TrackerContext.build(js.cameras, jcfg, use_ik=use_ik)
        _, jo = JT.run_offline(ctx, jnp.asarray(js.batch.kps), jnp.asarray(js.batch.valid))
        jo = jax.device_get(jo)
        for f in DECISIONS:
            np.testing.assert_array_equal(getattr(outs[mode], f), np.asarray(getattr(jo, f)),
                                          err_msg=f"{mode}: {f}")
        jt = JT.assemble_tracklets(jo)
        assert got[mode]["n_tracklets"] == len(jt) > 0
        assert got[mode]["n_long"] == len([t for t in jt if len(t) >= 1])
        assert got[mode]["n_matrix"] == jcfg.n_matrix
        assert got[mode]["kernel_launches"] == dict.fromkeys(
            ("als", "als_batched", "gj_solve", "fused_normal_gj"), 0)
        assert outs[mode].updated.any()
    assert got["assoc_tri"]["mpjpe_m"] > 0 and got["full_ik"]["mpjpe_m"] is None


def test_stream_curve_equals_run_offline(shelf_dir):
    cfg, batch, cams = torch_bench_streaming.load(shelf_dir, max_frames=6)
    kps, valid = batch.kps[:6], batch.valid[:6]
    trackers = {}
    res = torch_bench_streaming.stream_curve(cams, cfg, kps, valid, ks=(1, 4), device="cpu",
                                             trackers=trackers)
    assert set(res) == {"k=1", "k=4"}
    ctx = TT.TrackerContext.build(cams, cfg, device="cpu")
    ref = TT.outputs_to_numpy(TT.run_offline(ctx, kps, valid)[1])
    for k, trk in trackers.items():
        assert trk.frame_idxs == list(range(6))
        for f in TT.FrameOutput._fields:
            np.testing.assert_array_equal(np.stack([getattr(o, f) for o in trk.outputs]),
                                          getattr(ref, f), err_msg=f"k={k}: {f}")
        assert res[f"k={k}"]["n_tracklets"] == len(TT.assemble_tracklets(ref)) > 0
        assert set(res[f"k={k}"]) == {"fps", "dispatch_ms_p50", "dispatch_ms_p99",
                                      "n_tracklets"}
