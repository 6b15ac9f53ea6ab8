"""The port's association debug dump (`multiview_motion_capture_torch.debug`)
against the JAX package's (`multiview_motion_capture_tpu.debug`) on the
three scenes of tests/test_debug_dump.py (synthetic, 2 people, seed 3,
drop 0.15), on the CPU: the same files, npz keys, csv headers and summary
fields, the same groups.

Both dumps start from the same replayed states: the port's replay (held
equal to its `run_offline` below) is handed to the JAX module in place of
its own `replay_states`, so each frame's dump is compared from one state,
and the JAX side compiles no tracker scan (which would take this file past
a minute).

The dumped frames' ALS runs to its 100-iteration cap or stops by the
stable-binarization rule at another iteration in the two packages (the
port's ridge solves are the TPU kernel's Gauss-Jordan, JAX's debug solve
is its XLA ALS with Cholesky solves, and they round differently), so the
continuous X is held on the elements the grouping reads (valid tracks and
detections) and within X_TOL there: measured 0.0004-0.057 on these frames
(the widest where JAX's ALS stops by the stable rule at iteration 75 and
the port's runs to its cap).  x_bin is equal on those elements; on the
padded slots (free track slots, missing detections) the ALS iterates on
zero rows whose X no decision reads, and there the two differ.
"""
import json

import numpy as np
import pytest

from multiview_motion_capture_tpu import debug as j_debug
from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence
from multiview_motion_capture_tpu.tracker import TrackerContext as JContext
from multiview_motion_capture_torch import debug as t_debug
from multiview_motion_capture_torch.cameras import CameraBank
from multiview_motion_capture_torch.config import PipelineConfig as TConfig
from multiview_motion_capture_torch.tracker import TrackerContext as TContext
from tests.torch_study_scene import one_thread

X_TOL = 0.1
SIM_TOL = 1e-5      # the similarity: f64 in the port rounded once, f32 in JAX
D23_TOL = 1e-3      # px; reprojection distances of ~1e2 px in f32

SCENES = {
    # name: (config, views, frames, dumped frames (None: auto), frame blanked)
    "monolithic": (dict(n_views=4, max_people=4, max_tracks=6, als_max_iter=100), 4, 10,
                   [0, 4], None),
    "death_frames": (dict(n_views=4, max_people=4, max_tracks=6, als_max_iter=100,
                          track_rescue_px=0.0), 4, 12, None, 8),
    "clustered": (dict(n_views=8, max_people=4, max_tracks=6, als_max_iter=100,
                       assoc_clusters=2), 8, 10, [3], None),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _dumps(tmp_path, monkeypatch, name):
    cfg_kw, V, F, frames, blank = SCENES[name]
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    seq = synthetic_sequence(n_frames=F, n_people=2, n_views=V, cfg=jcfg, seed=3,
                             drop_prob=0.15)
    kps, valid = seq.batch.kps.copy(), seq.batch.valid.copy()
    if blank is not None:
        valid[blank] = False               # everyone vanishes: deaths at that frame
    cams = CameraBank.from_k_rt(np.asarray(seq.cameras.K), np.asarray(seq.cameras.Rt),
                                np.asarray(seq.cameras.img_wh))
    tctx = TContext.build(cams, tcfg, use_ik=True, device="cpu")
    replayed, replay = [], t_debug.replay_states             # numpy states and outputs
    monkeypatch.setattr(t_debug, "replay_states",
                        lambda *a, **kw: replayed.append(replay(*a, **kw)) or replayed[-1])
    tp = t_debug.dump_association_debug(tctx, kps, valid, tmp_path / "port", frames=frames)
    monkeypatch.setattr(j_debug, "replay_states", lambda ctx, kps, valid, app=None: replayed[0])
    jp = j_debug.dump_association_debug(JContext.build(seq.cameras, jcfg, use_ik=True),
                                        kps, valid, tmp_path / "jax", frames=frames)
    return tcfg, jp, tp


@pytest.mark.parametrize("name", list(SCENES))
def test_dump_matches_jax(tmp_path, monkeypatch, name):
    cfg, jp, tp = _dumps(tmp_path, monkeypatch, name)
    T, P = cfg.max_tracks, cfg.max_people
    assert [p.name for p in tp] == [p.name for p in jp] and tp
    if name == "death_frames":
        assert "frame_00008.npz" in [p.name for p in tp]
    assert (sorted(p.name for p in (tmp_path / "port").iterdir())
            == sorted(p.name for p in (tmp_path / "jax").iterdir()))
    for a, b in zip(tp, jp):
        with np.load(a) as t, np.load(b) as j:
            assert sorted(t.files) == sorted(j.files)
            for k in ("elem_valid", "rep", "member", "group_size"):
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
            ev = t["elem_valid"]
            solved = ev[:, None] & ev[None, :]
            np.testing.assert_array_equal(t["x_bin"][solved], j["x_bin"][solved])
            fin = np.isfinite(j["d23"])
            np.testing.assert_array_equal(np.isfinite(t["d23"]), fin)
            np.testing.assert_allclose(t["d23"][fin], j["d23"][fin], atol=D23_TOL)
            if "x" in j.files:
                assert np.abs(t["x"] - j["x"])[solved].max() <= X_TOL
                np.testing.assert_array_equal(t["margin"], np.abs(t["x"] - 0.5))
            for c in range(cfg.assoc_clusters):
                np.testing.assert_array_equal(t[f"cluster{c}_views"], j[f"cluster{c}_views"])
                np.testing.assert_allclose(t[f"cluster{c}_sim"], j[f"cluster{c}_sim"],
                                           atol=SIM_TOL)
                # the cluster's solved elements: live tracks and its views' detections
                views = t[f"cluster{c}_views"]
                vm = np.concatenate([ev[:T]] + [ev[T + v * P:T + (v + 1) * P] for v in views])
                cs = vm[:, None] & vm[None, :]
                assert np.abs(t[f"cluster{c}_x"] - j[f"cluster{c}_x"])[cs].max() <= X_TOL
        base = a.with_suffix("")
        jbase = b.with_suffix("")
        for csv in sorted(a.parent.glob(base.name + "_*.csv")):
            jcsv = jbase.parent / csv.name
            assert csv.read_text().splitlines()[0] == jcsv.read_text().splitlines()[0]
            assert len(csv.read_text().splitlines()) == len(jcsv.read_text().splitlines())
        ts = json.loads((a.parent / f"{base.name}_summary.json").read_text())
        js = json.loads((b.parent / f"{jbase.name}_summary.json").read_text())
        assert ts.keys() == js.keys()
        for k in ("frame", "any_alive", "died_track_ids", "det_groups"):
            assert ts[k] == js[k], k
        assert len(ts["tracks"]) == len(js["tracks"])
        for x, y in zip(ts["tracks"], js["tracks"]):
            assert x.keys() == y.keys()
            for k in ("slot", "track_id", "active", "time_since_update", "is_group_leader",
                      "group_size"):
                assert x[k] == y[k], k
            if y["nearest_det_px"] is not None:
                assert abs(x["nearest_det_px"] - y["nearest_det_px"]) <= D23_TOL
            if "best_soft_x" in y and y["best_soft_x"] is not None:
                assert abs(x["best_soft_x"] - y["best_soft_x"]) <= X_TOL
                assert abs(x["margin_to_05"] - y["margin_to_05"]) <= X_TOL


def test_replay_states_equal_run_offline():
    """The replay's outputs are `run_offline`'s, bit for bit, and each
    recorded pre-step state is the state the previous step returned."""
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_seq
    from multiview_motion_capture_torch.tracker import TrackerState, run_offline

    cfg = TConfig(n_views=4, max_people=4, max_tracks=6, als_max_iter=100)
    seq = t_seq(n_frames=6, n_people=2, n_views=4, cfg=cfg, seed=3, drop_prob=0.15)
    ctx = TContext.build(seq.cameras, cfg, device="cpu")
    pre, outs = t_debug.replay_states(ctx, seq.batch.kps, seq.batch.valid)
    state, ref = run_offline(ctx, seq.batch.kps, seq.batch.valid)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(outs, f), getattr(ref, f).numpy(), err_msg=f)
    assert not pre.active[0].any()                      # zeros before frame 0
    s4, _ = run_offline(ctx, seq.batch.kps[:4], seq.batch.valid[:4])
    for fld in ("active", "track_id", "root", "euler", "pose3d"):
        np.testing.assert_array_equal(getattr(pre, fld)[4], getattr(s4, fld).numpy())
    assert isinstance(t_debug._state_at(pre, 4, "cpu"), TrackerState)
