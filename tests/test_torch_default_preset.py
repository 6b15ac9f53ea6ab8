"""The JAX package's default preset (`PipelineConfig()`: the per-slot
Cholesky LM with staged cold and warm solves, ALS capped at 1,000 iterations
with a 15-iteration stable stop, track rescue on) and the streaming
`MvTracker`, against the JAX package on the CPU.

Scene: synthetic_sequence(6 frames, 3 people, 4 views, seed 1) at narrow
capacities (4 detections per view, 6 track slots); every other field is the
default's.  The plain ALS would run up to 1,000 iterations a frame on the
CPU; on this scene it settles within ~140, so the scene stays fast without
lowering the cap.  Both packages' references are built once per module.

Decisions (track ids, lifecycle states, updated/spawned flags, matched
detections, deaths) must be equal.  Poses within POSE_TOL_M = 1e-3 m: the
LM's accept/reject steps carry the rounding of normal equations factored in
f64 (the port) and f32 (JAX).  `MvTracker.update` and `update_batch` equal
the port's `run_offline` bit for bit: the same step on the same inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch import MvTracker
from multiview_motion_capture_torch import pipeline as t_pipeline
from multiview_motion_capture_torch import tracker as TT
from multiview_motion_capture_torch.config import PipelineConfig as TConfig
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth
from multiview_motion_capture_tpu import tracker as JT
from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth
from tests.torch_study_scene import one_thread

DECISIONS = ("track_id", "active", "updated", "spawned", "died_track_id", "matched_pose")
POSE_TOL_M = 1e-3
N_FRAMES = 6
NARROW = dict(n_views=4, max_people=4, max_tracks=6, max_frames=None)
SCENE = dict(n_frames=N_FRAMES, n_people=3, n_views=4, seed=1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _stack(outs):
    return TT.FrameOutput(*[np.stack([np.asarray(getattr(o, f)) for o in outs])
                            for f in TT.FrameOutput._fields])


@pytest.fixture(scope="module")
def runs():
    jc, tc = JConfig(**NARROW), TConfig(**NARROW)
    js, ts = j_synth(cfg=jc, **SCENE), t_synth(cfg=tc, **SCENE)
    jctx = JT.TrackerContext.build(js.cameras, jc)
    jstate, jo = JT.run_offline(jctx, jnp.asarray(js.batch.kps), jnp.asarray(js.batch.valid))
    tctx = TT.TrackerContext.build(ts.cameras, tc, device="cpu")
    tstate, to = TT.run_offline(tctx, ts.batch.kps, ts.batch.valid)
    return dict(js=js, ts=ts, jc=jc, tc=tc, jstate=jax.device_get(jstate),
                jo=jax.device_get(jo), tstate=tstate, to=TT.outputs_to_numpy(to))


def test_the_default_preset_is_what_runs(runs):
    """The fields this module is about are the default's, and the scene
    spawns, updates and confirms tracks: the staged cold and warm solves
    both run."""
    tc = runs["tc"]
    assert (tc.ik_solver, tc.ik_cold_stages, tc.ik_warm_stages) == ("chol", 2, 2)
    assert (tc.als_max_iter, tc.als_stable_iters) == (1000, 15)
    assert dataclasses.replace(TConfig(), **NARROW) == tc
    to = runs["to"]
    assert to.spawned.any() and (to.updated & ~to.spawned).any()
    assert (to.active == TT.CONFIRMED).any()
    assert (to.als_iters < tc.als_max_iter).all()


@pytest.mark.parametrize("field", DECISIONS)
def test_default_preset_decisions_equal(runs, field):
    a, b = np.asarray(getattr(runs["jo"], field)), getattr(runs["to"], field)
    assert a.shape == b.shape
    bad = np.nonzero((a != b).reshape(N_FRAMES, -1).any(1))[0]
    assert len(bad) == 0, f"{field} differs from frame {bad[:5]}"


@pytest.mark.parametrize("field", ["pose3d", "root", "side_lens"])
def test_default_preset_poses_within_tolerance(runs, field):
    upd = np.asarray(runs["jo"].updated)
    a = np.asarray(getattr(runs["jo"], field))[upd]
    b = getattr(runs["to"], field)[upd]
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=POSE_TOL_M)


def test_default_preset_final_state(runs):
    j, t = runs["jstate"], runs["tstate"]
    for f in ("active", "track_id", "hits", "time_since_update", "next_track_id"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    np.testing.assert_allclose(t.pose3d.numpy(), np.asarray(j.pose3d), atol=POSE_TOL_M)


@pytest.mark.parametrize("preset", ["default", "parity", "crowded"])
def test_chol_presets_build_and_step(runs, preset):
    """Every preset that inherits `ik_solver="chol"` builds and steps: one
    frame, whose spawns run the staged cold Cholesky solve."""
    cfg = TConfig(**NARROW) if preset == "default" else getattr(TConfig, preset)(**NARROW)
    assert cfg.ik_solver == "chol"
    ctx = TT.TrackerContext.build(runs["ts"].cameras, cfg, device="cpu")
    _, o = TT.run_offline(ctx, runs["ts"].batch.kps[:1], runs["ts"].batch.valid[:1])
    assert o.spawned[0].any() and torch.isfinite(o.pose3d).all()


@pytest.fixture(scope="module")
def streams(runs):
    """The scene replayed once each way: the port's `MvTracker` by one
    `update` per frame and by `update_batch` in chunks of 4 with `pad_to=4`
    (the tail chunk of 2 is short), and the JAX package's `MvTracker` by
    `update_batch` the same way."""
    ts, js = runs["ts"], runs["js"]
    one = MvTracker(ts.cameras, runs["tc"], device="cpu")
    for f in range(N_FRAMES):
        one.update(f, ts.batch.kps[f], ts.batch.valid[f])
    chunked = MvTracker(ts.cameras, runs["tc"], device="cpu")
    jtrk = JT.MvTracker(js.cameras, runs["jc"])
    for s in range(0, N_FRAMES, 4):
        e = min(s + 4, N_FRAMES)
        idx = list(range(s, e))
        chunked.update_batch(idx, ts.batch.kps[s:e], ts.batch.valid[s:e], pad_to=4)
        jtrk.update_batch(idx, js.batch.kps[s:e], js.batch.valid[s:e], pad_to=4)
    return {"update": one, "update_batch": chunked, "jax": jtrk}


@pytest.mark.parametrize("mode", ["update", "update_batch"])
def test_stream_equals_run_offline_and_jax_mvtracker(runs, streams, mode):
    """Either streaming mode gives `run_offline`'s outputs, every field bit
    for bit, its final state and its tracklets; and the JAX package's
    `MvTracker` makes the same decisions and tracklets."""
    trk, jtrk = streams[mode], streams["jax"]
    got, want = _stack(trk.outputs), runs["to"]
    assert len(trk.outputs) == N_FRAMES and trk.frame_idxs == list(range(N_FRAMES))
    for f in TT.FrameOutput._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert [(x.track_id, x.frame_idxs) for x in trk.tracklets()] == \
           [(x.track_id, x.frame_idxs) for x in TT.assemble_tracklets(want)]
    for f in ("active", "track_id", "hits", "next_track_id"):
        assert torch.equal(getattr(trk.state, f), getattr(runs["tstate"], f)), f
    jgot = _stack(jtrk.outputs)
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(got, f), getattr(jgot, f), err_msg=f)
    assert [(x.track_id, x.frame_idxs) for x in trk.tracklets()] == \
           [(x.track_id, x.frame_idxs) for x in jtrk.tracklets()]


def test_update_batch_rejects_an_oversized_chunk(runs):
    ts = runs["ts"]
    trk = MvTracker(ts.cameras, runs["tc"], device="cpu")
    with pytest.raises(ValueError, match="exceeds pad_to=2"):
        trk.update_batch([0, 1, 2], ts.batch.kps[:3], ts.batch.valid[:3], pad_to=2)
    with pytest.raises(ValueError, match="frame indices"):
        trk.update_batch([0, 1], ts.batch.kps[:3], ts.batch.valid[:3])
    assert trk.outputs == [] and int(trk.state.next_track_id) == 0


def test_pipeline_run_default_preset_on_cpu(runs):
    ts = runs["ts"]
    res = t_pipeline.run(ts.batch, ts.cameras, runs["tc"], device="cpu")
    assert res.n_frames == N_FRAMES
    assert [(x.track_id, x.frame_idxs) for x in res.tracklets] == \
           [(x.track_id, x.frame_idxs) for x in TT.assemble_tracklets(runs["to"])]
