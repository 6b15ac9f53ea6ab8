"""The port's tracker, pipeline and evaluation against the JAX package on the
CPU: the whole slice (filter -> per-frame step -> tracklets) on a small
synthetic scene under SHELF_BENCH's capacities, one step from a carried
mid-sequence state, the tracklet pickle schema both ways, triangulation
mode (`use_ik=False`: all views with the motion gate on, `motion_gain`,
and `ik_max_views` per-track views) and the gate's velocity state.

Decisions (track ids, lifecycle states, updated/spawned flags, matched
detections, deaths) must be equal.  Poses may differ by f32 rounding carried
through the LM solves: 1e-3 m (the scene's detection noise is 1 px, about
4 mm at this rig's scale); triangulated poses (no LM) and the velocity EMA
by 1e-5 m.  The similarity matrices agree to 1e-5.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch import eval as t_eval
from multiview_motion_capture_torch import pipeline as t_pipeline
from multiview_motion_capture_torch import tracker as TT
from multiview_motion_capture_torch.config import SHELF_BENCH as T_CFG
from multiview_motion_capture_torch.data.ingest import filter_bad_poses as t_filter
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth
from multiview_motion_capture_tpu import eval as j_eval
from multiview_motion_capture_tpu import pipeline as j_pipeline
from multiview_motion_capture_tpu import tracker as JT
from multiview_motion_capture_tpu.config import SHELF_BENCH as J_CFG
from multiview_motion_capture_tpu.data.ingest import filter_bad_poses as j_filter
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth
from tests.torch_study_scene import one_thread

DECISIONS = ("track_id", "active", "updated", "spawned", "died_track_id", "matched_pose")
POSE_TOL_M = 1e-3
TRI_TOL_M = 1e-5
SIM_TOL = 1e-5
N_FRAMES = 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _state_arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in TT.TrackerState.__dataclass_fields__}


@pytest.fixture(scope="module")
def runs():
    """Both packages over synthetic_sequence(8 frames, 3 people, 4 views,
    seed 1), built once for the module (the JAX side compiles its scan)."""
    jc = dataclasses.replace(J_CFG, n_views=4, max_frames=None)
    tc = dataclasses.replace(T_CFG, n_views=4, max_frames=None)
    kw = dict(n_frames=N_FRAMES, n_people=3, n_views=4, seed=1)
    js, ts = j_synth(cfg=jc, **kw), t_synth(cfg=tc, **kw)
    jb, tb = j_filter(js.batch, jc), t_filter(ts.batch, tc)
    jctx = JT.TrackerContext.build(js.cameras, jc)
    jstate, jo = JT.run_offline(jctx, jnp.asarray(jb.kps), jnp.asarray(jb.valid))
    jo = jax.device_get(jo)
    tctx = TT.TrackerContext.build(ts.cameras, tc, device="cpu")
    tstate, to = TT.run_offline(tctx, tb.kps, tb.valid)
    return dict(js=js, ts=ts, jb=jb, tb=tb, jc=jc, tc=tc, jctx=jctx, tctx=tctx,
                jstate=jstate, jo=jo, tstate=tstate, to=TT.outputs_to_numpy(to))


@pytest.mark.parametrize("field", DECISIONS)
def test_slice_decisions_equal(runs, field):
    a, b = np.asarray(getattr(runs["jo"], field)), getattr(runs["to"], field)
    assert a.shape == b.shape
    bad = np.nonzero((a != b).reshape(N_FRAMES, -1).any(1))[0]
    assert len(bad) == 0, f"{field} differs from frame {bad[:5]}"


def test_slice_exercises_the_path(runs):
    """The scene spawns, updates and confirms tracks, so the comparison
    covers the cold and the warm solves and the lifecycle."""
    to = runs["to"]
    assert to.spawned.any() and (to.updated & ~to.spawned).any()
    assert (to.active == TT.CONFIRMED).any()
    assert to.als_iters.shape == (N_FRAMES,) and (to.als_iters > 0).all()


@pytest.mark.parametrize("field", ["pose3d", "root", "side_lens"])
def test_slice_poses_within_tolerance(runs, field):
    upd = np.asarray(runs["jo"].updated)
    a = np.asarray(getattr(runs["jo"], field))[upd]
    b = getattr(runs["to"], field)[upd]
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=POSE_TOL_M)


def test_final_state_matches(runs):
    j, t = _state_arrays(runs["jstate"]), _state_arrays(runs["tstate"])
    for f in ("active", "track_id", "hits", "time_since_update", "next_track_id"):
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)
    np.testing.assert_allclose(t["pose3d"], j["pose3d"], atol=POSE_TOL_M)


def test_tracklets_equal(runs):
    jt = JT.assemble_tracklets(runs["jo"])
    tt = TT.assemble_tracklets(runs["to"])
    assert [(x.track_id, list(x.frame_idxs)) for x in tt] == \
           [(x.track_id, list(x.frame_idxs)) for x in jt]
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b.matched_pose, a.matched_pose)
        np.testing.assert_allclose(b.poses_3d, a.poses_3d, atol=POSE_TOL_M)
    jm = j_eval.reprojection_metrics(jt, runs["js"].batch, runs["js"].cameras)
    tm = t_eval.reprojection_metrics(tt, runs["ts"].batch, runs["ts"].cameras)
    assert (tm.n_tracklets, tm.lengths, tm.n_degenerate_poses) == \
           (jm.n_tracklets, jm.lengths, jm.n_degenerate_poses)
    assert abs(tm.mean_reproj_px - jm.mean_reproj_px) < 0.01


def test_context_constants_match(runs):
    jctx, tctx = runs["jctx"], runs["tctx"]
    for f in ("F_spatial", "F_det", "diag_mask", "init_A"):
        np.testing.assert_array_equal(getattr(tctx, f).numpy(), np.asarray(getattr(jctx, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tctx.K_inv.numpy(), np.asarray(jctx.K_inv), rtol=1e-6)
    carried = TT.context_constants_from_numpy(
        runs["tc"], runs["ts"].cameras,
        {f: np.asarray(getattr(jctx, f)) for f in ("F_spatial", "F_det", "K_inv",
                                                    "diag_mask", "init_A")}
        | {"bone_dirs": np.asarray(jctx.skel.bone_dirs),
           "side_bone_lens": np.asarray(jctx.skel.side_bone_lens)},
        device="cpu")
    np.testing.assert_array_equal(carried.K_inv.numpy(), np.asarray(jctx.K_inv))
    np.testing.assert_array_equal(carried.skel.bone_dirs.numpy(),
                                  np.asarray(jctx.skel.bone_dirs))


def test_similarity_builders_match(runs):
    """Both similarity matrices from the same mid-sequence state."""
    f = N_FRAMES - 1
    jstate = runs["jstate"]
    tstate = TT.from_numpy_state(_state_arrays(jstate), device="cpu")
    jk, jv = jnp.asarray(runs["jb"].kps[f]), jnp.asarray(runs["jb"].valid[f])
    tk, tv = torch.as_tensor(runs["tb"].kps[f]), torch.as_tensor(runs["tb"].valid[f])
    sj, evj, dj = JT._spatial_time_similarity(runs["jctx"], jstate, jk, jv)
    st, evt, dt = TT._spatial_time_similarity(runs["tctx"], tstate, tk, tv)
    np.testing.assert_array_equal(evt.numpy(), np.asarray(evj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SIM_TOL)
    assert (np.asarray(sj) > 0).sum() > 0
    sj, evj = JT._spatial_similarity(runs["jctx"], jk, jv)
    st, evt = TT._spatial_similarity(runs["tctx"], tk, tv)
    np.testing.assert_array_equal(evt.numpy(), np.asarray(evj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SIM_TOL)


def test_carried_state_step(runs):
    """One step of each package from the same mid-sequence state (the JAX
    state and context constants carried across as numpy)."""
    jctx = runs["jctx"]
    consts = {f: np.asarray(getattr(jctx, f))
              for f in ("F_spatial", "F_det", "K_inv", "diag_mask", "init_A")}
    tctx = TT.context_constants_from_numpy(runs["tc"], runs["ts"].cameras, consts,
                                           device="cpu")
    f = 3    # step frame 3's detections from the state after all 8 frames
    state = TT.from_numpy_state(_state_arrays(runs["jstate"]), device="cpu")
    assert state.track_id.dtype == torch.int32 and state.pose3d.dtype == torch.float32
    _, to = TT.make_step(tctx)(state, torch.as_tensor(runs["tb"].kps[f]),
                               torch.as_tensor(runs["tb"].valid[f]))
    _, jo = jax.jit(JT.make_step(jctx))(
        runs["jstate"], (jnp.asarray(runs["jb"].kps[f]), jnp.asarray(runs["jb"].valid[f])))
    for k in DECISIONS:
        np.testing.assert_array_equal(getattr(to, k).numpy(), np.asarray(getattr(jo, k)),
                                      err_msg=k)
    upd = np.asarray(jo.updated)
    assert upd.any()
    np.testing.assert_allclose(to.pose3d.numpy()[upd], np.asarray(jo.pose3d)[upd],
                               atol=POSE_TOL_M)


def test_pipeline_run_on_cpu(runs):
    res = t_pipeline.run(runs["ts"].batch, runs["ts"].cameras, runs["tc"], device="cpu")
    assert res.n_frames == N_FRAMES and res.track_time_s > 0
    assert set(res.timings) >= {"filter", "build_context", "warmup+track", "track"}
    tt = TT.assemble_tracklets(runs["to"])
    assert [(x.track_id, list(x.frame_idxs)) for x in res.tracklets] == \
           [(x.track_id, list(x.frame_idxs)) for x in tt]


def test_tracklet_pickles_load_in_either_package(runs, tmp_path):
    tt = TT.assemble_tracklets(runs["to"])
    jt = JT.assemble_tracklets(runs["jo"])
    t_pipeline.save_tracklets(tmp_path / "port.pkl", tt)
    j_pipeline.save_tracklets(tmp_path / "jax.pkl", jt)
    with open(tmp_path / "port.pkl", "rb") as f:
        port_payload = pickle.load(f)
    with open(tmp_path / "jax.pkl", "rb") as f:
        jax_payload = pickle.load(f)
    assert [sorted(d) for d in port_payload["tracklets"]] == \
           [sorted(d) for d in jax_payload["tracklets"]]
    back = j_pipeline.load_tracklets(tmp_path / "port.pkl")
    assert [b.track_id for b in back] == [x.track_id for x in tt]
    np.testing.assert_array_equal(back[0].poses_3d, tt[0].poses_3d)
    back = t_pipeline.load_tracklets(tmp_path / "jax.pkl")
    assert [b.frame_idxs for b in back] == [list(x.frame_idxs) for x in jt]
    kept = t_pipeline.filter_ghost_tracklets(back, min_length=3)
    assert kept == [b for b in back if len(b) >= 3]


@pytest.mark.parametrize("preset", ["SHELF", "SHELF_BENCH", "parity", "fast", "wide", "crowded"])
def test_config_copy_matches_jax(preset):
    """The port's config is a field-for-field copy: a preset means the same
    run in either package."""
    from multiview_motion_capture_torch import config as tcfg
    from multiview_motion_capture_tpu import config as jcfg

    def build(mod):
        if preset.isupper():
            return getattr(mod, preset)
        factory = getattr(mod.PipelineConfig, preset)
        return factory(16) if preset == "wide" else factory()

    assert dataclasses.asdict(build(tcfg)) == dataclasses.asdict(build(jcfg))


# triangulation-mode cases: (ik_max_views, motion_gain)
TRI_CASES = {"all_views_motion": (None, 1.0), "top2_views": (2, 0.0)}


@pytest.fixture(scope="module")
def tri_refs():
    """Both packages in triangulation mode over the module's scene, once per
    case: updates triangulate all their views with the motion gate on
    (`motion_gain=1.0`: the constant-velocity gate and the root-velocity
    EMA), or (`ik_max_views=2`) each track's two best views with per-track
    cameras."""
    refs = {}
    for case, (max_views, gain) in TRI_CASES.items():
        over = dict(n_views=4, max_frames=None, ik_max_views=max_views, motion_gain=gain)
        jc, tc = dataclasses.replace(J_CFG, **over), dataclasses.replace(T_CFG, **over)
        kw = dict(n_frames=N_FRAMES, n_people=3, n_views=4, seed=1)
        js, ts = j_synth(cfg=jc, **kw), t_synth(cfg=tc, **kw)
        jb, tb = j_filter(js.batch, jc), t_filter(ts.batch, tc)
        jctx = JT.TrackerContext.build(js.cameras, jc, use_ik=False)
        jstate, jo = JT.run_offline(jctx, jnp.asarray(jb.kps), jnp.asarray(jb.valid))
        tctx = TT.TrackerContext.build(ts.cameras, tc, use_ik=False, device="cpu")
        tstate, to = TT.run_offline(tctx, tb.kps, tb.valid)
        refs[case] = dict(jo=jax.device_get(jo), to=TT.outputs_to_numpy(to), tctx=tctx,
                          jstate=jax.device_get(jstate), tstate=tstate)
    return refs


@pytest.fixture(params=list(TRI_CASES))
def tri_runs(request, tri_refs):
    return tri_refs[request.param]


@pytest.mark.parametrize("field", DECISIONS)
def test_triangulation_mode_decisions_equal(tri_runs, field):
    a, b = np.asarray(getattr(tri_runs["jo"], field)), getattr(tri_runs["to"], field)
    bad = np.nonzero((a != b).reshape(N_FRAMES, -1).any(1))[0]
    assert len(bad) == 0, f"{field} differs from frame {bad[:5]}"


def test_triangulation_mode_poses(tri_runs):
    """Triangulated COCO+spine poses, their scores and the hip-midpoint
    root; angles and side lengths stay at zero (no IK)."""
    jo, to = tri_runs["jo"], tri_runs["to"]
    upd = np.asarray(jo.updated)
    assert not tri_runs["tctx"].use_ik
    assert to.spawned.any() and (to.updated & ~to.spawned).any()
    for f in ("pose3d", "pose3d_score", "root"):
        np.testing.assert_allclose(getattr(to, f)[upd], np.asarray(getattr(jo, f))[upd],
                                   atol=TRI_TOL_M, err_msg=f)
    np.testing.assert_allclose(to.root[upd], 0.5 * (to.pose3d[upd][:, 11] + to.pose3d[upd][:, 12]),
                               atol=1e-6)
    assert not to.euler.any() and not to.side_lens.any()


def test_motion_gain_velocity_state(tri_refs):
    """cfg.motion_gain: the EMA root velocity after the module's
    triangulation-mode run with the gate on equals JAX's within 1e-5 m
    (its decisions are held by the triangulation tests).  On the scene of
    the JAX package's tests/test_tracker.py::test_motion_gain_velocity_state
    (one person walking at constant speed, the EMA at beta 1) the velocity
    is the true per-frame hip displacement within 1 cm, and it stays zero
    when the gate is off."""
    from multiview_motion_capture_torch.config import PipelineConfig as TConfig

    ref = tri_refs["all_views_motion"]
    tvel, jvel = ref["tstate"].root_vel.numpy(), np.asarray(ref["jstate"].root_vel)
    np.testing.assert_allclose(tvel, jvel, atol=TRI_TOL_M)
    assert np.abs(tvel[ref["tstate"].active.numpy() > 0]).max() > 1e-3

    over = dict(n_views=4, max_people=3, max_tracks=4, max_frames=None, als_max_iter=100)
    kw = dict(n_frames=10, n_people=1, n_views=4, seed=5, drop_prob=0.0, noise_px=0.1)
    tc = TConfig(**over, motion_gain=1.0, motion_vel_beta=1.0)
    ts = t_synth(cfg=tc, **kw)
    tstate, _ = TT.run_offline(TT.TrackerContext.build(ts.cameras, tc, use_ik=False,
                                                       device="cpu"),
                               ts.batch.kps, ts.batch.valid)
    slot = int(np.argmax(tstate.active.numpy()))
    assert tstate.active[slot] > 0
    gt_vel = ts.gt_3d[-1, 0] - ts.gt_3d[-2, 0]
    gt_hip = 0.5 * (gt_vel[11] + gt_vel[12])
    assert np.linalg.norm(tstate.root_vel.numpy()[slot] - gt_hip) < 0.01

    state0, _ = TT.run_offline(
        TT.TrackerContext.build(ts.cameras, TConfig(**over), use_ik=False, device="cpu"),
        ts.batch.kps, ts.batch.valid)
    assert not state0.root_vel.any()


def test_motion_gate_distances_match(runs):
    """The gate's constant-velocity shift: d23 of a carried state with a
    nonzero root velocity, both packages."""
    from multiview_motion_capture_torch.config import PipelineConfig as TConfig

    f = N_FRAMES - 1
    arrays = _state_arrays(runs["jstate"])
    arrays["root_vel"] = np.tile(np.float32([[0.05, -0.03, 0.0]]), (T_CFG.max_tracks, 1))
    arrays["time_since_update"] = np.full(T_CFG.max_tracks, 2, np.int32)
    tc = dataclasses.replace(runs["tc"], motion_gain=1.0)
    jc = dataclasses.replace(runs["jc"], motion_gain=1.0)
    assert isinstance(tc, TConfig)
    tctx = dataclasses.replace(runs["tctx"], cfg=tc)
    jctx = dataclasses.replace(runs["jctx"], cfg=jc)
    jstate = runs["jstate"].replace(**{k: jnp.asarray(arrays[k])
                                       for k in ("root_vel", "time_since_update")})
    dt = TT._track_det_distances(tctx, TT.from_numpy_state(arrays, device="cpu"),
                                 torch.as_tensor(runs["tb"].kps[f]),
                                 torch.as_tensor(runs["tb"].valid[f]))
    dj = JT._track_det_distances(jctx, jstate, jnp.asarray(runs["jb"].kps[f]),
                                 jnp.asarray(runs["jb"].valid[f]))
    d0 = TT._track_det_distances(runs["tctx"], TT.from_numpy_state(arrays, device="cpu"),
                                 torch.as_tensor(runs["tb"].kps[f]),
                                 torch.as_tensor(runs["tb"].valid[f]))
    finite = np.isfinite(np.asarray(dj))
    assert finite.any()
    np.testing.assert_array_equal(np.isfinite(dt.numpy()), finite)
    np.testing.assert_allclose(dt.numpy()[finite], np.asarray(dj)[finite], rtol=1e-5, atol=1e-3)
    assert not np.allclose(dt.numpy()[finite], d0.numpy()[finite])


def test_run_offline_takes_the_jax_signature(runs):
    """`run_offline(ctx, kps, valid, frame_idxs=None, app=None, *, state=None)`:
    the JAX package's positional parameters (its `frame_idxs` accepted and
    ignored), so a call written for JAX, `run_offline(ctx, kps, valid,
    frame_idxs, app)`, gives the keyword call's outputs bit for bit; the
    carried `state` is keyword-only."""
    import inspect

    params = inspect.signature(TT.run_offline).parameters
    jparams = inspect.signature(JT.run_offline).parameters
    assert list(params)[:5] == list(jparams) == ["ctx", "kps", "valid", "frame_idxs", "app"]
    assert params["state"].kind is inspect.Parameter.KEYWORD_ONLY
    tb, ctx = runs["tb"], runs["tctx"]
    state, out = TT.run_offline(ctx, tb.kps, tb.valid, np.arange(N_FRAMES), None)
    for f in TT.FrameOutput._fields:
        np.testing.assert_array_equal(getattr(TT.outputs_to_numpy(out), f),
                                      getattr(runs["to"], f), err_msg=f)
    for f, a in _state_arrays(state).items():
        np.testing.assert_array_equal(a, _state_arrays(runs["tstate"])[f], err_msg=f)
    # the keyword-only state carries a run on: 3 frames, then the rest
    s3, _ = TT.run_offline(ctx, tb.kps[:3], tb.valid[:3])
    _, rest = TT.run_offline(ctx, tb.kps[3:], tb.valid[3:], state=s3)
    for f in TT.FrameOutput._fields:
        np.testing.assert_array_equal(getattr(TT.outputs_to_numpy(rest), f),
                                      getattr(runs["to"], f)[3:], err_msg=f)
    with pytest.raises(TypeError):
        TT.run_offline(ctx, tb.kps, tb.valid, None, None, s3)
