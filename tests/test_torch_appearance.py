"""Appearance evidence in the port's tracker (`cfg.appearance_dim > 0`)
against the JAX package on the CPU: the synthetic embeddings, the gain and
penalties, the similarity terms, the EMA with its freeze radius, the
auto-gain statistics and a whole run; plus the all-zero-embedding contract
and the inputs that must be given.

Scene: synthetic_sequence(8 frames, 3 people, 4 views, seed 3, drop 0.1) at
narrow capacities (4 detections per view, 6 track slots, ALS cap 100) with
`synthetic_appearance(dim=8, noise=0.05, shared_frac=0.83)`, the identity
study's extractor-grade embeddings, the auto gain (target 8 px) and a 1.5 m
freeze radius; track rescue stays on, so its appearance term runs too.  The
JAX reference is built once per module.

Decisions must be equal; poses within 1e-3 m (the LM's rounding, as in
tests/test_torch_tracker.py); the embeddings' EMA, the per-frame
observations and the auto-gain statistics within 1e-5 (unit vectors and
cosines formed in f64 in the port, f32 in JAX); similarities within 1e-5.
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
from multiview_motion_capture_torch.data.synthetic import synthetic_appearance as t_app
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth
from multiview_motion_capture_tpu import tracker as JT
from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
from multiview_motion_capture_tpu.data.synthetic import synthetic_appearance as j_app
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth
from tests.torch_study_scene import one_thread

DECISIONS = ("track_id", "active", "updated", "spawned", "died_track_id", "matched_pose")
POSE_TOL_M = 1e-3
APP_TOL = 1e-5
SIM_TOL = 1e-5
N_FRAMES = 8
D = 8
CFG = dict(n_views=4, max_people=4, max_tracks=6, max_frames=None, als_max_iter=100,
           appearance_dim=D, appearance_auto_target_px=8.0, appearance_freeze_radius_m=1.5)
SCENE = dict(n_frames=N_FRAMES, n_people=3, n_views=4, seed=3, drop_prob=0.1)
EMBED = dict(dim=D, noise=0.05, shared_frac=0.83)


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
    jc, tc = JConfig(**CFG), TConfig(**CFG)
    js, ts = j_synth(cfg=jc, **SCENE), t_synth(cfg=tc, **SCENE)
    japp, tapp = j_app(js, **EMBED), t_app(ts, **EMBED)
    jctx = JT.TrackerContext.build(js.cameras, jc)
    jstate, jo = JT.run_offline(jctx, jnp.asarray(js.batch.kps), jnp.asarray(js.batch.valid),
                                app=jnp.asarray(japp))
    tctx = TT.TrackerContext.build(ts.cameras, tc, device="cpu")
    tstate, to = TT.run_offline(tctx, ts.batch.kps, ts.batch.valid, app=tapp)
    return dict(js=js, ts=ts, jc=jc, tc=tc, japp=japp, tapp=tapp, jctx=jctx, tctx=tctx,
                jstate=jax.device_get(jstate), jo=jax.device_get(jo), tstate=tstate,
                to=TT.outputs_to_numpy(to))


@pytest.mark.parametrize("shared_frac", [0.0, 0.83])
def test_synthetic_appearance_bit_identical(shared_frac):
    kw = dict(n_frames=3, n_people=3, n_views=4, seed=2, drop_prob=0.2)
    js = j_synth(cfg=JConfig(n_views=4, max_people=4), **kw)
    ts = t_synth(cfg=TConfig(n_views=4, max_people=4), **kw)
    a = j_app(js, dim=16, noise=0.05, shared_frac=shared_frac, seed=4)
    b = t_app(ts, dim=16, noise=0.05, shared_frac=shared_frac, seed=4)
    assert b.dtype == np.float32 and b.shape == (3, 4, 4, 16)
    np.testing.assert_array_equal(b, a)
    assert (np.linalg.norm(b, axis=-1) == 0).any()      # empty slots stay zero


@pytest.mark.parametrize("field", DECISIONS)
def test_appearance_decisions_equal(runs, field):
    a, b = np.asarray(getattr(runs["jo"], field)), getattr(runs["to"], field)
    bad = np.nonzero((a != b).reshape(N_FRAMES, -1).any(1))[0]
    assert len(bad) == 0, f"{field} differs from frame {bad[:5]}"


def test_appearance_poses_and_observations(runs):
    jo, to = runs["jo"], runs["to"]
    upd = np.asarray(jo.updated)
    assert upd.any() and to.spawned.any()
    np.testing.assert_allclose(to.pose3d[upd], np.asarray(jo.pose3d)[upd], atol=POSE_TOL_M)
    assert to.app_obs.shape == (N_FRAMES, CFG["max_tracks"], D)
    np.testing.assert_allclose(to.app_obs, np.asarray(jo.app_obs), atol=APP_TOL)
    # touched slots carry a unit observation, the others zero
    norms = np.linalg.norm(to.app_obs, axis=-1)
    np.testing.assert_allclose(norms[to.updated], 1.0, atol=1e-6)
    assert (norms[~to.updated] == 0).all()


def test_appearance_state_matches(runs):
    """The EMA embeddings and the auto-gain statistics after the run; the
    statistics have collected (weight > 0.5: the auto gain is in force)."""
    j, t = runs["jstate"], runs["tstate"]
    np.testing.assert_allclose(t.app_ema.numpy(), np.asarray(j.app_ema), atol=APP_TOL)
    np.testing.assert_allclose(t.app_stats.numpy(), np.asarray(j.app_stats), atol=APP_TOL)
    stats = t.app_stats.numpy()
    assert stats[2] > 0.5 and stats[0] > stats[1]
    live = t.active.numpy() > 0
    np.testing.assert_allclose(np.linalg.norm(t.app_ema.numpy()[live], axis=-1), 1.0,
                               atol=1e-6)


def test_freeze_radius_engages(runs):
    """Without the freeze radius the same scene ends with other EMA
    embeddings: the radius held some track's signature on this scene."""
    cfg = dataclasses.replace(runs["tc"], appearance_freeze_radius_m=0.0)
    ctx = TT.TrackerContext.build(runs["ts"].cameras, cfg, device="cpu")
    state, _ = TT.run_offline(ctx, runs["ts"].batch.kps, runs["ts"].batch.valid,
                              app=runs["tapp"])
    assert not torch.equal(state.app_ema, runs["tstate"].app_ema)


@pytest.mark.parametrize("stats", [
    [0.0, 0.0, 0.0, 0.0],          # no statistics yet: the static gain
    [0.95, 0.83, 0.4, 1e-4],       # weight below 0.5: the static gain
    [0.95, 0.83, 0.8, 1e-6],       # target / gap, under the noise cap
    [0.95, 0.83, 0.8, 4e-3],       # the noise cap wins
    [0.90, 0.895, 0.9, 1e-6],      # gap below the minimum: gain 0
    [0.99, 0.0, 0.9, 0.0],         # a wide gap, the variance floor
])
def test_appearance_gain_matches(runs, stats):
    cfg_t, cfg_j = runs["tc"], runs["jc"]
    st = TT.TrackerState.zeros(cfg_t).replace(app_stats=torch.tensor(stats))
    sj = JT.TrackerState.zeros(cfg_j).replace(app_stats=jnp.asarray(stats, jnp.float32))
    np.testing.assert_allclose(float(TT._appearance_gain(cfg_t, st)),
                               float(JT._appearance_gain(cfg_j, sj)), rtol=1e-5)
    assert TT._appearance_gain(dataclasses.replace(cfg_t, appearance_auto_target_px=0.0),
                               st) == cfg_t.appearance_gain_px


def test_appearance_penalties_match():
    rng = np.random.RandomState(0)
    ema = rng.randn(5, D).astype(np.float32)
    ema[1] = 0.0                                        # a track without an embedding
    app = rng.randn(3, 4, D).astype(np.float32)
    app[0, 2] = 0.0                                     # a detection without one
    for gain in (20.0, 7.5):
        a = TT._appearance_penalty(gain, torch.as_tensor(ema), torch.as_tensor(app))
        b = JT._appearance_penalty(gain, jnp.asarray(ema), jnp.asarray(app))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
        assert (a[1] == 0).all() and (a[:, 0, 2] == 0).all()
        a = TT._appearance_penalty_d22(gain, torch.as_tensor(app))
        b = JT._appearance_penalty_d22(gain, jnp.asarray(app))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)


def test_similarity_with_appearance_matches(runs):
    """Both similarity matrices with the appearance terms, from the JAX
    run's final state carried across."""
    f = N_FRAMES - 1
    jstate = runs["jstate"]
    tstate = TT.from_numpy_state(_state_arrays(jstate), device="cpu")
    assert tstate.app_ema.shape == (CFG["max_tracks"], D)
    kps, valid, app = (runs["ts"].batch.kps[f], runs["ts"].batch.valid[f],
                       runs["tapp"][f])
    jk, jv, ja = jnp.asarray(kps), jnp.asarray(valid), jnp.asarray(app)
    tk, tv, ta = torch.as_tensor(kps), torch.as_tensor(valid), torch.as_tensor(app)
    jctx = runs["jctx"]
    sj, _, dj = jax.jit(lambda s, k, v, a: JT._spatial_time_similarity(jctx, s, k, v, app=a))(
        jstate, jk, jv, ja)
    st, _, dt = TT._spatial_time_similarity(runs["tctx"], tstate, tk, tv, app=ta)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SIM_TOL)
    np.testing.assert_allclose(np.nan_to_num(dt.numpy(), nan=-1.0),
                               np.nan_to_num(np.asarray(dj), nan=-1.0), rtol=1e-5, atol=1e-3)
    sj, _ = jax.jit(lambda s, k, v, a: JT._spatial_similarity(
        jctx, k, v, app=a, app_gain=JT._appearance_gain(runs["jc"], s)))(jstate, jk, jv, ja)
    st, _ = TT._spatial_similarity(runs["tctx"], tk, tv, app=ta,
                                   app_gain=TT._appearance_gain(runs["tc"], tstate))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SIM_TOL)


# a 2-cluster rig with appearance (the JAX side on its XLA ALS, as the
# JAX package's cluster tests run it)
CLUSTERED = dict(n_views=8, max_people=4, max_tracks=6, max_frames=None, als_max_iter=100,
                 assoc_clusters=2, appearance_dim=D, appearance_auto_target_px=8.0)
CLUSTERED_SCENE = dict(n_frames=9, n_people=3, n_views=8, seed=1)


@pytest.fixture(scope="module")
def clustered():
    """Both packages' contexts for the 2-cluster rig, and the port's state
    after the scene's first 8 frames: by then the auto-gain statistics
    weigh over 0.5 (a JAX run of the scene would compile the clustered
    scan with appearance, ~20 s on the CPU, for a state the comparison
    does not need to be JAX's)."""
    jc, tc = JConfig(**CLUSTERED, als_backend="xla"), TConfig(**CLUSTERED)
    js, ts = j_synth(cfg=jc, **CLUSTERED_SCENE), t_synth(cfg=tc, **CLUSTERED_SCENE)
    tctx = TT.TrackerContext.build(ts.cameras, tc, device="cpu")
    tapp = t_app(ts, **EMBED)
    f = CLUSTERED_SCENE["n_frames"] - 1
    tstate, _ = TT.run_offline(tctx, ts.batch.kps[:f], ts.batch.valid[:f], app=tapp[:f])
    return dict(jc=jc, tc=tc, js=js, japp=j_app(js, **EMBED), tapp=tapp,
                jctx=JT.TrackerContext.build(js.cameras, jc), tctx=tctx,
                state=_state_arrays(tstate))


@pytest.mark.parametrize("alive", [True, False], ids=["spatial_time", "spatial"])
def test_clustered_similarity_with_appearance_matches(clustered, monkeypatch, alive):
    """The clustered association's per-cluster similarities with the
    appearance terms (the JAX package's tracker.py:640-668) and the auto
    gain, from one state carried into both packages (the port's after 8
    frames): the matrices each package hands its ALS at the scene's last
    frame, captured at that call, within SIM_TOL; with `alive=False` the
    same state with every track dead, so the spatial-only matrices are
    solved.  The state's statistics put the auto gain in force, and the
    appearance terms move the matrices."""
    jc, tc, f = clustered["jc"], clustered["tc"], CLUSTERED_SCENE["n_frames"] - 1
    arrays = dict(clustered["state"])
    if not alive:
        arrays["active"] = np.zeros_like(arrays["active"])
    jstate = JT.TrackerState.zeros(jc).replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tstate = TT.from_numpy_state(arrays, device="cpu")
    gain_t, gain_j = TT._appearance_gain(tc, tstate), JT._appearance_gain(jc, jstate)
    assert arrays["app_stats"][2] >= 0.5 and float(gain_t) != tc.appearance_gain_px
    np.testing.assert_allclose(float(gain_t), float(gain_j), rtol=1e-5)

    seen_t, seen_j = [], []
    batched, run_als = TT.als_kernel.match_als_batched, JT._run_als
    monkeypatch.setattr(TT.als_kernel, "match_als_batched",
                        lambda W, *a, **k: seen_t.append(W.clone()) or batched(W, *a, **k))
    monkeypatch.setattr(JT, "_run_als",
                        lambda ctx, W, *a: seen_j.append(W) or run_als(ctx, W, *a))

    def jax_cluster_ws(state, kps, valid, any_alive, app):
        JT._clustered_association(clustered["jctx"], state, kps, valid, any_alive, app=app)
        return seen_j[-tc.assoc_clusters:]

    kps, valid = clustered["js"].batch.kps[f], clustered["js"].batch.valid[f]
    Wj = jax.jit(jax_cluster_ws)(jstate, jnp.asarray(kps), jnp.asarray(valid),
                                 jnp.asarray(alive), jnp.asarray(clustered["japp"][f]))
    tk, tv = torch.as_tensor(kps), torch.as_tensor(valid)
    TT._clustered_association(clustered["tctx"], tstate, tk, tv,
                              torch.as_tensor(clustered["tapp"][f]))
    TT._clustered_association(clustered["tctx"], tstate, tk, tv)
    (W_app, W_geo), C = seen_t, tc.assoc_clusters
    assert W_app.shape[0] == C and len(Wj) == C
    for c in range(C):
        np.testing.assert_allclose(W_app[c].numpy(), np.asarray(Wj[c]), atol=SIM_TOL,
                                   err_msg=str(c))
    assert not torch.allclose(W_app, W_geo, atol=1e-3)


def test_carried_appearance_state_step(runs):
    """One step of each package from the JAX run's state after frame 7,
    with frame 4's detections and embeddings."""
    f = 4
    state = TT.from_numpy_state(_state_arrays(runs["jstate"]), device="cpu")
    new_t, to = TT.make_step(runs["tctx"])(state, torch.as_tensor(runs["ts"].batch.kps[f]),
                                          torch.as_tensor(runs["ts"].batch.valid[f]),
                                          torch.as_tensor(runs["tapp"][f]))
    new_j, jo = jax.jit(JT.make_step(runs["jctx"]))(
        runs["jstate"], (jnp.asarray(runs["js"].batch.kps[f]),
                         jnp.asarray(runs["js"].batch.valid[f]), jnp.asarray(runs["japp"][f])))
    for k in DECISIONS:
        np.testing.assert_array_equal(getattr(to, k).numpy(), np.asarray(getattr(jo, k)),
                                      err_msg=k)
    np.testing.assert_allclose(new_t.app_ema.numpy(), np.asarray(new_j.app_ema), atol=APP_TOL)
    np.testing.assert_allclose(new_t.app_stats.numpy(), np.asarray(new_j.app_stats),
                               atol=APP_TOL)


def test_zero_embeddings_reproduce_baseline_exactly(runs):
    """appearance_dim > 0 with all-zero embeddings is bit for bit the
    appearance-off tracker: the penalties are zero wherever either side has
    no embedding, and nothing else reads them."""
    ts = runs["ts"]
    cfg0 = dataclasses.replace(runs["tc"], appearance_dim=0)
    _, o0 = TT.run_offline(TT.TrackerContext.build(ts.cameras, cfg0, device="cpu"),
                           ts.batch.kps, ts.batch.valid)
    sA, oA = TT.run_offline(TT.TrackerContext.build(ts.cameras, runs["tc"], device="cpu"),
                            ts.batch.kps, ts.batch.valid,
                            app=np.zeros((N_FRAMES, 4, 4, D), np.float32))
    for f in TT.FrameOutput._fields:
        if f != "app_obs":
            assert torch.equal(getattr(o0, f), getattr(oA, f)), f
    assert not oA.app_obs.any() and not sA.app_ema.any() and not sA.app_stats.any()


def test_stream_with_appearance_equals_run_offline(runs):
    ts, app = runs["ts"], runs["tapp"]
    trk = MvTracker(ts.cameras, runs["tc"], device="cpu")
    outs = [trk.update(0, ts.batch.kps[0], ts.batch.valid[0], app=app[0])]
    outs += trk.update_batch(list(range(1, N_FRAMES)), ts.batch.kps[1:], ts.batch.valid[1:],
                             pad_to=8, app=app[1:])
    for f in TT.FrameOutput._fields:
        np.testing.assert_array_equal(np.stack([getattr(o, f) for o in outs]),
                                      getattr(runs["to"], f), err_msg=f)
    assert all(t.app is not None and t.app.shape[1] == D for t in trk.tracklets())


def test_appearance_needs_the_embeddings(runs):
    ts = runs["ts"]
    with pytest.raises(ValueError, match="appearance"):
        TT.run_offline(runs["tctx"], ts.batch.kps, ts.batch.valid)
    with pytest.raises(ValueError, match="appearance"):
        t_pipeline.run(ts.batch, ts.cameras, runs["tc"], device="cpu")
    trk = MvTracker(ts.cameras, runs["tc"], device="cpu")
    with pytest.raises(ValueError, match="appearance"):
        trk.update(0, ts.batch.kps[0], ts.batch.valid[0])
    with pytest.raises(ValueError, match="appearance"):
        trk.update_batch([0, 1], ts.batch.kps[:2], ts.batch.valid[:2])
    assert trk.outputs == []


def test_pipeline_run_with_appearance_on_cpu(runs):
    ts = runs["ts"]
    res = t_pipeline.run(ts.batch, ts.cameras, runs["tc"], app=runs["tapp"], device="cpu")
    tl = TT.assemble_tracklets(runs["to"])
    assert [(x.track_id, x.frame_idxs) for x in res.tracklets] == \
           [(x.track_id, x.frame_idxs) for x in tl]
    np.testing.assert_array_equal(res.tracklets[0].app, tl[0].app)
