"""The port's hierarchical (camera-cluster) association against the JAX
package on the CPU: the batched ALS (plain version of the B3 kernel)
against the JAX batched kernel in interpret mode, the per-cluster
similarity builders, and the clustered tracker over short synthetic scenes
(divisible, non-divisible with a dead-pad view, and the wide-rig levers:
top-k IK views, the fused LM solver, merged cold schedule, warm budget 3),
plus one clustered step from a carried mid-sequence JAX state.

The JAX side runs its XLA ALS (`als_backend="xla"`), as the JAX package's
own cluster tests do.  Decisions (track ids, lifecycle states,
updated/spawned flags, matched detections, deaths) must be equal; poses
within 1e-3 m, as tests/test_torch_tracker.py holds them.  The scenes'
seeds are ones where the spawn solves are well conditioned: a person seen
in few views can make the cold LM bistable, so that a 1e-7 change of its
initial angles moves a joint by centimetres in either package.  The
10-view rig at seed 1 does; `test_bistable_spawn_seed` holds that case to
what it shows (scripts/torch_parity_study.py --study cold; PERF.md, Open
questions).  Where the ALS does not settle its grouping depends on
rounding (PERF.md, Findings).
"""
import functools
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch import tracker as TT
from multiview_motion_capture_torch.config import SHELF_BENCH as T_CFG
from multiview_motion_capture_torch.data.ingest import filter_bad_poses as t_filter
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth
from multiview_motion_capture_torch.ops import als_kernel, cuda_lib
from multiview_motion_capture_torch.ops import association as TA
from multiview_motion_capture_torch.ops import ik as TI
from multiview_motion_capture_tpu import tracker as JT
from multiview_motion_capture_tpu.config import SHELF_BENCH as J_CFG
from multiview_motion_capture_tpu.data.ingest import filter_bad_poses as j_filter
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth
from multiview_motion_capture_tpu.ops import als_pallas as JP
from multiview_motion_capture_tpu.ops import ik as JI
from tests.torch_study_scene import one_thread

DECISIONS = ("track_id", "active", "updated", "spawned", "died_track_id", "matched_pose")
POSE_TOL_M = 1e-3
SIM_TOL = 1e-5
N_FRAMES = 6
CONSTS = ("F_spatial", "F_det", "K_inv", "diag_mask", "init_A",
          "cluster_diag_mask", "cluster_init_A")

# name -> (views, clusters, seed, config changes)
CASES = {
    "8views_2clusters": (8, 2, 1, {}),
    "10views_3clusters_deadpad": (10, 3, 2, {}),
    "8views_wide_levers": (8, 2, 3, dict(ik_max_views=4, ik_solver="gj_fused",
                                         ik_cold_stages=1, ik_warm_iters=3)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _state_arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in TT.TrackerState.__dataclass_fields__}


def _problem(seed, sizes, n_people):
    """chip_smoke.als_problem: a seeded matching problem that settles."""
    rng = np.random.RandomState(seed)
    groups = []
    for s in sizes:
        groups.extend(rng.permutation(n_people)[:s].tolist())
    n = len(groups)
    cam_of = np.concatenate([[c] * s for c, s in enumerate(sizes)])
    W = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for j in range(n):
            if i != j and cam_of[i] != cam_of[j]:
                base = 0.85 if groups[i] == groups[j] else 0.08
                W[i, j] = np.clip(base + rng.uniform(-0.06, 0.06), 0, 1)
    return 0.5 * (W + W.T)


def test_batched_als_plain_matches_pallas_batched():
    # two problems that settle at different iterations (42 and 44): each
    # must freeze at its own stop test
    sizes, rank = (6, 4, 4, 4, 4), 8
    n = sum(sizes)
    W = np.stack([_problem(s, sizes, n_people=6) for s in (0, 1)])
    mask = TA.block_diag_mask(sizes)
    init = TA.default_init_factor(n, rank)
    kw = dict(max_iter=100, stable_iters=10)

    ctx = JP.PallasAlsContext.build(n, mask, init)
    W_pad = jnp.stack([JP.pad_similarity(jnp.asarray(w), ctx.pad) for w in W])
    x_j, it_j = JP.match_als_pallas_batched(W_pad, ctx.keep, ctx.eye_t, ctx.init_A,
                                            ctx.n_true, rank=ctx.rank, interpret=True, **kw)
    before = cuda_lib.ALS_BATCHED.launches
    res = als_kernel.match_als_batched(torch.as_tensor(W), torch.as_tensor(mask),
                                       torch.as_tensor(init), **kw)
    assert cuda_lib.ALS_BATCHED.launches == before        # CPU: the plain version
    assert res.x_bin.shape == (2, n, n) and res.n_iters.dtype == torch.int32
    np.testing.assert_array_equal(res.x_bin.numpy(), np.asarray(x_j)[:, :n, :n])
    np.testing.assert_array_equal(res.n_iters.numpy(), np.asarray(it_j))
    assert (res.n_iters.numpy() < 100).all() and res.n_iters[0] != res.n_iters[1]
    for c in range(2):
        solo = TA.match_als(torch.as_tensor(W[c]), torch.as_tensor(mask),
                            torch.as_tensor(init), **kw)
        assert torch.equal(res.x_bin[c], solo.x_bin)
        assert int(res.n_iters[c]) == int(solo.n_iters)
        xs, its = JP.match_als_pallas(W_pad[c], ctx.keep, ctx.eye_t, ctx.init_A,
                                      ctx.n_true, rank=ctx.rank, interpret=True, **kw)
        np.testing.assert_array_equal(res.x_bin[c].numpy(), np.asarray(xs)[:n, :n])
        assert int(res.n_iters[c]) == int(its)


def test_batched_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError, match="must be \\(C, N, N\\)"):
        als_kernel.match_als_batched(torch.zeros(4, 4), torch.zeros(4, 4, dtype=torch.bool),
                                     torch.zeros(4, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        als_kernel.match_als_batched(torch.zeros(2, 4, 4, device="meta"),
                                     torch.zeros(4, 4, dtype=torch.bool, device="meta"),
                                     torch.zeros(4, 2, device="meta"))


def _configs(V, C, extra):
    kw = dict(n_views=V, assoc_clusters=C, max_frames=None, **extra)
    return dataclasses.replace(J_CFG, als_backend="xla", **kw), dataclasses.replace(T_CFG, **kw)


def _run_both(case, V, C, seed, extra):
    """Both packages over synthetic_sequence(6 frames, 3 people, V views,
    seed)."""
    jc, tc = _configs(V, C, extra)
    kw = dict(n_frames=N_FRAMES, n_people=3, n_views=V, seed=seed)
    js, ts = j_synth(cfg=jc, **kw), t_synth(cfg=tc, **kw)
    jb, tb = j_filter(js.batch, jc), t_filter(ts.batch, tc)
    jctx = JT.TrackerContext.build(js.cameras, jc)
    jstate, jo = JT.run_offline(jctx, jnp.asarray(jb.kps), jnp.asarray(jb.valid))
    tctx = TT.TrackerContext.build(ts.cameras, tc, device="cpu")
    tstate, to = TT.run_offline(tctx, tb.kps, tb.valid)
    return dict(case=case, jc=jc, tc=tc, js=js, ts=ts, jb=jb, tb=tb, jctx=jctx, tctx=tctx,
                jstate=jstate, jo=jax.device_get(jo), tstate=tstate,
                to=TT.outputs_to_numpy(to))


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    """Both packages over the case's scene, built once per case (the JAX
    side compiles its scan)."""
    V, C, seed, extra = CASES[request.param]
    return _run_both(request.param, V, C, seed, extra)


def test_clustered_decisions_equal(run):
    for field in DECISIONS:
        a, b = np.asarray(getattr(run["jo"], field)), getattr(run["to"], field)
        assert a.shape == b.shape, field
        bad = np.nonzero((a != b).reshape(N_FRAMES, -1).any(1))[0]
        assert len(bad) == 0, f"{run['case']}: {field} differs from frame {bad[:5]}"
    to = run["to"]
    assert to.spawned.any() and (to.updated & ~to.spawned).any()
    # the clusters' iterations are summed: each cluster runs at least one
    assert (to.als_iters >= run["tc"].assoc_clusters).all()


def test_clustered_poses_within_tolerance(run):
    upd = np.asarray(run["jo"].updated)
    for field in ("pose3d", "root", "side_lens"):
        a = np.asarray(getattr(run["jo"], field))[upd]
        b = getattr(run["to"], field)[upd]
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, atol=POSE_TOL_M, err_msg=field)


def test_cluster_context_constants_match(run):
    jctx, tctx = run["jctx"], run["tctx"]
    for f in ("cluster_diag_mask", "cluster_init_A"):
        np.testing.assert_array_equal(getattr(tctx, f).numpy(), np.asarray(getattr(jctx, f)),
                                      err_msg=f)
    carried = TT.context_constants_from_numpy(
        run["tc"], run["ts"].cameras, {f: np.asarray(getattr(jctx, f)) for f in CONSTS},
        device="cpu")
    for f in ("cluster_diag_mask", "cluster_init_A"):
        np.testing.assert_array_equal(getattr(carried, f).numpy(), np.asarray(getattr(jctx, f)))
    V, C = run["tc"].n_views, run["tc"].assoc_clusters
    Vc = -(-V // C)
    assert [cl.views.tolist() for cl in carried.clusters] == \
           [(list(range(c, V, C)) + [c] * Vc)[:Vc] for c in range(C)]
    assert [cl.n_real for cl in carried.clusters] == [len(range(c, V, C)) for c in range(C)]
    with pytest.raises(ValueError, match="cluster_diag_mask"):
        TT.context_constants_from_numpy(
            run["tc"], run["ts"].cameras, {f: np.asarray(getattr(jctx, f)) for f in CONSTS[:5]},
            device="cpu")


def test_cluster_similarities_match(run):
    """Each cluster's spatial-time and spatial-only matrices, dead-pad views
    included, from the same mid-sequence state."""
    f = N_FRAMES - 1
    jstate = run["jstate"]
    tstate = TT.from_numpy_state(_state_arrays(jstate), device="cpu")
    jk, jv = jnp.asarray(run["jb"].kps[f]), jnp.asarray(run["jb"].valid[f])
    tk, tv = torch.as_tensor(run["tb"].kps[f]), torch.as_tensor(run["tb"].valid[f])
    for cl in run["tctx"].clusters:
        views = cl.views.numpy()
        vv = None if cl.view_valid is None else cl.view_valid.numpy()
        sj, evj, dj = JT._spatial_time_similarity(run["jctx"], jstate, jk, jv,
                                                  view_idx=views, view_valid=vv)
        st, evt, dt = TT._spatial_time_similarity(run["tctx"], tstate, tk, tv,
                                                  view_idx=cl.views, view_valid=cl.view_valid)
        np.testing.assert_array_equal(evt.numpy(), np.asarray(evj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SIM_TOL)
        sj, evj = JT._spatial_similarity(run["jctx"], jk, jv, view_idx=views, view_valid=vv)
        st, evt = TT._spatial_similarity(run["tctx"], tk, tv,
                                         view_idx=cl.views, view_valid=cl.view_valid)
        np.testing.assert_array_equal(evt.numpy(), np.asarray(evj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SIM_TOL)


def test_carried_state_clustered_step(run):
    """One clustered step of each package from the same mid-sequence state
    (the JAX state and context constants carried across as numpy)."""
    jctx = run["jctx"]
    tctx = TT.context_constants_from_numpy(
        run["tc"], run["ts"].cameras, {f: np.asarray(getattr(jctx, f)) for f in CONSTS},
        device="cpu")
    f = 2    # step frame 2's detections from the state after all frames
    state = TT.from_numpy_state(_state_arrays(run["jstate"]), device="cpu")
    _, to = TT.make_step(tctx)(state, torch.as_tensor(run["tb"].kps[f]),
                               torch.as_tensor(run["tb"].valid[f]))
    _, jo = jax.jit(JT.make_step(jctx))(
        run["jstate"], (jnp.asarray(run["jb"].kps[f]), jnp.asarray(run["jb"].valid[f])))
    for k in DECISIONS:
        np.testing.assert_array_equal(getattr(to, k).numpy(), np.asarray(getattr(jo, k)),
                                      err_msg=k)
    upd = np.asarray(jo.updated)
    assert upd.any()
    np.testing.assert_allclose(to.pose3d.numpy()[upd], np.asarray(jo.pose3d)[upd],
                               atol=POSE_TOL_M)


def test_bistable_spawn_seed(monkeypatch):
    """The 10-view, 3-cluster rig at seed 1, the case CASES leaves out.
    Decisions equal the JAX package's on every frame, but the person
    spawned at frame 0 in 4 views ends centimetres apart.  Its cold LM
    solve is bistable in both packages: on the same inputs (the port's),
    one +-1e-7 step of the initial angles moves each package's solution
    by centimetres, while the solves of people seen in 6 or 10 views move
    by less than 1e-4 m."""
    cold, solve = [], TI.solve_two_stage

    def recording(init, skel, obs, w, P, n_iters, **lm_kw):
        if n_iters == T_CFG.ik_cold_iters:
            cold.append((init, obs, w, P, lm_kw))
        return solve(init, skel, obs, w, P, n_iters, **lm_kw)

    monkeypatch.setattr(TI, "solve_two_stage", recording)
    r = _run_both("10views_3clusters_seed1", 10, 3, 1, {})
    jo, to = r["jo"], r["to"]
    for field in DECISIONS:
        np.testing.assert_array_equal(getattr(to, field), np.asarray(getattr(jo, field)),
                                      err_msg=field)
    both = np.asarray(jo.updated) & to.updated
    diff = np.abs(np.asarray(jo.pose3d) - to.pose3d).max(axis=(-1, -2))     # (F, T)
    assert to.spawned[0].any() and len(cold) >= 1
    views = (cold[0][2].numpy() > 0).sum(1)
    weak = np.nonzero(to.spawned[0] & (views == 4))[0]
    strong = np.nonzero(to.spawned[0] & (views >= 6))[0]
    assert len(weak) == 1 and len(strong) >= 1
    assert diff[0, weak[0]] > 1e-2                      # the deviation: over 1 cm
    assert (diff[1:][both[1:]] <= POSE_TOL_M).all()     # later frames agree

    init, obs, w, P, lm_kw = cold[0]
    j_solve = jax.jit(functools.partial(JI.solve_two_stage, n_iters=T_CFG.ik_cold_iters,
                                        interpret=True, **lm_kw))

    def joints(euler):
        t = solve(init._replace(euler=euler), r["tctx"].skel, obs, w, P,
                  T_CFG.ik_cold_iters, **lm_kw)[1].numpy()
        j_init = JI.IkParams(jnp.asarray(init.root.numpy()), jnp.asarray(euler.numpy()),
                             jnp.asarray(init.side_lens.numpy()))
        j = np.asarray(j_solve(j_init, r["jctx"].skel, jnp.asarray(obs.numpy()),
                               jnp.asarray(w.numpy()), jnp.asarray(P.numpy()))[1])
        return t, j

    t0, j0 = joints(init.euler)
    moved = {"port": 0.0, "jax": 0.0}
    for draw in range(2):
        step = 1e-7 * np.random.RandomState(draw).choice([-1.0, 1.0], tuple(init.euler.shape))
        t1, j1 = joints(init.euler + torch.as_tensor(step, dtype=init.euler.dtype))
        for name, a, b in (("port", t0, t1), ("jax", j0, j1)):
            shift = np.abs(b - a).max(axis=(-1, -2))
            moved[name] = max(moved[name], float(shift[weak[0]]))
            assert (shift[strong] < 1e-4).all(), name
    assert moved["port"] > 1e-2 and moved["jax"] > 1e-2, moved
