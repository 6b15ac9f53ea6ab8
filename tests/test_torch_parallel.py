"""The port's multi-device paths (`multiview_motion_capture_torch/parallel`)
against the JAX package's on the CPU, and against the port's own unsharded
paths.

The port's meshes repeat the CPU device (`devices=[cpu] * n`), as the JAX
package's tests run on 8 virtual CPU devices (tests/conftest.py).  Each
shard runs the unsharded code on its subset, so on the CPU the sharded
paths are bit-equal to the unsharded ones: similarity blocks, LM solves,
tracker outputs (decisions and poses), streams.  Against JAX:

- mesh shapes and spec parsing, results and error messages equal;
- the camera-sharded blocks in f32: the spatial affinity within 1e-5
  relative, the score-gated spatial-time block within 1e-4 relative (the
  rtol of JAX's own test of it, tests/test_parallel.py): its mean of
  |l . x| cancels terms of ~1e3 px, and 2 of its 772 entries differ from
  XLA's by 3.9e-5 relative (JAX's own sharded blocks match its unsharded
  ones to a tolerance only);
- the track-sharded LM within 1e-4 m, as tests/test_sharded_ik.py holds
  JAX's sharded LM against its unsharded one;
- the composed `pipeline.run(mesh_spec=)`: tracklets, frames and matches
  equal, poses within 1e-3 m (JAX's own bound in
  `__graft_entry__.dryrun_multichip`);
- the dp x tp training step from JAX's parameters: loss within 1e-4
  relative, each leaf's gradient within 1e-4 of its largest magnitude
  (tests/test_torch_train.py's bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch import pipeline as t_pipeline
from multiview_motion_capture_torch import tracker as TT
from multiview_motion_capture_torch.cameras import pairwise_fundamental_det_np as t_fdet
from multiview_motion_capture_torch.cameras import pairwise_fundamental_np as t_fsp
from multiview_motion_capture_torch.cameras import synthetic_camera_ring as t_ring
from multiview_motion_capture_torch.config import PipelineConfig as TCfg
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth
from multiview_motion_capture_torch.models import checkpoint as t_ckpt
from multiview_motion_capture_torch.models import pose_net as TP
from multiview_motion_capture_torch.models.optim import AdamW
from multiview_motion_capture_torch.ops import geometry as t_geom
from multiview_motion_capture_torch.ops import ik as TI
from multiview_motion_capture_torch.ops.triangulate import triangulate_points as t_tri
from multiview_motion_capture_torch.parallel import mesh as t_mesh
from multiview_motion_capture_torch.parallel import sharded_association as t_sa
from multiview_motion_capture_torch.parallel import sharded_solvers as t_ss
from multiview_motion_capture_torch.parallel import streams as t_streams
from multiview_motion_capture_torch.parallel import train as t_train
from multiview_motion_capture_tpu import pipeline as j_pipeline
from multiview_motion_capture_tpu.config import PipelineConfig as JCfg
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth
from multiview_motion_capture_tpu.models import pose_net as JP
from multiview_motion_capture_tpu.ops import ik as JI
from multiview_motion_capture_tpu.parallel import mesh as j_mesh
from multiview_motion_capture_tpu.parallel import sharded_association as j_sa
from multiview_motion_capture_tpu.parallel import sharded_solvers as j_ss
from multiview_motion_capture_tpu.tracker import TrackerContext as JContext
from tests.torch_study_scene import one_thread

CPU = torch.device("cpu")
DECISIONS = ("track_id", "active", "updated", "spawned", "died_track_id", "matched_pose")
BLOCK_RTOL = {"affinity": 1e-5, "st_epipolar": 1e-4}
LM_TOL_M = 1e-4
POSE_TOL_M = 1e-3
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4        # of each leaf's largest magnitude


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def cpus(n):
    return [CPU] * n


# ---------------------------------------------------------------------------
# meshes and specs
# ---------------------------------------------------------------------------

def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


SPECS = ["cameras=4,clusters=8,tracks=8", "tracks=2", " clusters = 3 ,", "", "cameras=2,cameras=4",
         "cameras", "gpus=2", "tracks=two"]


def test_mesh_shapes_and_specs_match_jax():
    for n in range(1, 17):
        assert t_mesh.pick_mesh_shape(n) == j_mesh.pick_mesh_shape(n), n
    for spec in SPECS:
        t, j = _outcome(t_mesh.MeshSpec.parse, spec), _outcome(j_mesh.MeshSpec.parse, spec)
        assert t[0] == j[0] and (t[1] == j[1] if t[0] == "ValueError"
                                 else dataclasses.asdict(t[1]) == dataclasses.asdict(j[1])), spec
    # a (dp, tp) mesh as JAX builds it, over given devices
    m = t_mesh.make_mesh(8, devices=cpus(8))
    assert m.shape == dict(j_mesh.make_mesh(8).shape) == {"dp": 2, "tp": 4}
    assert m.axis_names == ("dp", "tp") and m.devices.shape == (2, 4)


def test_mesh_spec_devices():
    """On the CPU a spec repeats the CPU; on the card it takes visible
    devices only and raises JAX's error when fewer are visible; a mesh
    with no device given needs visible CUDA devices: nothing falls back."""
    kw = t_mesh.MeshSpec.parse("cameras=4,clusters=2,tracks=8").context_kwargs("cpu")
    assert [(k, v.shape, list(v.devices)) for k, v in kw.items()] == [
        ("mesh", {"dp": 4}, cpus(4)), ("cluster_mesh", {"cl": 2}, cpus(2)),
        ("ik_mesh", {"tk": 8}, cpus(8))]
    if torch.cuda.device_count() < 2:
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"MeshSpec.tracks=2 but only {n} devices visible"):
            t_mesh.MeshSpec(tracks=2).context_kwargs("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            t_ss.make_track_mesh(2)
    with pytest.raises(ValueError, match="3 devices asked for, 2 given"):
        t_ss.make_cluster_mesh(3, devices=cpus(2))


# ---------------------------------------------------------------------------
# camera-sharded similarity blocks
# ---------------------------------------------------------------------------

def _block_inputs(which):
    V, P = 8, 4
    cams = t_ring(V)
    K, Rt, Pm = (np.asarray(getattr(cams, a), np.float64) for a in ("K", "Rt", "P"))
    F = t_fsp(K, Rt) if which == "affinity" else t_fdet(Pm)
    rng = np.random.RandomState(3)
    kps = rng.rand(V, P, 17, 3).astype(np.float32)
    kps[..., :2] *= 400.0
    kps[..., 2] = rng.choice([0.0, 0.05, 0.9], size=(V, P, 17))   # the score gate's mix
    return kps, F.astype(np.float32)


def _port_block(which, kps, F, mesh=None):
    kps, F = torch.as_tensor(kps), torch.as_tensor(F)
    if which == "affinity":
        return (t_geom.projected_distance_all_pairs(kps, F) if mesh is None
                else t_sa.sharded_affinity(kps, F, mesh))
    if mesh is None:
        return t_geom.masked_symmetric_epipolar_error(kps[:, :, None, None], kps[None, None],
                                                      F[:, None, :, None], 0.1)
    return t_sa.sharded_st_epipolar(kps, F, 0.1, mesh)


@pytest.mark.parametrize("which", ["affinity", "st_epipolar"])
def test_sharded_blocks(which):
    """4-way camera mesh: equal to JAX's sharded block within BLOCK_RTOL
    (f32), bit-equal to the port's unsharded block (f32 and
    f64)."""
    kps, F = _block_inputs(which)
    mesh = t_ss.make_axis_mesh(4, "dp", devices=cpus(4))
    got = _port_block(which, kps, F, mesh)
    jmesh = j_ss.make_axis_mesh(4, "dp")
    ref = np.asarray(j_sa.sharded_affinity(jnp.asarray(kps), jnp.asarray(F), jmesh)
                     if which == "affinity" else
                     j_sa.sharded_st_epipolar(jnp.asarray(kps), jnp.asarray(F), 0.1, jmesh))
    g = got.numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(ref))
    off = ~np.isnan(ref) & ~np.eye(8, dtype=bool)[:, None, :, None]   # the diagonal uses eps F
    np.testing.assert_allclose(g[off], ref[off], rtol=BLOCK_RTOL[which])
    for dt in (np.float32, np.float64):
        a = _port_block(which, kps.astype(dt), F.astype(dt))
        b = _port_block(which, kps.astype(dt), F.astype(dt), mesh)
        assert torch.equal(torch.nan_to_num(a, -1.0), torch.nan_to_num(b, -1.0)), dt


# ---------------------------------------------------------------------------
# track-sharded LM
# ---------------------------------------------------------------------------

def _lm_problem():
    """tests/test_torch_ik.py's problem in 8 slots: ground-truth-grouped
    observations of 3 people in 4 views (seed 2, frame 3), the other slots
    empty, a geometric cold init from their triangulation."""
    cfg = TCfg(n_views=4, max_people=6, max_tracks=8, max_frames=None)
    s = t_synth(n_frames=4, n_people=3, n_views=4, cfg=cfg, seed=2)
    T, V, f = 8, 4, 3
    obs = np.zeros((T, V, 17, 3), np.float32)
    w = np.zeros((T, V), np.float32)
    for v in range(V):
        for p in range(s.gt_slot_person.shape[2]):
            pid = s.gt_slot_person[f, v, p]
            if pid >= 0 and s.batch.valid[f, v, p]:
                obs[pid, v] = s.batch.kps[f, v, p]
                w[pid, v] = 1.0
    P = s.cameras.P.numpy()
    K_inv = np.linalg.inv(s.cameras.K.numpy().astype(np.float64)).astype(np.float32)
    skel = TI.Skeleton.default()
    tri = t_tri(torch.as_tensor(P), torch.as_tensor(K_inv), TI.add_mid_spine(torch.as_tensor(obs)),
                torch.as_tensor(w) > 0, cfg.triangulate_min_score, cfg.triangulate_refine_iters)
    tri = torch.nan_to_num(tri).clamp(-100.0, 100.0)
    root = (0.5 * (tri[:, TI._LHIP, :3] + tri[:, TI._RHIP, :3])).numpy()
    euler = TI.geometric_init(tri, skel).numpy()
    side = np.tile(np.asarray(skel.side_bone_lens), (T, 1)).astype(np.float32)
    kw = dict(n_iters=12, eps=cfg.ik_proj_eps, lam0=cfg.ik_lm_damping_init,
              lam_up=cfg.ik_lm_damping_up, lam_down=cfg.ik_lm_damping_down, stages=2,
              ftol=cfg.ik_ftol, xtol=cfg.ik_xtol)
    return (root, euler, side), obs, w, P, kw


@pytest.mark.parametrize("solver,per_slot_P", [("chol", False), ("gj", False), ("gj", True)])
def test_sharded_lm_solve_matches_jax(solver, per_slot_P):
    """T 8 over 4 devices against JAX's `sharded_lm_solve` on its 4-device
    track mesh; with per-slot P (the `ik_max_views` case) each slot sees
    its views in its own order.  Bit-equal to the port's unsharded solve."""
    init, obs, w, P, kw = _lm_problem()
    T, V = w.shape
    if per_slot_P:
        perm = np.stack([np.roll(np.arange(V), t) for t in range(T)])
        obs = np.take_along_axis(obs, perm[:, :, None, None], axis=1)
        w = np.take_along_axis(w, perm, axis=1)
        P = P[perm]
    jp, jj = j_ss.sharded_lm_solve(JI.IkParams(*map(jnp.asarray, init)), JI.Skeleton.default(),
                                   jnp.asarray(obs), jnp.asarray(w), jnp.asarray(P),
                                   j_ss.make_track_mesh(4), solver=solver, interpret=True, **kw)
    args = (TI.IkParams(*map(torch.as_tensor, init)), TI.Skeleton.default(),
            torch.as_tensor(obs), torch.as_tensor(w), torch.as_tensor(P))
    tp, tj = t_ss.sharded_lm_solve(*args, t_ss.make_track_mesh(4, devices=cpus(4)),
                                   solver=solver, **kw)
    # joints, roots and bone lengths (angles of joints the observations
    # do not pin can part by centiradians with the joints equal)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=LM_TOL_M)
    np.testing.assert_allclose(tp.root.numpy(), np.asarray(jp.root), atol=LM_TOL_M)
    np.testing.assert_allclose(tp.side_lens.numpy(), np.asarray(jp.side_lens), atol=LM_TOL_M)
    up, uj = TI.solve_two_stage(*args, solver=solver, **kw)
    assert torch.equal(tj, uj) and all(torch.equal(a, b) for a, b in zip(tp, up))


# ---------------------------------------------------------------------------
# the tracker with each mesh against the unsharded tracker
# ---------------------------------------------------------------------------

def _run(ctx, seq):
    _, out = TT.run_offline(ctx, seq.batch.kps, seq.batch.valid)
    return TT.outputs_to_numpy(out)


# name -> (config, scene, use_ik, mesh kwargs of TrackerContext.build)
TRACKER_CASES = {
    # tests/test_parallel.py's 20-camera rig, 3 frames
    "cameras_20views": (dict(n_views=20, max_people=10, max_tracks=12),
                        dict(n_frames=3, n_people=6, n_views=20, drop_prob=0.05, seed=13),
                        False, lambda: dict(mesh=t_ss.make_axis_mesh(4, "dp", devices=cpus(4)))),
    # __graft_entry__.dryrun_multichip's 16-view clustered rig, 4 clusters
    "clusters_16views": (dict(n_views=16, max_people=4, max_tracks=6, assoc_clusters=4,
                              ik_solver="gj", ik_warm_stages=1),
                         dict(n_frames=3, n_people=2, n_views=16, seed=13, drop_prob=0.0,
                              min_person_distance=1.0),
                         True, lambda: dict(cluster_mesh=t_ss.make_cluster_mesh(
                             4, devices=cpus(4)))),
    # tests/test_sharded_ik.py's rigs: all views, and top-4 views of 8
    "tracks_chol": (dict(n_views=4, max_people=4, max_tracks=8, ik_solver="chol"),
                    dict(n_frames=5, n_people=3, n_views=4, seed=21, drop_prob=0.0,
                         min_person_distance=1.2),
                    True, lambda: dict(ik_mesh=t_ss.make_track_mesh(4, devices=cpus(4)))),
    "tracks_topk_gj_fused": (dict(n_views=8, max_people=4, max_tracks=8, ik_max_views=4,
                                  ik_solver="gj_fused"),
                             dict(n_frames=4, n_people=2, n_views=8, seed=5, drop_prob=0.0,
                                  min_person_distance=1.2),
                             True, lambda: dict(ik_mesh=t_ss.make_track_mesh(
                                 2, devices=cpus(2)))),
}


@pytest.mark.parametrize("case", list(TRACKER_CASES))
def test_tracker_mesh_matches_unsharded(case):
    cfg_kw, scene, use_ik, meshes = TRACKER_CASES[case]
    cfg = TCfg(max_frames=None, **cfg_kw)
    seq = t_synth(cfg=cfg, **scene)
    plain = _run(TT.TrackerContext.build(seq.cameras, cfg, use_ik=use_ik, device="cpu"), seq)
    ctx = TT.TrackerContext.build(seq.cameras, cfg, use_ik=use_ik, device="cpu", **meshes())
    sharded = _run(ctx, seq)
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(sharded, f), getattr(plain, f), err_msg=f)
    assert plain.updated.any()
    # every output, poses included: each shard runs the unsharded code
    for f in TT.FrameOutput._fields:
        np.testing.assert_array_equal(getattr(sharded, f), getattr(plain, f), err_msg=f)


def test_build_validation_matches_jax():
    """TrackerContext.build's mesh checks raise JAX's errors."""
    def both(cfg_kw, use_ik, n, key, axis):
        cfg_kw = dict(max_people=4, max_frames=None, **cfg_kw)
        tcfg, jcfg = TCfg(**cfg_kw), JCfg(**cfg_kw)
        cams = t_synth(n_frames=1, n_people=1, n_views=tcfg.n_views, cfg=tcfg, seed=1).cameras
        jcams = j_synth(n_frames=1, n_people=1, n_views=tcfg.n_views, cfg=jcfg, seed=1).cameras
        with pytest.raises(ValueError) as te:
            TT.TrackerContext.build(cams, tcfg, use_ik=use_ik, device="cpu",
                                    **{key: t_ss.make_axis_mesh(n, axis, devices=cpus(n))})
        with pytest.raises(ValueError) as je:
            JContext.build(jcams, jcfg, use_ik=use_ik, **{key: j_ss.make_axis_mesh(n, axis)})
        assert str(te.value) == str(je.value)
        return str(te.value)

    assert "n_views=6 not divisible" in both(dict(n_views=6), True, 4, "mesh", "dp")
    assert "needs assoc_clusters > 1" in both(dict(n_views=4), True, 2, "cluster_mesh", "cl")
    assert "assoc_clusters=3 not divisible" in both(dict(n_views=6, assoc_clusters=3), True, 2,
                                                    "cluster_mesh", "cl")
    assert "ik_mesh needs use_ik" in both(dict(n_views=4), False, 2, "ik_mesh", "tk")
    assert "max_tracks=6 not divisible" in both(dict(n_views=4, max_tracks=6), True, 4,
                                                "ik_mesh", "tk")


def test_pipeline_mesh_spec_matches_jax():
    """The composed system (camera-sharded similarity, cluster-sharded ALS,
    track-sharded LM in one context) through `pipeline.run(mesh_spec=)`,
    on `__graft_entry__.dryrun_multichip`'s scene at 4 devices, against
    JAX's `pipeline.run(mesh_spec=)` (the tracker cases above hold each
    mesh against the port's unsharded run)."""
    kw = dict(n_views=16, max_people=4, max_tracks=4, max_frames=None, assoc_clusters=4,
              ik_solver="gj", ik_warm_stages=1)
    scene = dict(n_frames=3, n_people=2, n_views=16, seed=23, drop_prob=0.0,
                 min_person_distance=1.0)
    spec = "cameras=4,clusters=4,tracks=4"
    tcfg, jcfg = TCfg(**kw), JCfg(als_backend="xla", **kw)
    tseq, jseq = t_synth(cfg=tcfg, **scene), j_synth(cfg=jcfg, **scene)
    got = t_pipeline.run(tseq.batch, tseq.cameras, tcfg, mesh_spec=spec, device="cpu").tracklets
    ref = j_pipeline.run(jseq.batch, jseq.cameras, jcfg, mesh_spec=spec).tracklets
    assert len(got) == len(ref) == 2
    for x, y in zip(got, ref):
        assert x.frame_idxs == y.frame_idxs
        np.testing.assert_array_equal(x.matched_pose, y.matched_pose)
        np.testing.assert_allclose(x.poses_3d, y.poses_3d, atol=POSE_TOL_M)


# ---------------------------------------------------------------------------
# streams to devices
# ---------------------------------------------------------------------------

def test_streams_match_run_offline():
    """4 streams over 2 mesh entries (two worker threads, two streams each,
    as tests/test_parallel.py's scene): each bit-equal to `run_offline` on
    that stream alone; a camera-sharded context raises JAX's error, and so
    does a stream count the mesh does not divide."""
    cfg = TCfg(n_views=4, max_people=5, max_tracks=6, max_frames=None)
    seqs = [t_synth(n_frames=6, n_people=2 + (s % 2), n_views=4, cfg=cfg, seed=20 + s,
                    drop_prob=0.05) for s in range(4)]
    kps = np.stack([s.batch.kps for s in seqs])
    valid = np.stack([s.batch.valid for s in seqs])
    ctx = TT.TrackerContext.build(seqs[0].cameras, cfg, device="cpu")
    states, out = t_streams.run_offline_streams(ctx, kps, valid,
                                                t_streams.make_streams_mesh(2, devices=cpus(2)))
    per_stream = t_streams.assemble_stream_tracklets(out)
    for b, seq in enumerate(seqs):
        state, ref = TT.run_offline(ctx, seq.batch.kps, seq.batch.valid)
        for f in TT.FrameOutput._fields:
            assert torch.equal(getattr(out, f)[b], getattr(ref, f)), (b, f)
        for f in TT.TrackerState.__dataclass_fields__:
            assert torch.equal(getattr(states, f)[b], getattr(state, f)), (b, f)
        tl = TT.assemble_tracklets(ref)
        assert [t.frame_idxs for t in per_stream[b]] == [t.frame_idxs for t in tl]
    with pytest.raises(ValueError, match="B=4 streams not divisible by mesh axis streams=3"):
        t_streams.run_offline_streams(ctx, kps, valid,
                                      t_streams.make_streams_mesh(3, devices=cpus(3)))
    cam_ctx = TT.TrackerContext.build(seqs[0].cameras, cfg, use_ik=False, device="cpu",
                                      mesh=t_mesh.make_mesh(4, devices=cpus(4)))
    with pytest.raises(ValueError, match="camera-sharding"):
        t_streams.run_offline_streams(cam_ctx, kps[:1], valid[:1],
                                      t_streams.make_streams_mesh(1, devices=cpus(1)))


# ---------------------------------------------------------------------------
# the dp x tp training step
# ---------------------------------------------------------------------------

# tests/test_parallel.py's config, in f32 compute
SMALL = dict(img_hw=(64, 48), stage_features=(128, 128, 256), blocks_per_stage=1,
             head_features=128)
BATCH = 4


def _train_batch(cfg):
    rng = np.random.RandomState(0)
    H, W = cfg.img_hw
    Hh, Wh = cfg.heatmap_hw
    images = rng.rand(BATCH, H, W, 3).astype(np.float32)
    kps = (rng.rand(BATCH, 17, 2) * [Wh, Hh]).astype(np.float32)
    mask = (rng.rand(BATCH, 17) > 0.2).astype(np.float32)
    return images, kps, mask


def test_sharded_train_step_matches_jax():
    """The port's step over 8 CPU entries ((dp, tp) = (2, 4), JAX's test
    mesh) from JAX's parameters (what JAX's `sharded_train_step` draws:
    `PoseNet.init` at PRNGKey(0), carried by `posenet_from_flax`): the
    loss within 1e-4 relative of JAX's, the port's reduced gradients
    within 1e-4 of each leaf's largest magnitude of JAX's.  GSPMD keeps
    the unsharded math, so JAX's side is its unsharded loss and gradient
    (the JAX package's own tests/test_parallel.py runs its sharded step;
    its eager init alone takes ~10 s on the CPU)."""
    jcfg = JP.PoseNetConfig(compute_dtype=jnp.float32, **SMALL)
    tcfg = TP.PoseNetConfig(compute_dtype=torch.float32, **SMALL)
    batch = _train_batch(tcfg)
    model = JP.PoseNet(jcfg)
    H, W = jcfg.img_hw
    p0 = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"]

    def jloss(p, images, kps, mask):
        target = JP.gaussian_heatmaps(kps, jcfg.heatmap_hw)
        return JP.heatmap_loss(model.apply({"params": p}, images, train=True), target, mask)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(p0, *map(jnp.asarray, batch))
    step, params, opt, data = t_train.sharded_train_step(t_mesh.make_mesh(8, devices=cpus(8)),
                                                         tcfg)
    assert params.mesh.shape == {"dp": 2, "tp": 4}
    net = t_ckpt.posenet_from_flax(tcfg, jax.device_get(p0))
    params.load_module(net)
    # JAX's rule on the out-channel axis: every 4-d kernel or vector >= 128
    # wide is sharded, the 64-wide stem and the 17-channel head are not
    assert params.rules["stem.weight"] is None and params.rules["head.weight"] is None
    assert params.rules["deconvs.0.weight"] == 1 and params.rules["blocks.2.conv1.weight"] == 0
    _, _, loss = step(params, opt, *(data.put(torch.as_tensor(x)) for x in batch))
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    grads = params.gather(grads=True)
    for path, p, kind in t_ckpt._posenet_leaves(net):
        name = next(n for n, q in net.named_parameters() if q is p)
        jg = np.asarray(t_ckpt._nested(jgrads, path))
        tg = t_ckpt._to_flax(grads[name], kind)
        err = np.abs(tg - jg).max()
        assert err <= GRAD_TOL * np.abs(jg).max(), (name, err)


@pytest.mark.parametrize("n_devices", [1, 4])
def test_sharded_train_step_matches_unsharded(n_devices):
    """Two steps against the port's unsharded `train_step` from the same
    parameters: bit-equal at (dp, tp) = (1, 1); at (1, 4) too (tp shards
    storage only); the leaves' tp slices live on their devices."""
    cfg = TP.PoseNetConfig(compute_dtype=torch.float32, **SMALL)
    images, kps, mask = map(torch.as_tensor, _train_batch(cfg))
    step, params, opt, _ = t_train.sharded_train_step(
        t_mesh.make_mesh(n_devices, devices=cpus(n_devices)), cfg)
    net = params.module(CPU)
    ref_opt = AdamW(net.parameters(), 1e-3)
    target = TP.gaussian_heatmaps(kps, cfg.heatmap_hw)
    for _ in range(2):
        ref = TP.train_step(net, ref_opt, images, target, mask)
        _, _, loss = step(params, opt, images, kps, mask)
        assert torch.equal(loss, ref)
        for name, p in net.named_parameters():
            assert torch.equal(params.gather()[name], p.detach()), name
            assert torch.equal(params.gather(grads=True)[name], p.grad), name
    w = params.local[(0, n_devices - 1)]["deconvs.1.weight"]
    assert w.shape[1] == cfg.head_features // n_devices
