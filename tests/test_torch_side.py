"""The port's side surfaces against the JAX package's, on the CPU: geometry
and quaternion functions, `associate_frame`, the alternate matchers (SVT,
spectral, BIP, greedy, ray association), generic FK and BVH files, the
host tools (`native`, `ref_compat`, `tools`), drawing (`viz`) and stage
timing (`profiling`).  Inputs come from numpy seeds; each comparison
states its tolerance."""
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_tpu import cameras as j_cameras
from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence
from multiview_motion_capture_tpu.ops import association as j_assoc
from multiview_motion_capture_tpu.ops import association_alt as j_alt
from multiview_motion_capture_tpu.ops import fk_generic as j_fkg
from multiview_motion_capture_tpu.ops import geometry as j_geom
from multiview_motion_capture_tpu.ops import greedy as j_greedy
from multiview_motion_capture_tpu.ops import quaternions as j_quat
from multiview_motion_capture_tpu.utils import bvh as j_bvh
from multiview_motion_capture_tpu.utils import native as j_native
from multiview_motion_capture_tpu.utils import ref_compat as j_ref
from multiview_motion_capture_tpu.utils import tools as j_tools
from multiview_motion_capture_tpu.utils import viz as j_viz
from multiview_motion_capture_torch.cameras import CameraBank
from multiview_motion_capture_torch.ops import association as t_assoc
from multiview_motion_capture_torch.ops import association_alt as t_alt
from multiview_motion_capture_torch.ops import fk_generic as t_fkg
from multiview_motion_capture_torch.ops import geometry as t_geom
from multiview_motion_capture_torch.ops import greedy as t_greedy
from multiview_motion_capture_torch.ops import quaternions as t_quat
from multiview_motion_capture_torch.tracker import Tracklet
from multiview_motion_capture_torch.utils import bvh as t_bvh
from multiview_motion_capture_torch.utils import native as t_native
from multiview_motion_capture_torch.utils import profiling as t_prof
from multiview_motion_capture_torch.utils import ref_compat as t_ref
from multiview_motion_capture_torch.utils import tools as t_tools
from multiview_motion_capture_torch.utils import viz as t_viz
from tests.torch_study_scene import one_thread

F32_TOL = 1e-6      # elementwise f32 math on the same inputs


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _port_cams(jcams):
    return CameraBank.from_k_rt(np.asarray(jcams.K), np.asarray(jcams.Rt),
                                np.asarray(jcams.img_wh))


# ---------------------------------------------------------------------------
# geometry and quaternions
# ---------------------------------------------------------------------------

def test_geometry_functions_match_jax():
    rng = np.random.RandomState(0)
    cams = j_cameras.synthetic_camera_ring(4)
    K, Rt, P = (np.asarray(a, dtype=np.float32) for a in (cams.K, cams.Rt, cams.P))
    # fundamental matrices: entries up to ~1e6, so relative to the largest
    P1, P2 = np.broadcast_to(P[:, None], (4, 4, 3, 4)), np.broadcast_to(P[None], (4, 4, 3, 4))
    Fj = np.asarray(j_geom.fundamental_from_projections(jnp.asarray(P1), jnp.asarray(P2)))
    Ft = t_geom.fundamental_from_projections(_t(P1), _t(P2)).numpy()
    assert np.abs(Ft - Fj).max() <= 1e-5 * np.abs(Fj).max()
    f1 = t_geom.fundamental_from_projections(_t(P[0]), _t(P[1])).numpy()
    np.testing.assert_allclose(f1, Ft[0, 1], rtol=0, atol=1e-6 * np.abs(f1).max())
    Fpj = np.asarray(j_geom.pairwise_fundamental_mats(jnp.asarray(K), jnp.asarray(Rt)))
    Fpt = t_geom.pairwise_fundamental_mats(_t(K), _t(Rt)).numpy()
    assert np.abs(Fpt - Fpj).max() <= 1e-5 * np.abs(Fpj).max()
    # rays and distances
    uv = rng.uniform(0, 1000, (4, 7, 2)).astype(np.float32)
    Kr = np.asarray(cams.Kr_inv, dtype=np.float32)[:, None]
    rj = np.asarray(j_geom.unproject_to_rays(jnp.asarray(uv), jnp.asarray(Kr)))
    rt = t_geom.unproject_to_rays(_t(uv), _t(Kr)).numpy()
    np.testing.assert_allclose(rt, rj, atol=F32_TOL)
    pts = rng.uniform(-2, 2, (4, 7, 3)).astype(np.float32)
    org = np.asarray(cams.cam_loc, dtype=np.float32)[:, None]
    dj = np.asarray(j_geom.point_to_ray_distance(jnp.asarray(pts), jnp.asarray(org), rj))
    dt = t_geom.point_to_ray_distance(_t(pts), _t(org), _t(rj)).numpy()
    np.testing.assert_allclose(dt, dj, atol=F32_TOL * 10)   # lengths ~5 m


def test_quaternion_functions_match_jax():
    rng = np.random.RandomState(1)
    q = rng.randn(6, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.randn(6, 4).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    es = rng.uniform(-1.5, 1.5, (6, 3)).astype(np.float32)
    w = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    w[0] = 0.0                                            # the zero-rotation branch
    ang = rng.uniform(-3, 3, 6).astype(np.float32)
    axis = rng.randn(6, 3).astype(np.float32)
    a = rng.uniform(0, 1, 6).astype(np.float32)
    cases = [
        (j_quat.to_matrix(jnp.asarray(q)), t_quat.to_matrix(_t(q))),
        (j_quat.from_angle_axis(jnp.asarray(ang), jnp.asarray(axis)),
         t_quat.from_angle_axis(_t(ang), _t(axis))),
        (j_quat.exp(jnp.asarray(w)), t_quat.exp(_t(w))),
        (j_quat.log(jnp.asarray(q)), t_quat.log(_t(q))),
        (j_quat.slerp(jnp.asarray(q), jnp.asarray(q2), jnp.asarray(a)),
         t_quat.slerp(_t(q), _t(q2), _t(a))),
        (j_quat.slerp(jnp.asarray(q), jnp.asarray(q), 0.3), t_quat.slerp(_t(q), _t(q), 0.3)),
    ]
    for order in ("xyz", "zyx"):
        for world in (False, True):
            cases.append((j_quat.from_euler(jnp.asarray(es), order, world),
                          t_quat.from_euler(_t(es), order, world)))
    for j, t in cases:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=F32_TOL)
    aj, xj = j_quat.to_angle_axis(jnp.asarray(q))
    at, xt = t_quat.to_angle_axis(_t(q))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=F32_TOL * 4)  # acos near 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=F32_TOL * 4)
    # the eigen-average: eigenvectors are defined up to sign
    qs = q[:1] + 0.05 * rng.randn(5, 4).astype(np.float32)
    vj = np.asarray(j_quat.average(jnp.asarray(qs)))
    vt = t_quat.average(_t(qs)).numpy()
    np.testing.assert_allclose(vt * np.sign(vt @ vj), vj, atol=1e-5)


# ---------------------------------------------------------------------------
# association: associate_frame and the alternate matchers
# ---------------------------------------------------------------------------

# drop_prob 0: every frame's ALS stops by the stable rule at settled
# groups in both packages (with dropped detections, seed 2 stops JAX's
# Cholesky ALS at iteration 60 on another grouping than the port's
# Gauss-Jordan ALS at 83, 0.019 from 0.5)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_associate_frame_matches_jax(seed):
    cfg = JConfig(n_views=4, max_people=4)
    seq = synthetic_sequence(n_frames=1, n_people=3, n_views=4, cfg=cfg, seed=seed,
                             drop_prob=0.0)
    jg = j_assoc.associate_frame(seq.batch.kps[0], seq.batch.valid[0], seq.cameras)
    tg = t_assoc.associate_frame(seq.batch.kps[0], seq.batch.valid[0],
                                 _port_cams(seq.cameras), device="cpu")
    assert tg == jg and len(tg) == 3


def _make_similarity(groups, sizes, hi=0.9, lo=0.05, seed=0):
    """tests/test_alt_matchers.py's scene generator."""
    rng = np.random.RandomState(seed)
    n = len(groups)
    W = np.zeros((n, n), dtype=np.float32)
    cam_of = np.concatenate([[c] * s for c, s in enumerate(sizes)])
    for i in range(n):
        for j in range(n):
            if i == j or cam_of[i] == cam_of[j]:
                continue
            base = hi if groups[i] == groups[j] else lo
            W[i, j] = np.clip(base + rng.uniform(-0.04, 0.04), 0, 1)
    return 0.5 * (W + W.T)


SIZES = (3, 3, 2, 3)
GROUPS = [0, 1, 2, 1, 0, 2, 0, 1, 2, 0, 1]


@pytest.mark.parametrize("seed", [0, 1])
def test_match_svt_matches_jax(seed):
    """x_bin and the iteration count equal (the SVD is LAPACK's in both on
    the CPU, through another wrapper)."""
    W = _make_similarity(GROUPS, SIZES, seed=seed)
    mask = j_assoc.block_diag_mask(SIZES)
    xj, ij = j_alt.match_svt(jnp.asarray(W), jnp.asarray(mask), SIZES)
    xt, it = t_alt.match_svt(_t(W), torch.as_tensor(mask), SIZES)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert int(it) == int(ij)
    xj, ij = j_alt.match_svt(jnp.asarray(W), jnp.asarray(mask), SIZES, dual_stochastic=False)
    xt, it = t_alt.match_svt(_t(W), torch.as_tensor(mask), SIZES, dual_stochastic=False)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert int(it) == int(ij)


def test_projections_and_host_matchers_match_jax():
    rng = np.random.RandomState(0)
    X = (rng.rand(6, 6) * 2).astype(np.float32)
    np.testing.assert_allclose(t_alt.doubly_stochastic_projection(_t(X)).numpy(),
                               np.asarray(j_alt.doubly_stochastic_projection(jnp.asarray(X))),
                               atol=F32_TOL)
    np.testing.assert_allclose(t_alt._project_rows_to_pav(_t(X - 0.5)).numpy(),
                               np.asarray(j_alt._project_rows_to_pav(jnp.asarray(X - 0.5))),
                               atol=F32_TOL)
    W = _make_similarity(GROUPS, SIZES)
    np.testing.assert_array_equal(t_alt.match_eig_np(W, SIZES), j_alt.match_eig_np(W, SIZES))
    np.testing.assert_array_equal(t_alt.match_bip(W), j_alt.match_bip(W))


def test_greedy_and_ray_association_match_jax():
    cfg = JConfig(n_views=4, max_people=6)
    seq = synthetic_sequence(n_frames=1, n_people=3, n_views=4, cfg=cfg, drop_prob=0.0, seed=2)
    F_det = j_cameras.pairwise_fundamental_det_np(np.asarray(seq.cameras.P))
    for thr in (50.0, 200.0):
        jg = j_greedy.match_greedy(seq.batch.kps[0], seq.batch.valid[0], F_det, thr)
        tg = t_greedy.match_greedy(seq.batch.kps[0], seq.batch.valid[0], F_det, thr)
        assert [(g.views, g.dets) for g in tg] == [(g.views, g.dets) for g in jg]
    assert sum(len(g.views) == 4 for g in tg) == 3

    cams = j_cameras.synthetic_camera_ring(3)
    rng = np.random.RandomState(3)
    pts = rng.uniform(-0.5, 0.5, (3, 5, 3)) + np.array([0, 0, 1.2])
    P0 = np.asarray(cams.P[0], dtype=np.float64)
    h = np.concatenate([pts[[2, 0]], np.ones((2, 5, 1))], -1) @ P0.T
    det = np.concatenate([h[..., :2] / h[..., 2:3], np.ones((2, 5, 1))], -1)
    args = (pts, np.ones((3, 5)), det, np.asarray(cams.Kr_inv[0]), np.asarray(cams.cam_loc[0]))
    for dst in (0.05, 10.0):
        tm = t_greedy.tracklet_ray_association(*args, max_dst=dst)
        assert tm == j_greedy.tracklet_ray_association(*args, max_dst=dst)
    assert sorted(t_greedy.tracklet_ray_association(*args, max_dst=0.05)) == [(0, 1), (2, 0)]


# ---------------------------------------------------------------------------
# generic FK and BVH files
# ---------------------------------------------------------------------------

def test_fk_generic_matches_jax():
    rng = np.random.RandomState(4)
    parents = [-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 8]
    offsets = rng.uniform(-0.3, 0.3, (11, 3)).astype(np.float32)
    root = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    eul = rng.uniform(-1, 1, (5, 11, 3)).astype(np.float32)
    js = j_fkg.cmu_like_skeleton(offsets, parents)
    ts = t_fkg.cmu_like_skeleton(offsets, parents, device="cpu")
    assert ts.levels == js.levels
    np.testing.assert_array_equal(ts.parents, js.parents)
    pj = np.asarray(j_fkg.forward_kinematics_generic(js, jnp.asarray(root), jnp.asarray(eul)))
    pt = t_fkg.forward_kinematics_generic(ts, _t(root), _t(eul)).numpy()
    np.testing.assert_allclose(pt, pj, atol=1e-5)              # lengths ~1 m, depth 4
    off_f = rng.uniform(-0.3, 0.3, (5, 11, 3)).astype(np.float32)
    pj = np.asarray(j_fkg.forward_kinematics_generic(js, jnp.asarray(root), jnp.asarray(eul),
                                                     jnp.asarray(off_f)))
    pt = t_fkg.forward_kinematics_generic(ts, _t(root), _t(eul), _t(off_f)).numpy()
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    with pytest.raises(ValueError, match="topologically"):
        t_fkg.GenericSkeleton.build([-1, 2, 0], np.zeros((3, 3)), device="cpu")


def test_bvh_files_match_jax_and_replay(tmp_path):
    """The writer's text equals JAX's byte for byte; either reader reads
    either file alike; the replay equals JAX's within 1e-3 cm (f32 at
    ~100 cm) and reproduces the written motion."""
    from multiview_motion_capture_torch.ops.fk import REF_SIDE_BONE_LENS

    rng = np.random.RandomState(0)
    F = 5
    roots = rng.uniform(-1, 1, (F, 3))
    eulers = rng.uniform(-0.8, 0.8, (F, 18, 3))
    side = np.asarray(REF_SIDE_BONE_LENS) * rng.uniform(0.9, 1.1, (F, 11))
    t_bvh.write_bvh(tmp_path / "t.bvh", roots, eulers, side, frame_time=0.04)
    j_bvh.write_bvh(tmp_path / "j.bvh", roots, eulers, side, frame_time=0.04)
    assert (tmp_path / "t.bvh").read_text() == (tmp_path / "j.bvh").read_text()
    td, jd = t_bvh.read_bvh(tmp_path / "t.bvh"), j_bvh.read_bvh(tmp_path / "t.bvh")
    assert td.names == jd.names and td.frame_time == jd.frame_time == 0.04
    for f in ("parents", "offsets", "roots", "eulers"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    np.testing.assert_allclose(td.roots / 100.0, roots, atol=1e-3)
    np.testing.assert_allclose(td.eulers, eulers, atol=1e-4)
    pt = t_fkg.animate_bvh(td, device="cpu").numpy()
    pj = np.asarray(j_fkg.animate_bvh(jd))
    np.testing.assert_allclose(pt, pj, atol=1e-3)
    tl = Tracklet(track_id=3, frame_idxs=list(range(F)), roots=roots, eulers=eulers,
                  side_lens=side, poses_3d=np.zeros((F, 18, 3)), poses_score=np.ones((F, 18)),
                  matched_pose=np.zeros((F, 4), np.int32))
    t_bvh.export_tracklet_bvh(tmp_path / "e.bvh", tl, frame_time=0.04)
    assert (tmp_path / "e.bvh").read_text() == (tmp_path / "t.bvh").read_text()


# ---------------------------------------------------------------------------
# host tools
# ---------------------------------------------------------------------------

def test_native_counterparts_match_jax(tmp_path):
    """Against the JAX package's C++ runtime where it builds; without it
    the JAX module runs scipy's Hungarian (only the optimum comparable) and
    no JSON parser (the file's own numbers are the reference)."""
    assert t_native.native_available() is False
    built = j_native.native_available()
    rng = np.random.RandomState(5)
    for shape in ((4, 4), (3, 6), (6, 3)):
        cost = rng.randint(0, 4, shape).astype(np.float64)     # many ties
        r1, c1 = t_native.hungarian(cost)
        r2, c2 = j_native.hungarian(cost)
        if built:
            np.testing.assert_array_equal(r1, r2)
            np.testing.assert_array_equal(c1, c2)
        assert cost[r1, c1].sum() == cost[r2, c2].sum()
    x = rng.rand(12, 12) < 0.15
    valid = rng.rand(12) < 0.8
    for a, b in zip(t_native.extract_groups_host(x, valid), j_native.extract_groups_host(x, valid)):
        np.testing.assert_array_equal(a, b)
    kps = (rng.rand(3, 25, 3) * [640, 480, 1]).astype(np.float32)
    path = tmp_path / "0_000000000000_keypoints.json"
    path.write_text(json.dumps({"people": [{"pose_keypoints_2d": k.ravel().tolist()}
                                           for k in kps]}))
    for cap in (32, 2):
        got = t_native.parse_openpose_file(path, max_people=cap)
        ref = j_native.parse_openpose_file(path, max_people=cap) if built else kps[:cap]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(FileNotFoundError):
        t_native.parse_openpose_file(tmp_path / "missing.json")


def test_ref_compat_loads_both_schemas_as_jax(tmp_path, monkeypatch):
    """A pickle of the reference's own classes (a module neither package
    can import) in the current schema and the golden file's, read by
    stand-ins in both packages alike."""
    import sys
    import types

    ref_mod = types.ModuleType("reference_only")
    for name in ("MvTracklet", "PoseShapeParam", "Pose"):
        cls = type(name, (), {"__module__": "reference_only"})
        setattr(ref_mod, name, cls)
    rng = np.random.RandomState(6)

    def entry():
        pp, pose = ref_mod.PoseShapeParam(), ref_mod.Pose()
        pp.root, pp.euler_angles, pp.bone_lens = rng.rand(3), rng.rand(18, 3), rng.rand(11)
        pose.keypoints = rng.rand(18, 3)
        return pp, pose

    a, b = ref_mod.MvTracklet(), ref_mod.MvTracklet()
    a.frame_idxs, a.poses = [3, 4], [(3,) + entry(), (4,) + entry()]   # current schema
    b.frame_idxs, b.poses = [7, 9, 10], [entry(), entry(), entry()]   # golden-file schema
    path = tmp_path / "ref.pkl"
    monkeypatch.setitem(sys.modules, "reference_only", ref_mod)
    path.write_bytes(pickle.dumps({"tracklets": [a, b]}))
    monkeypatch.delitem(sys.modules, "reference_only")
    got, ref = t_ref.load_reference_tracklets(path), j_ref.load_reference_tracklets(path)
    assert [t.frame_idxs for t in got] == [[3, 4], [7, 9, 10]]
    for x, y in zip(got, ref):
        assert len(x) == len(y) and x.frame_idxs == y.frame_idxs
        for f in ("roots", "euler_angles", "bone_lens", "poses_3d"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_tools_match_jax(tmp_path):
    calib = tmp_path / "cam0.json"
    calib.write_text(json.dumps({"K": [1000, 0, 500, 0, 1000, 400, 0, 0, 1],
                                 "RT": list(range(12)), "imgSize": [1000, 800]}))
    t = t_tools.convert_calib_json_to_yaml(calib, tmp_path / "t.yml")
    j = j_tools.convert_calib_json_to_yaml(calib, tmp_path / "j.yml")
    assert t.read_text() == j.read_text() and "imgSize" in t.read_text()
    frames = tmp_path / "frames"
    frames.mkdir()
    with pytest.raises(FileNotFoundError):
        t_tools.images_to_video(frames, tmp_path / "v.gif")
    import imageio.v2 as imageio

    rng = np.random.RandomState(7)
    for i in range(3):
        imageio.imwrite(frames / f"{i:03d}.png", rng.randint(0, 255, (8, 8, 3), np.uint8))
    t_tools.images_to_video(frames, tmp_path / "t.gif", pattern="*.png")
    j_tools.images_to_video(frames, tmp_path / "j.gif", pattern="*.png")
    assert (tmp_path / "t.gif").read_bytes() == (tmp_path / "j.gif").read_bytes()


# ---------------------------------------------------------------------------
# drawing
# ---------------------------------------------------------------------------

def _viz_tracklets(n_frames=3):
    rng = np.random.RandomState(8)
    out = []
    for tid in (0, 5):
        base = np.array([0.5 * tid - 1.0, 0.0, 1.0])
        out.append(Tracklet(track_id=tid, frame_idxs=list(range(tid % 2, tid % 2 + n_frames)),
                            roots=np.zeros((n_frames, 3)), eulers=np.zeros((n_frames, 18, 3)),
                            side_lens=np.zeros((n_frames, 11)),
                            poses_3d=base + 0.3 * rng.randn(n_frames, 18, 3),
                            poses_score=np.ones((n_frames, 18)),
                            matched_pose=np.zeros((n_frames, 4), np.int32)))
    return out


def test_viz_images_pixel_equal_to_jax(tmp_path):
    import imageio.v2 as imageio

    rng = np.random.RandomState(9)
    assert [t_viz.track_color(i) for i in range(8)] == [j_viz.track_color(i) for i in range(8)]
    img = rng.randint(0, 255, (120, 160, 3), np.uint8)
    kps = np.concatenate([rng.uniform(10, 150, (17, 2)), rng.uniform(0, 1, (17, 1))], 1)
    np.testing.assert_array_equal(t_viz.draw_pose_2d(img.copy(), kps),
                                  j_viz.draw_pose_2d(img.copy(), kps))
    strip_t = t_viz.draw_crop_strip([img, img[::-1].copy()], [kps, kps], crop_height=64,
                                    labels=["a", "b"])
    strip_j = j_viz.draw_crop_strip([img, img[::-1].copy()], [kps, kps], crop_height=64,
                                    labels=["a", "b"])
    np.testing.assert_array_equal(strip_t, strip_j)
    F = np.asarray(j_cameras.pairwise_fundamental_np(
        np.asarray(j_cameras.synthetic_camera_ring(2).K),
        np.asarray(j_cameras.synthetic_camera_ring(2).Rt)))[0, 1]
    for a, b in zip(t_viz.draw_epipolar_lines(img.copy(), img.copy(), kps, F),
                    j_viz.draw_epipolar_lines(img.copy(), img.copy(), kps, F)):
        np.testing.assert_array_equal(a, b)

    jcams = j_cameras.synthetic_camera_ring(4)
    tl = _viz_tracklets()
    out_t = t_viz.render_tracklets_video(tl, _port_cams(jcams), tmp_path / "t.gif",
                                         img_wh=(320, 240), thumb_w=160)
    out_j = j_viz.render_tracklets_video(tl, jcams, tmp_path / "j.gif", img_wh=(320, 240),
                                         thumb_w=160)
    ft, fj = imageio.mimread(out_t), imageio.mimread(out_j)
    assert len(ft) == len(fj) == 4
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a, b)
    pt = t_viz.plot_tracklets_3d(tl, tmp_path / "t.png")
    pj = j_viz.plot_tracklets_3d(tl, tmp_path / "j.png")
    np.testing.assert_array_equal(imageio.imread(pt), imageio.imread(pj))
    at = t_viz.animate_tracklets_3d(tl, tmp_path / "t3d.gif", fps=4)
    aj = j_viz.animate_tracklets_3d(tl, tmp_path / "j3d.gif", fps=4)
    for a, b in zip(imageio.mimread(at), imageio.mimread(aj)):
        np.testing.assert_array_equal(a, b)


def test_viz_imports_without_drawing_packages(monkeypatch):
    """The module imports where cv2 is missing; a drawing call then raises
    the ImportError that names it."""
    import importlib
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    mod = importlib.reload(t_viz)
    try:
        assert mod.track_color(1) == j_viz.track_color(1)
        with pytest.raises(ImportError, match="cv2"):
            mod.draw_pose_2d(np.zeros((8, 8, 3), np.uint8), np.zeros((17, 3)))
    finally:
        monkeypatch.undo()
        importlib.reload(t_viz)


# ---------------------------------------------------------------------------
# stage timing
# ---------------------------------------------------------------------------

def test_stage_timer_and_device_trace(tmp_path):
    timer = t_prof.StageTimer(device="cpu")
    for _ in range(2):
        with timer.stage("a"):
            torch.ones(4).sum()
    with timer.stage("b"):
        pass
    assert timer.counts() == {"a": 2, "b": 1}
    assert set(timer.summary()) == {"a", "b"} and all(v >= 0 for v in timer.summary().values())
    from multiview_motion_capture_torch.utils import StageTimer

    assert StageTimer is t_prof.StageTimer
    with t_prof.device_trace(None):
        pass
    with t_prof.device_trace(str(tmp_path / "trace"), device="cpu"):
        torch.ones(8).cumsum(0)
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())
