"""The port's detection path against the JAX package's, on the CPU: the
shipped checkpoints, the renderer, the three detectors,
`frames_to_frame_batch`, the appearance descriptor and head, and the
shipped checkpoint's end-to-end scene through `pipeline.run`.

Tolerances.  In f32 compute the port must reproduce JAX's decisions
exactly (valid slots, center pixels, boxes) and its keypoints within
F32_KPS_TOL_PX (measured: 6e-5 px on the detect scene).  In the shipped
bf16 compute, XLA and PyTorch round each convolution's bf16 sums at other
places; the heat then differs by ~0.02 (keypoint and center channels) and
that flips the decode's discrete choices where two candidates are within
the noise: a center between two near-equal pixels (one heatmap pixel, 4
frame px), a keypoint snapped or regressed at snap_min (up to the snap
window and the regression's error: 27 px once on the 60-frame detect
scene).  So bf16 holds valid slots equal, centers within one heatmap
pixel and the 90th percentile of the keypoint differences at equal
centers within `chip_smoke.DETECT_BF16_KPS_P90_TOL_PX` (0.25 px; measured
0.03-0.04 px), which a systematic fault exceeds.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from examples.torch_e2e_fullframe import scaled_cameras as torch_scaled_cameras  # noqa: E402
from multiview_motion_capture_torch.config import PipelineConfig as TConfig  # noqa: E402
from multiview_motion_capture_torch.data import detect as t_detect  # noqa: E402
from multiview_motion_capture_torch.data import detect_train as t_train  # noqa: E402
from multiview_motion_capture_torch.data import render as t_render  # noqa: E402
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth  # noqa: E402
from multiview_motion_capture_torch.models import appearance_net as t_app  # noqa: E402
from multiview_motion_capture_torch.models import checkpoint as t_ckpt  # noqa: E402
from multiview_motion_capture_torch.models.pose_net import PoseNet as TPoseNet  # noqa: E402
from multiview_motion_capture_torch.models.pose_net import (  # noqa: E402
    PoseNetConfig as TPoseNetConfig,
)
from multiview_motion_capture_tpu.config import PipelineConfig as JConfig  # noqa: E402
from multiview_motion_capture_tpu.data import detect as j_detect  # noqa: E402
from multiview_motion_capture_tpu.data import detect_train as j_train  # noqa: E402
from multiview_motion_capture_tpu.data import render as j_render  # noqa: E402
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth  # noqa: E402
from multiview_motion_capture_tpu.models import appearance_net as j_app  # noqa: E402
from multiview_motion_capture_tpu.models import checkpoint as j_ckpt  # noqa: E402
from tests.torch_study_scene import one_thread  # noqa: E402

CKPT = chip_smoke.CHECKPOINTS
F32_KPS_TOL_PX = 1e-3
SCENE = dict(n_frames=2, n_people=4, n_views=3, seed=1, noise_px=0.0, drop_prob=0.0,
             min_person_distance=1.2)
CFG = dict(n_views=3, max_people=8, max_tracks=12, max_frames=None)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def shipped():
    """Both packages' shipped PoseNet and head (the port's on the CPU), and
    each package's net in f32 compute."""
    jm, jp = j_ckpt.load_posenet(CKPT / "posenet_synth.npz")
    jh = j_ckpt.load_appearance_head(CKPT / "appearance_head.npz")
    tm, tn = t_ckpt.load_posenet(CKPT / "posenet_synth.npz", device="cpu")
    _, th = t_ckpt.load_appearance_head(CKPT / "appearance_head.npz", device="cpu")
    tm32 = dataclasses.replace(tm, compute_dtype=torch.float32)
    tn32 = TPoseNet(tm32).eval()
    tn32.load_state_dict(tn.state_dict())
    return dict(jax={"bfloat16": jm, "float32": dataclasses.replace(jm, compute_dtype=jnp.float32)},
                params=jp, jhead=jh, port={"bfloat16": (tm, tn), "float32": (tm32, tn32)},
                thead=th)


@pytest.fixture(scope="module")
def frames():
    """The detect scene's first 2 frames in 3 views (f32 in [0, 1])."""
    seq = t_synth(cfg=TConfig(**CFG), **SCENE)
    r = chip_smoke.DETECT_RENDER
    return t_train.render_sequence(seq, t_render.RenderConfig(hw=r["hw"]),
                                   world_scale=r["world_scale"], seed=r["seed"],
                                   person_tints=chip_smoke.person_tints(SCENE["n_people"]))


def test_shipped_checkpoints_equal_jax(shipped):
    jm, tm = shipped["jax"]["bfloat16"], shipped["port"]["bfloat16"][0]
    for f in dataclasses.fields(tm):
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if f.name == "compute_dtype":
            assert str(a) == "torch.bfloat16" and jnp.dtype(b).name == "bfloat16"
        else:
            assert a == b, f.name
    assert tm.predict_center and tm.predict_offsets and tm.n_out == 52
    net = shipped["port"]["bfloat16"][1]
    assert sum(p.numel() for p in net.parameters()) == 3_575_668
    # every leaf as the JAX package loads it, carried across by the converters
    _assert_modules_equal(net, t_ckpt.posenet_from_flax(tm, _numpy(shipped["params"])))
    _assert_modules_equal(shipped["thead"],
                          t_ckpt.head_from_flax(shipped["thead"].cfg, _numpy(shipped["jhead"][1])))
    assert shipped["thead"].cfg == t_app.AppearanceHeadConfig(**dataclasses.asdict(
        shipped["jhead"][0]))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_modules_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == torch.float32 and torch.equal(sa[k], sb[k]), k


def _assert_trees_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(_numpy(a))[0]
    fb = jax.tree_util.tree_flatten_with_path(_numpy(b))[0]
    assert [jax.tree_util.keystr(k) for k, _ in fa] == [jax.tree_util.keystr(k) for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert np.array_equal(x, y), k


@pytest.mark.parametrize("direction", ["port_writes", "jax_writes"])
def test_checkpoint_round_trip(tmp_path, direction):
    """Files either package writes load in the other, weights stored as f16
    coming back as the same f32 values, configs equal."""
    from multiview_motion_capture_tpu.models.pose_net import PoseNet as JPoseNet
    from multiview_motion_capture_tpu.models.pose_net import PoseNetConfig as JPoseNetConfig

    small = dict(img_hw=(64, 48), stage_features=(64, 64, 128), blocks_per_stage=1,
                 head_features=64, predict_center=True, predict_offsets=True)
    jcfg = JPoseNetConfig(**small)
    params = JPoseNet(jcfg).init(jax.random.PRNGKey(4), jnp.zeros((1, 64, 48, 3)))["params"]
    hcfg = j_app.AppearanceHeadConfig(in_dim=51, hidden=(32,), out_dim=8)
    hparams = j_app.init_head(jax.random.PRNGKey(5), hcfg)
    p, h = tmp_path / "posenet.npz", tmp_path / "head.npz"
    if direction == "port_writes":
        net = t_ckpt.posenet_from_flax(TPoseNetConfig(compute_dtype=torch.bfloat16, **small),
                                       jax.tree_util.tree_map(np.asarray, params))
        t_ckpt.save_posenet(p, net.cfg, net, dtype=np.float16)
        head = t_ckpt.head_from_flax(t_app.AppearanceHeadConfig(51, (32,), 8),
                                     jax.tree_util.tree_map(np.asarray, hparams))
        t_ckpt.save_appearance_head(h, head.cfg, head)
    else:
        j_ckpt.save_posenet(p, jcfg, params, dtype=np.float16)
        j_ckpt.save_appearance_head(h, hcfg, hparams)
    jc, jp = j_ckpt.load_posenet(p)
    tc, tn = t_ckpt.load_posenet(p, device="cpu")
    assert jc == jcfg and str(tc.compute_dtype) == "torch.bfloat16"
    assert all(getattr(tc, f.name) == getattr(jc, f.name) for f in dataclasses.fields(tc)
               if f.name != "compute_dtype")
    _assert_modules_equal(tn, t_ckpt.posenet_from_flax(tc, _numpy(jp)))
    f16 = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(np.float16).astype(np.float32),
                                 params)
    _assert_trees_equal(jp, f16)
    jhc, jhp = j_ckpt.load_appearance_head(h)
    thc, th = t_ckpt.load_appearance_head(h, device="cpu")
    assert dataclasses.asdict(jhc) == dataclasses.asdict(thc)
    _assert_modules_equal(th, t_ckpt.head_from_flax(thc, _numpy(jhp)))
    _assert_trees_equal(jhp, hparams)


def test_render_matches_jax():
    """Same seed, same pixels: a tinted sequence and a scene with its
    visibility."""
    kw = dict(n_frames=2, n_people=3, n_views=2, seed=3, noise_px=0.0, drop_prob=0.0)
    ts, js = t_synth(cfg=TConfig(n_views=2, max_frames=None), **kw), j_synth(
        cfg=JConfig(n_views=2, max_frames=None), **kw)
    tints = chip_smoke.person_tints(3)
    a = t_train.render_sequence(ts, t_render.RenderConfig(hw=(96, 128)), seed=7,
                                person_tints=tints)
    b = j_train.render_sequence(js, j_render.RenderConfig(hw=(96, 128)), seed=7,
                                person_tints=tints)
    assert a.shape == (2, 2, 96, 128, 3) and np.array_equal(a, b)
    kps = ts.batch.kps[0, 0, :, :, :2] * 0.25
    pres = ts.batch.valid[0, 0]
    ia, va = t_render.render_scene(kps, pres, None, np.random.RandomState(1),
                                   t_render.RenderConfig(hw=(96, 128)), return_visibility=True)
    ib, vb = j_render.render_scene(kps, pres, None, np.random.RandomState(1),
                                   j_render.RenderConfig(hw=(96, 128)), return_visibility=True)
    assert np.array_equal(ia, ib) and np.array_equal(va, vb) and va.any()


def _compare_bottom_up(jo, to, dtype):
    cmp = chip_smoke.compare_detections([o[:3] for o in jo], [o[:3] for o in to])
    assert cmp["valid_equal"] == cmp["images"], cmp
    if dtype == "float32":
        assert cmp["centers_equal"] == cmp["images"], cmp
        assert cmp["max_kps_diff_px"] <= F32_KPS_TOL_PX, cmp
        for a, b in zip(jo, to):
            assert np.array_equal(a[1][..., :2], b[1][..., :2])
            np.testing.assert_allclose(b[3], a[3], atol=1e-4, rtol=0)
    else:
        assert cmp["max_center_shift_px"] <= 4.0, cmp
        assert cmp["p90_kps_diff_px"] <= chip_smoke.DETECT_BF16_KPS_P90_TOL_PX, cmp
    return cmp


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bottom_up_detector_matches_jax(shipped, frames, dtype):
    """The shipped bottom-up detector with appearance and the head on 2
    rendered frames x 3 views."""
    kw = dict(chip_smoke.DETECTOR)
    jd = j_detect.make_bottom_up_detector(shipped["jax"][dtype], appearance_head=shipped["jhead"],
                                          **kw)
    tm, tn = shipped["port"][dtype]
    td = t_detect.make_bottom_up_detector(tm, appearance_head=shipped["thead"], **kw)
    jo = [[np.asarray(a) for a in jd(shipped["params"], jnp.asarray(f))] for f in frames]
    to = [[a.numpy() for a in td(tn, torch.as_tensor(f))] for f in frames]
    assert to[0][3].shape == (3, 8, 32)
    cmp = _compare_bottom_up(jo, to, dtype)
    assert sum(int(o[2].sum()) for o in to) >= 20       # of the 4 people in 6 images


def test_bottom_up_detector_resizes_a_uint8_shelf_frame(shipped):
    """One uint8 frame at Shelf's 776 x 1032 in 2 views: the antialiased
    resize to the net's 192 x 256 equals jax.image.resize, and the
    detections equal JAX's (f32 compute: exact centers)."""
    seq = t_synth(cfg=TConfig(n_views=2, max_frames=None), n_frames=1, n_people=3, n_views=2,
                  seed=2, noise_px=0.0, drop_prob=0.0, min_person_distance=1.2)
    big = t_train.render_sequence(seq, t_render.RenderConfig(hw=(776, 1032), limb_sigma=6.4,
                                                             joint_sigma=8.0),
                                  world_scale=1.0, seed=3)[0]
    u8 = chip_smoke.to_uint8(big)
    x = u8.astype(np.float32) * np.float32(1 / 255)
    small = jax.image.resize(jnp.asarray(x), (2, 192, 256, 3), method="linear")
    ours = t_detect.resize(torch.as_tensor(x), (192, 256))
    np.testing.assert_allclose(ours.numpy(), np.asarray(small), atol=1e-5, rtol=0)
    kw = dict(chip_smoke.DETECTOR)
    jd = j_detect.make_bottom_up_detector(shipped["jax"]["float32"],
                                          appearance_head=shipped["jhead"], **kw)
    tm, tn = shipped["port"]["float32"]
    td = t_detect.make_bottom_up_detector(tm, appearance_head=shipped["thead"], **kw)
    jo = [np.asarray(a) for a in jd(shipped["params"], jnp.asarray(u8))]
    to = [a.numpy() for a in td(tn, torch.as_tensor(u8))]
    assert to[0][..., :2].max() > 300                    # frame pixels of the big frame
    cmp = _compare_bottom_up([jo], [to], "float32")
    assert cmp["valid_equal"] == 2 and int(to[2].sum()) >= 4


@pytest.mark.parametrize("case", ["downsample", "upsample"])
def test_resize_matches_jax(case):
    src, dst = ((776, 1032), (192, 256)) if case == "downsample" else ((128, 96), (192, 256))
    x = np.random.RandomState(0).rand(2, *src, 3).astype(np.float32)
    ours = t_detect.resize(torch.as_tensor(x), dst).numpy()
    theirs = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + dst + (3,), method="linear"))
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


def test_crop_windows_matches_jax():
    img = np.arange(40 * 60 * 3, dtype=np.float32).reshape(40, 60, 3)
    centers = np.asarray([[30.0, 20.0], [0.0, 0.0], [59.0, 39.0], [10.4, 30.6]], np.float32)
    for out_hw in ((16, 24), (24, 32)):
        jc, jb = j_detect.crop_windows(jnp.asarray(img), jnp.asarray(centers), (16, 24), out_hw)
        tc, tb = t_detect.crop_windows(torch.as_tensor(img), torch.as_tensor(centers), (16, 24),
                                       out_hw)
        assert np.array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-3, rtol=0)
    # a batch of images crops as each alone
    tcb, tbb = t_detect.crop_windows(torch.as_tensor(np.stack([img, img[::-1].copy()])),
                                     torch.as_tensor(np.stack([centers, centers[::-1].copy()])),
                                     (16, 24), (16, 24))
    one = t_detect.crop_windows(torch.as_tensor(img[::-1].copy()),
                                torch.as_tensor(centers[::-1].copy()), (16, 24), (16, 24))
    assert torch.equal(tcb[1], one[0]) and torch.equal(tbb[1], one[1])
    assert np.array_equal(tcb[0, 0].numpy(), img[12:28, 18:42])


def test_crop_window_larger_than_image_raises():
    with pytest.raises(ValueError, match="exceeds the image"):
        t_detect.crop_windows(torch.zeros(40, 60, 3), torch.zeros(2, 2), (64, 48), (64, 48))


@pytest.fixture(scope="module")
def cascades(shipped, frames):
    """The cascade and the top-down detector on its boxes' crops (the
    `cascade` phase's run_cascade), f32 compute, both packages."""
    u8 = chip_smoke.to_uint8(frames)
    jc = chip_smoke.run_cascade(j_detect, shipped["jax"]["float32"], shipped["params"],
                                JConfig(**CFG), u8, np.asarray)
    tm, tn = shipped["port"]["float32"]
    tc = chip_smoke.run_cascade(t_detect, tm, tn, TConfig(**CFG), u8,
                                lambda a: a.cpu().numpy())
    return jc, tc


def test_cascade_matches_jax(cascades):
    """make_multi_person_detector (crop 128 x 96, upsampled to the net's
    192 x 256): valid slots and boxes exact, mean keypoints within
    F32_KPS_TOL_PX."""
    jc, tc = cascades
    assert tc["valid"] == jc["valid"] and sum(map(int, tc["valid"])) >= 20
    assert tc["boxes"] == jc["boxes"]
    np.testing.assert_allclose(tc["mean_xy"], jc["mean_xy"], atol=F32_KPS_TOL_PX + 1e-3)


def test_crops_to_frame_batch_matches_jax(cascades):
    """make_detector + crops_to_frame_batch on the cascade's boxes."""
    jc, tc = cascades
    assert tc["crop_valid"] == jc["crop_valid"]
    np.testing.assert_allclose(tc["crop_mean_xy"], jc["crop_mean_xy"],
                               atol=F32_KPS_TOL_PX + 1e-3)


def test_random_init_detector_needs_a_generator():
    cfg = TPoseNetConfig(img_hw=(64, 48), stage_features=(64, 64, 128), blocks_per_stage=1,
                         head_features=64)
    with pytest.raises(ValueError, match="torch.Generator"):
        t_detect.make_detector(cfg, device="cpu")
    detect, net = t_detect.make_detector(cfg, generator=torch.Generator().manual_seed(0),
                                         device="cpu")
    out = detect(net, torch.rand(2, 64, 48, 3))
    assert out.shape == (2, 17, 3) and torch.isfinite(out).all()
    _, again = t_detect.make_detector(cfg, generator=torch.Generator().manual_seed(0),
                                      device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(), again.parameters()))


@pytest.mark.parametrize("collect_appearance", [False, True])
def test_frames_to_frame_batch_matches_jax(shipped, frames, collect_appearance):
    kw = dict(chip_smoke.DETECTOR, return_appearance=collect_appearance)
    head = dict(appearance_head=None)
    jd = j_detect.make_bottom_up_detector(shipped["jax"]["float32"], **head, **kw)
    tm, tn = shipped["port"]["float32"]
    td = t_detect.make_bottom_up_detector(tm, **head, **kw)
    jr = j_detect.frames_to_frame_batch(jd, shipped["params"], frames, JConfig(**CFG),
                                        collect_appearance=collect_appearance)
    tr = t_detect.frames_to_frame_batch(td, tn, frames, TConfig(**CFG),
                                        collect_appearance=collect_appearance)
    jb, tb = (jr[0], tr[0]) if collect_appearance else (jr, tr)
    assert np.array_equal(tb.valid, jb.valid) and tb.kps.shape == jb.kps.shape
    np.testing.assert_allclose(tb.kps, jb.kps, atol=F32_KPS_TOL_PX, rtol=0)
    if collect_appearance:
        assert tr[1].shape == (2, 3, 8, 51)
        np.testing.assert_allclose(tr[1], jr[1], atol=1e-5, rtol=0)
    # the port's loop returns exactly its detector's own outputs
    for f in range(2):
        kps, _, valid = td(tn, frames[f])[:3]
        assert np.array_equal(tb.kps[f], kps.numpy()) and np.array_equal(tb.valid[f],
                                                                          valid.numpy())


def test_appearance_descriptor_and_head_match_jax():
    """appearance_from_keypoints (bilinear samples, clamped at the border,
    low-score keypoints and invalid slots zeroed) and apply_head (zero rows
    stay zero) on seeded inputs."""
    rng = np.random.RandomState(6)
    images = rng.rand(2, 40, 50, 3).astype(np.float32)
    kps = np.concatenate([rng.uniform(-3, 53, size=(2, 4, 17, 2)),
                          rng.uniform(0, 0.3, size=(2, 4, 17, 1))], -1).astype(np.float32)
    valid = np.asarray([[True, True, False, True], [False, True, True, True]])
    je = j_detect.appearance_from_keypoints(jnp.asarray(images), jnp.asarray(kps),
                                            jnp.asarray(valid))
    te = t_detect.appearance_from_keypoints(torch.as_tensor(images), torch.as_tensor(kps),
                                            torch.as_tensor(valid))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-6, rtol=0)
    assert not te[0, 2].any()
    one = t_detect._sample_bilinear(torch.as_tensor(images[1]), torch.as_tensor(kps[1, 0, :, :2]))
    np.testing.assert_allclose(one.numpy(), np.asarray(j_detect._sample_bilinear(
        jnp.asarray(images[1]), jnp.asarray(kps[1, 0, :, :2]))), atol=1e-6, rtol=0)
    hcfg = j_app.AppearanceHeadConfig()
    hp = j_app.init_head(jax.random.PRNGKey(1), hcfg)
    head = t_ckpt.head_from_flax(t_app.AppearanceHeadConfig(),
                                 jax.tree_util.tree_map(np.asarray, hp))
    jz = j_app.apply_head(hcfg, hp, je)
    with torch.no_grad():
        tz = t_app.apply_head(head, te)
    assert tz.shape == (2, 4, 32) and not tz[0, 2].any() and not tz[1, 0].any()
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-6, rtol=0)


def test_shipped_e2e_scene_tracks():
    """tests/test_shipped_checkpoint.py's end-to-end scene (8 frames, 2
    people, 4 views, rendered at 192 x 256) through the port on the CPU:
    the bf16 shipped detector, then pipeline.run in triangulation mode:
    2 long tracklets, MPJPE <= 3 cm, as the JAX package's gate; and held
    against the JAX package's own run: the same valid detections, the
    same tracklet lengths, MPJPE within 5 mm."""
    from multiview_motion_capture_torch import eval as t_eval
    from multiview_motion_capture_torch import pipeline as t_pipeline
    from multiview_motion_capture_tpu import eval as j_eval
    from multiview_motion_capture_tpu import pipeline as j_pipeline

    kw = dict(n_frames=8, n_people=2, n_views=4, noise_px=0.0, drop_prob=0.0, seed=123,
              min_person_distance=1.5)
    over = dict(n_views=4, max_people=4, max_tracks=6, max_frames=None)
    tcfg, jcfg = TConfig(**over), JConfig(**over)
    ts, js = t_synth(cfg=tcfg, **kw), j_synth(cfg=jcfg, **kw)
    images = t_train.render_sequence(ts, t_render.RenderConfig(hw=(192, 256)),
                                     world_scale=0.25, seed=9)
    tm, tn = t_ckpt.load_posenet(CKPT / "posenet_synth.npz", device="cpu")
    td = t_detect.make_bottom_up_detector(tm, max_people=4, center_min_score=0.2)
    tb = t_detect.frames_to_frame_batch(td, tn, images, tcfg)
    tres = t_pipeline.run(tb, torch_scaled_cameras(ts.cameras, 0.25), tcfg, use_ik=False,
                          device="cpu")
    t_long = [t for t in tres.tracklets if len(t) >= 6]
    assert len(t_long) == 2, [len(t) for t in tres.tracklets]
    t_mpjpe = t_eval.mpjpe_vs_ground_truth(t_long, ts.gt_3d)
    assert t_mpjpe <= 0.03, t_mpjpe

    from examples.e2e_fullframe import scaled_cameras

    jm, jp = j_ckpt.load_posenet(CKPT / "posenet_synth.npz")
    jd = j_detect.make_bottom_up_detector(jm, max_people=4, center_min_score=0.2)
    jb = j_detect.frames_to_frame_batch(jd, jp, images, jcfg)
    assert np.array_equal(tb.valid, jb.valid)
    jres = j_pipeline.run(jb, scaled_cameras(js.cameras, 0.25), jcfg, use_ik=False)
    j_long = [t for t in jres.tracklets if len(t) >= 6]
    assert sorted(map(len, tres.tracklets)) == sorted(map(len, jres.tracklets))
    assert abs(t_mpjpe - j_eval.mpjpe_vs_ground_truth(j_long, js.gt_3d)) <= 0.005
