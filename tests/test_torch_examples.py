"""The port's config-5 examples (`examples/torch_e2e_fullframe.py`,
`examples/torch_e2e_synthetic.py`) against the JAX examples on the CPU.

- The renderers and the scaled calibration equal the JAX examples' bit for
  bit (the same numpy code on the same inputs).
- `make_sample`'s images and targets, and the `wmse` loss on a small map,
  within TARGET_TOL of the JAX example's: JAX's training set and loss are read from its
  `main` itself.  `main` keeps them inside its training step, so the test
  runs it with `jax.jit` wrapped: the wrapper takes the step the example
  builds, runs it once on the test's indices, keeps what its closure holds
  and stops `main` there.  The JAX side computes in f32
  (`PoseNetConfig.compute_dtype`; the example's default is bf16, where
  XLA and PyTorch round the convolutions' bf16 sums at other places) and
  initialises its PoseNet under `jax.jit` (the same `model.init(PRNGKey
  (0))`, compiled at once instead of op by op).
- One Adam step from JAX's initial weights (carried over by
  `models/checkpoint.posenet_from_flax`) on the same indices, in f32.  The
  loss within STEP_LOSS_RTOL relative of the f64 loss of JAX's forward
  (JAX's jitted step reports it as XLA's CPU f32 means of ~1e5 terms, 1.3e-5
  relative off that value; the port's, 7e-8).  The gradients (JAX's read
  from its Adam first moment) within STEP_GRAD_TOL of each leaf's largest
  magnitude at a cosine of at least STEP_GRAD_COS: the renders' flat
  backgrounds make the forward's max-pool windows and ReLU inputs near
  ties, which rounding decides, so a gradient routes through another pixel
  in one package than in the other (measured: up to 4.6e-3 of a leaf's
  largest, in ['ResBlock_2']['Conv_0']['kernel']; moving the port's own
  images by one unit in the last place moves its gradients by up to 1.0e-3
  of a leaf's largest).  The parameters after the step within
  STEP_PARAM_TOL of JAX's wherever both gradients exceed GRAD_FIRM with one
  sign.  Adam's first step is lr g / (|g| + eps), about lr times the
  gradient's sign, so a weight whose small gradient rounding turns (922 of
  2,021,202, each below 1.5e-3 of its leaf's largest) lands up to 2 lr
  apart: at most STEP_OFF_SHARE of the weights may lie further apart than
  STEP_PARAM_TOL, and none further than 2 lr.
- The inference half of the full-frame example (`detect_and_track`)
  against JAX's `main` on the same weights, in f32: the port trains them
  (a short, cached training), and the test writes them where JAX's
  `main(cache=True)` looks for its trained checkpoint, so JAX's `main`
  loads them instead of training.  The weights need a detector that
  proposes mostly people: after 100 steps at a batch of 2 on 4 frames it
  proposed every slot, two of them junk in each view, and frame 0's ALS on
  that ambiguous problem settled in both packages (162 and 90 iterations)
  on other groupings even from the same detections (the ALS rounds such a
  problem either way, ROADMAP C); TRAIN on SCENE's 3 frames stays within
  the file's time on the CPU.  Each host trains its own weights (bf16 on
  its CPU), so the test holds each half on the same inputs:
  (a) the detections: valid detections equal, keypoints of the valid
  detections within KPS_TOL_PX, recall equal, the matched error within
  DET_ERR_TOL_PX, at least one valid detection in every image;
  (b) the port's tracker on JAX's own detections (`pipeline.run` on JAX's
  FrameBatch carried over field for field): tracklet lengths equal, the
  long tracklets as many and their MPJPE within MPJPE_TOL_M;
  (c) the port end to end: its tracklets equal JAX's (lengths, long
  tracklets, MPJPE), or the first frame whose decisions differ is split by
  a tie that rounding decides (`first_split`).  The detections differ by up
  to one f32 unit in the last place of a coordinate (3.05e-5 px at 256-512
  px); on one host's weights that moved one entry of frame 1's ALS, 0.0037
  from 0.5 in JAX and 0.084 on the port's side, while JAX's own X there
  moves by 0.236 (to 0.740) when JAX's detections move to the port's.  A
  split whose margin that reach does not cover fails.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch import eval as t_eval
from multiview_motion_capture_torch import pipeline as t_pipeline
from multiview_motion_capture_torch import tracker as TT
from multiview_motion_capture_torch.data import ingest as t_ingest
from multiview_motion_capture_torch.models import checkpoint as t_ckpt
from multiview_motion_capture_torch.models import pose_net as T
from multiview_motion_capture_torch.utils import testcache as t_cache
from multiview_motion_capture_tpu import pipeline as j_pipeline
from multiview_motion_capture_tpu import tracker as JT
from multiview_motion_capture_tpu.data import ingest as j_ingest
from multiview_motion_capture_tpu.data import detect as j_detect
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth
from multiview_motion_capture_tpu.models import pose_net as J
from multiview_motion_capture_tpu.utils import testcache as j_cache

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import examples.e2e_fullframe as j_full  # noqa: E402
import examples.e2e_synthetic as j_synth_ex  # noqa: E402
import examples.torch_e2e_fullframe as t_full  # noqa: E402
import examples.torch_e2e_synthetic as t_synth_ex  # noqa: E402

sys.path.insert(0, str(ROOT / "scripts"))
import torch_parity_study as parity  # noqa: E402
from tests.torch_study_scene import one_thread  # noqa: E402

TARGET_TOL = 1e-6
STEP_LOSS_RTOL = 1e-5
STEP_PARAM_TOL = 1e-6
STEP_GRAD_TOL = 1e-2        # of each leaf's largest magnitude (measured 4.6e-3)
STEP_GRAD_COS = 0.9999
GRAD_FIRM = 1e-4
STEP_OFF_SHARE = 1e-3       # of all weights (measured: 922 of 2,021,202)
JAX_MEAN_RTOL = 3e-5       # XLA's CPU f32 mean of ~1e5 terms (measured 1.3e-5)
KPS_TOL_PX = 0.01
DET_ERR_TOL_PX = 0.01
MPJPE_TOL_M = 0.005
SPLIT_DRAWS = 4             # +-DELTA moves of JAX's detections (first_split)
SCENE = dict(n_frames=3, n_people=2, n_views=4, seed=0)
# the weights the inference half runs on: the example's training at a
# batch of 4 full frames and 4 crops a step (the example's is 8 and 8)
TRAIN = dict(steps=120, batch=4)
CPU = torch.device("cpu")


J_CONFIG, J_NET = J.PoseNetConfig, J.PoseNet


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _f32_config(*args, **kwargs):
    return J_CONFIG(*args, **{**kwargs, "compute_dtype": jnp.float32})


class _JitInitPoseNet:
    """JAX's PoseNet with `init` compiled as one program."""

    def __init__(self, cfg):
        self.module = J_NET(cfg)

    def init(self, *args):
        return jax.jit(self.module.init)(*args)

    def apply(self, *args, **kwargs):
        return self.module.apply(*args, **kwargs)


class _Stop(Exception):
    pass


class _JaxWithJitCapture:
    """The `jax` module as the JAX example sees it, but `jax.jit(fn)`
    returns a function that runs the compiled `fn` once on the test's
    indices, records its inputs, outputs and closure, and stops `main`."""

    def __init__(self, idx_f, idx_c, record):
        self.idx, self.record = (idx_f, idx_c), record

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        def first_call(params, opt, *_):
            self.record["closure"] = {n: c.cell_contents for n, c in
                                      zip(fn.__code__.co_freevars, fn.__closure__)}
            self.record["params0"] = params
            self.record["params1"], self.record["opt1"], self.record["loss"] = jax.jit(fn)(
                params, opt, *map(jnp.asarray, self.idx))
            raise _Stop

        return first_call


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def scene():
    s = t_full.make_scene(**SCENE)
    return s, t_full.training_set(s, CPU)


@pytest.fixture(scope="module")
def jax_step(scene):
    """JAX's example up to its first training step, in f32."""
    _, sets = scene
    rng = np.random.RandomState(3)
    idx_f = rng.randint(0, sets["full_imgs"].shape[0], t_full.BATCH)
    idx_c = rng.randint(0, sets["crop_imgs"].shape[0], t_full.BATCH)
    record = {"idx_f": idx_f, "idx_c": idx_c}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "PoseNetConfig", _f32_config)
        mp.setattr(J, "PoseNet", _JitInitPoseNet)
        mp.setattr(j_full, "jax", _JaxWithJitCapture(idx_f, idx_c, record))
        with pytest.raises(_Stop):
            j_full.main(steps=1, cache=False, **SCENE)
    return record


def test_renderers_and_scaled_cameras_equal_jax():
    from multiview_motion_capture_torch.config import PipelineConfig as TConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_seq
    from multiview_motion_capture_tpu.config import PipelineConfig as JConfig

    rng = np.random.RandomState(0)
    colors = rng.uniform(0.3, 1.0, (17, 3))
    kps = rng.uniform(-20, 280, (3, 17, 2)).astype(np.float32)
    present = np.array([True, False, True])
    for hw, sigma in ((t_full.FRAME_HW, 2.0), ((388, 516), 3.0)):
        assert np.array_equal(t_full.render_frame(kps, present, colors, hw, sigma),
                              j_full.render_frame(kps, present, colors, hw, sigma))
    boxes = np.concatenate([kps.min(1) - 10, kps.max(1) + 10], axis=1)
    for a, b in zip(t_synth_ex.render_crops(kps, boxes, colors),
                    j_synth_ex.render_crops(kps, boxes, colors)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    kw = dict(n_frames=2, n_people=2, n_views=4, seed=0)
    tc = t_seq(cfg=TConfig(n_views=4), **kw).cameras
    jc = j_synth(cfg=JConfig(n_views=4), **kw).cameras
    for scale in (0.25, 0.5):
        t, j = t_full.scaled_cameras(tc, scale), j_full.scaled_cameras(jc, scale)
        for f in ("K", "Rt", "P", "Kr_inv", "cam_loc", "img_wh"):
            assert np.array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f))), f


def test_make_sample_and_wmse_match_jax(scene, jax_step):
    _, sets = scene
    got = jax_step["closure"]
    for key in ("full_imgs", "full_tgts", "crop_imgs", "crop_tgts"):
        ref = np.asarray(got[key])
        assert sets[key].shape == ref.shape, key
        assert np.abs(sets[key].numpy() - ref).max() <= TARGET_TOL, key
    # every target channel is used: 17 keypoints of a present person, the center
    assert (ref.max(axis=(0, 1, 2)) > 0.5).all()
    # JAX's wmse as the example runs it, compiled, on a map of 1,152 terms:
    # XLA's CPU mean of the step's ~1e5 terms is itself ~4e-6 relative off
    # the f64 value (the port's 1.5e-8), so at that size the port is held
    # to the f64 value of the formula
    rng = np.random.RandomState(1)
    for shape in ((1, 8, 8, 18), (8, 24, 32, 18)):
        h = rng.rand(*shape).astype(np.float32)
        t = rng.rand(*shape).astype(np.float32)
        port = float(t_full.wmse(torch.as_tensor(h), torch.as_tensor(t)))
        if shape[0] == 1:
            ref = float(jax.jit(got["wmse"])(jnp.asarray(h), jnp.asarray(t)))
            assert abs(port - ref) <= TARGET_TOL
        exact = np.mean((h.astype(np.float64) - t) ** 2 * (1.0 + 20.0 * t))
        assert abs(port - exact) <= TARGET_TOL * exact


def test_adam_step_matches_jax(scene, jax_step):
    """One Adam(2e-3) step of the two-size peak-weighted loss from JAX's
    initial weights, in f32, on the port's own training set."""
    _, sets = scene
    p0, idx_f, idx_c = jax_step["params0"], jax_step["idx_f"], jax_step["idx_c"]
    net = t_ckpt.posenet_from_flax(t_full.model_config(torch.float32), _numpy_tree(p0))
    loss = t_full.train_step(net, t_full.make_optimizer(net), sets,
                             torch.as_tensor(idx_f), torch.as_tensor(idx_c))
    # JAX's step reports the loss as XLA's CPU f32 means of ~1e5 terms,
    # ~1.3e-5 relative off the f64 means of its own forward's heat (the
    # port's f32 loss: 7e-8); so the port's loss is held to the f64 loss of
    # JAX's forward, and JAX's reported loss to that value within
    # JAX_MEAN_RTOL
    got, apply = jax_step["closure"], jax.jit(
        lambda p, x: jax_step["closure"]["model"].apply({"params": p}, x))
    exact = sum(
        np.mean((np.asarray(apply(p0, got[imgs][idx]), np.float64) - np.asarray(got[tgts])[idx])
                ** 2 * (1.0 + 20.0 * np.asarray(got[tgts], np.float64)[idx]))
        for imgs, tgts, idx in (("full_imgs", "full_tgts", idx_f),
                                ("crop_imgs", "crop_tgts", idx_c)))
    assert abs(float(loss) - exact) <= STEP_LOSS_RTOL * exact
    assert abs(float(jax_step["loss"]) - exact) <= JAX_MEAN_RTOL * exact
    # gradients: JAX's from its Adam first moment (mu = (1 - b1) g after
    # one step), the port's from the step's .grad
    g_jax = {k: v / np.float32(0.1) for k, v in _flat(jax_step["opt1"][0].mu).items()}
    for _, q in net.named_parameters():
        q.data = q.grad
    g_port = t_ckpt._flat_params(net)
    net = t_ckpt.posenet_from_flax(t_full.model_config(torch.float32), _numpy_tree(p0))
    t_full.train_step(net, t_full.make_optimizer(net), sets,
                      torch.as_tensor(idx_f), torch.as_tensor(idx_c))
    port, ref, before = t_ckpt._flat_params(net), _flat(jax_step["params1"]), _flat(p0)
    assert port.keys() == ref.keys() == g_jax.keys()
    moved = sum(int((ref[k] != before[k]).sum()) for k in ref)
    assert moved > 0.9 * sum(v.size for v in ref.values())
    for k in ref:
        a, b = g_port[k].ravel().astype(np.float64), g_jax[k].ravel().astype(np.float64)
        assert np.abs(a - b).max() <= STEP_GRAD_TOL * np.abs(b).max(), k
        assert a @ b >= STEP_GRAD_COS * np.linalg.norm(a) * np.linalg.norm(b), k
        # Adam's first step is lr g / (|g| + eps): where both gradients are
        # large and of one sign it is the same to well below 1e-6
        firm = ((np.abs(g_port[k]) > GRAD_FIRM) & (np.abs(g_jax[k]) > GRAD_FIRM)
                & (np.sign(g_port[k]) == np.sign(g_jax[k])))
        assert np.abs(port[k] - ref[k])[firm].max(initial=0.0) <= STEP_PARAM_TOL, k
    # the weights off by more than STEP_PARAM_TOL are few, and each within
    # the 2 lr that two first steps of opposite sign can put between them
    off = sum(int((np.abs(port[k] - ref[k]) > STEP_PARAM_TOL).sum()) for k in ref)
    assert off <= STEP_OFF_SHARE * sum(v.size for v in ref.values()), off
    assert max(np.abs(port[k] - ref[k]).max() for k in ref) <= 2 * t_full.LR + STEP_PARAM_TOL


@pytest.fixture(scope="module")
def trained(scene):
    """The example's training (bf16 compute, as the example trains) at
    TRAIN's steps and batch, cached by the port's test cache."""
    s, sets = scene
    fp = t_cache.source_fingerprint(
        [T.__file__, t_full.__file__],
        f"test-fullframe-{TRAIN['steps']}-{TRAIN['batch']}-" + "-".join(map(str, SCENE.values())))
    ckpt = t_cache.checkpoint_path("torch_e2e_fullframe_test", fp)
    if ckpt.exists():
        return t_ckpt.load_posenet(ckpt, device="cpu")[1]
    net = T.init_posenet(t_full.model_config(), torch.Generator().manual_seed(0))
    t_full.train(net, sets, TRAIN["steps"], torch.Generator().manual_seed(1), TRAIN["batch"])
    t_ckpt.save_posenet(ckpt, t_full.model_config(), net)
    return net


def _recording(seen, key, real):
    def call(*args, **kwargs):
        seen[key] = real(*args, **kwargs)
        seen[key + "_args"] = args
        return seen[key]
    return call


def _outputs(pkg, run_offline_result):
    out = run_offline_result[1]
    return pkg.outputs_to_numpy(out) if pkg is TT else jax.device_get(out)


def _filter_margins(kps, cfg, slots) -> float:
    """The smallest distance of the bad-pose filter's inputs at `slots`
    from its thresholds: a keypoint score from `filter_min_kps_score`, a
    side of the box over the valid keypoints from `filter_min_bbox_px`."""
    out = np.inf
    for f, v, p in slots:
        k = kps[f, v, p]
        ok = k[:, 2] > cfg.filter_min_kps_score
        out = min(out, float(np.abs(k[:, 2] - cfg.filter_min_kps_score).min()))
        if ok.any():
            side = k[ok, :2].max(0) - k[ok, :2].min(0)
            out = min(out, float(np.abs(side - cfg.filter_min_bbox_px).min()))
    return out


def first_split(jdets, tdets, jcams, tcams, jcfg, tcfg, jo, to) -> dict:
    """Where JAX's run on its detections and the port's on its own first
    part, and the decision that flips there.

    The first frame whose decisions differ (`eval.decision_digests`); JAX's
    state before it (its step over the frames before, from zeros).  When the
    bad-pose filter keeps other detections there: the filter gate, its
    inputs' smallest distance from its thresholds in each package, and the
    bound 2 DELTA (a box side is a difference of two coordinates, each
    DELTA apart).  Else the frame's ALS problem (`torch_parity_study.
    als_split`): JAX's W from JAX's detections against the port's W from
    the port's, both from JAX's state; the nudges are JAX's W from the
    port's detections and from JAX's moved by +-DELTA at random, DELTA being
    the largest difference of the two packages' detections at that frame.
    So the bound is the reach of JAX's own X under an input difference of
    the size measured, not anything the split itself shows."""
    j_dig, t_dig = t_eval.decision_digests(jo), t_eval.decision_digests(to)
    f = next(i for i in range(len(j_dig)) if j_dig[i] != t_dig[i])
    jf, tf = j_ingest.filter_bad_poses(jdets, jcfg), t_ingest.filter_bad_poses(tdets, tcfg)
    both = jdets.valid[f] & tdets.valid[f]
    delta = float(np.abs(jdets.kps[f][both] - tdets.kps[f][both]).max())
    out = {"frame": f, "delta_px": delta,
           "decisions_differing": [k for k in t_eval.DECISION_FIELDS
                                   if not np.array_equal(np.asarray(getattr(jo, k))[f],
                                                         np.asarray(getattr(to, k))[f])]}
    if not np.array_equal(jf.valid[f], tf.valid[f]):
        slots = [(f, v, p) for v, p in np.argwhere(jf.valid[f] != tf.valid[f])]
        margin = min(_filter_margins(jdets.kps, jcfg, slots),
                     _filter_margins(tdets.kps, tcfg, slots))
        return {**out, "decision": "filter", "slots": slots, "tie_margin": margin,
                "tie_bound": 2 * delta, "near_tie": margin <= 2 * delta}
    jctx = JT.TrackerContext.build(jcams, jcfg, use_ik=False)
    tctx = TT.TrackerContext.build(tcams, tcfg, use_ik=False, device="cpu")
    jstate, jstep = JT.TrackerState.zeros(jcfg), jax.jit(JT.make_step(jctx))
    for i in range(f):
        jstate, _ = jstep(jstate, (jnp.asarray(jf.kps[i]), jnp.asarray(jf.valid[i])))
    Wj, ev = parity.frame_ws(jctx, jstate, jf.kps[f], jf.valid[f], JT)
    Wt, _ = parity.frame_ws(tctx, parity._carry(jstate), tf.kps[f], tf.valid[f], TT)
    rng = np.random.RandomState(0)
    moved = [tf.kps[f]]
    for _ in range(SPLIT_DRAWS):
        k = jf.kps[f].copy()
        k[..., :2] += rng.choice([-delta, delta], k[..., :2].shape).astype(np.float32)
        moved.append(k)
    nudged = [parity.frame_ws(jctx, jstate, k, jf.valid[f], JT)[0] for k in moved]
    split = parity.als_split(Wj, Wt, ev, jctx.diag_mask, jctx.init_A, parity._als_kw(jcfg),
                             nudged)
    return {**out, "decision": "als", **split}


def test_inference_half_matches_jax(scene, trained, tmp_path, monkeypatch):
    """(a) the port's detections against JAX's; (b) the port's tracker on
    JAX's detections against JAX's run (lengths exact, MPJPE within
    MPJPE_TOL_M); (c) the port end to end: equal to JAX's, or split at a
    named frame by a tie that rounding decides (`first_split`)."""
    s, _ = scene
    mcfg = t_full.model_config(torch.float32)
    net = T.PoseNet(mcfg)
    net.load_state_dict(trained.state_dict())
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_pipeline, "run_offline", _recording(seen, "port_run", t_pipeline.run_offline))
        out = t_full.detect_and_track(net.eval(), mcfg, s)

    # JAX's main loads the same weights from its train-once cache
    monkeypatch.setenv("MVMC_TEST_CKPT_CACHE", str(tmp_path))
    steps = TRAIN["steps"]
    fp = j_cache.source_fingerprint(
        [J.__file__, j_full.__file__],
        f"fullframe-{steps}-" + "-".join(map(str, SCENE.values())))
    t_ckpt.save_posenet(j_cache.checkpoint_path("e2e_fullframe", fp), mcfg, net)
    monkeypatch.setattr(J, "PoseNetConfig", _f32_config)
    monkeypatch.setattr(j_detect, "frames_to_frame_batch",
                        _recording(seen, "batch", j_detect.frames_to_frame_batch))
    monkeypatch.setattr(j_pipeline, "run", _recording(seen, "result", j_pipeline.run))
    monkeypatch.setattr(j_pipeline, "run_offline",
                        _recording(seen, "jax_run", j_pipeline.run_offline))
    recall, det_err, n_long, mpjpe = j_full.main(steps=steps, cache=True, **SCENE)
    assert "batch" in seen, "JAX's main trained instead of loading the weights"

    # (a) the detections
    jb, tb = seen["batch"], out["det_batch"]
    assert np.array_equal(jb.valid, tb.valid)
    assert tb.valid.any(axis=-1).all()          # every image has a valid detection
    assert np.abs(jb.kps[jb.valid] - tb.kps[tb.valid]).max() <= KPS_TOL_PX
    assert out["recall"] == recall and recall > 0
    assert abs(out["det_err"] - det_err) <= DET_ERR_TOL_PX

    # (b) the port's tracker on JAX's detections, as the example runs it
    j_lengths = sorted(len(t) for t in seen["result"].tracklets)
    carried = t_ingest.FrameBatch(**{f.name: getattr(jb, f.name)
                                     for f in dataclasses.fields(t_ingest.FrameBatch)})
    on_jax = t_pipeline.run(carried, s.cams_small, s.cfg, use_ik=False, device="cpu")
    assert sorted(len(t) for t in on_jax.tracklets) == j_lengths
    long = [t for t in on_jax.tracklets if len(t) >= SCENE["n_frames"] // 2]
    on_jax_mpjpe = t_eval.mpjpe_vs_ground_truth(long, s.seq.gt_3d)
    print("on JAX's detections: lengths", j_lengths, "MPJPE m, port / JAX:", on_jax_mpjpe, mpjpe)
    assert len(long) == n_long >= 1
    assert abs(on_jax_mpjpe - mpjpe) <= MPJPE_TOL_M

    # (c) the port end to end
    if sorted(len(t) for t in out["result"].tracklets) == j_lengths:
        assert out["n_long"] == n_long
        assert abs(out["mpjpe"] - mpjpe) <= MPJPE_TOL_M
        return
    _, jcams, jcfg = seen["result_args"]
    split = first_split(jb, tb, jcams, s.cams_small, jcfg, s.cfg,
                        _outputs(JT, seen["jax_run"]), _outputs(TT, seen["port_run"]))
    print("first split:", json.dumps(split))
    assert split["near_tie"], split
