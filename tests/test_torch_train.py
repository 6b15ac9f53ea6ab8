"""The port's PoseNet training side against the JAX package's, on the CPU.

Targets, losses, `generate_samples`, the bottom-up step's loss and
gradients, AdamW updates and the schedule, `create_train_state` /
`train_step`, the npz parameter files and the test cache's fingerprints.
Tolerances:

- targets within 1e-6 (values up to 1 and offsets of tens of px; masks
  and the winners of ties exactly); losses on the same inputs 1e-6
  relative;
- a mean of ~1e4 f32 terms within MEAN_RTOL relative of XLA's: XLA's
  CPU reduction is the less exact (heatmap_loss of 10,880 terms: XLA
  3.1e-6 from the f64 value, the port 2.4e-8);
- the step at `tests/test_pose_net.py`'s SMALL width in f32 compute:
  loss within MEAN_RTOL (measured 0.85e-6 to 1.8e-6 at seeds 0-2), each
  leaf's gradient within 1e-4 of the leaf's largest magnitude (measured
  <= 6.4e-6; gradients in flax layout: the transposed convolutions'
  kernels flipped);
- in bf16 compute XLA and PyTorch round the bf16 sums of each
  convolution at other places (tests/test_torch_pose_net.py): loss within
  BF16_LOSS_RTOL relative (measured <= 3.6e-4 at seeds 0-2), and each
  leaf's gradient with a cosine of at least BF16_GRAD_COS to JAX's
  (measured >= 0.9785: the stem at seed 1);
- AdamW: 3 steps from the same parameters on the same batches, losses
  within 1e-5 relative; parameters, in units of lr, within
  ADAM_PARAM_TOL_LR (measured 0.032) where every step's gradient exceeds
  GRAD_AT_EPS, and within ADAM_AT_EPS_TOL_LR (measured 0.63) where one
  does not.  Adam moves a weight by about lr x g / (|g| + eps): a
  gradient at the scale of eps (1e-8), which is also the f32 rounding
  noise of a leaf whose largest gradient is ~0.1, turns a rounding
  difference into a step of a sizeable fraction of lr.  At seed 2 such
  weights sit in ['ResBlock_2']['Conv_1']['kernel'] (gradient -1.6e-8 at
  step 1: 0.63 lr apart), ['ConvTranspose_0']['kernel'] (-9.5e-10: 0.069
  lr) and ['ResBlock_2']['Conv_2']['kernel'] (0 and -3.2e-8: 0.030 lr);
- the schedule within 1e-6 of the peak value: optax computes it in f32,
  whose warmup `(init - peak) x frac + peak` loses ~1e-10 absolute to
  cancellation (4e-6 relative at count 1); the port's is f64.
"""
import hashlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multiview_motion_capture_torch.data import detect_train as t_train
from multiview_motion_capture_torch.data.render import RenderConfig as TRender
from multiview_motion_capture_torch.models import checkpoint as t_ckpt
from multiview_motion_capture_torch.models import optim as t_optim
from multiview_motion_capture_torch.models import pose_net as T
from multiview_motion_capture_torch.utils import testcache as t_cache
from multiview_motion_capture_tpu.data import detect_train as j_train
from multiview_motion_capture_tpu.data.render import RenderConfig as JRender
from multiview_motion_capture_tpu.models import checkpoint as j_ckpt
from multiview_motion_capture_tpu.models import pose_net as J
from multiview_motion_capture_tpu.utils import testcache as j_cache
from tests.torch_study_scene import one_thread

SMALL = dict(img_hw=(64, 48), stage_features=(64, 64, 128), blocks_per_stage=1,
             head_features=64)
BOTTOM_UP = dict(predict_center=True, predict_offsets=True)
TARGET_TOL = 1e-6
F32_LOSS_RTOL = 1e-6
MEAN_RTOL = 1e-5           # XLA's f32 mean of ~1e4 terms on the CPU (3e-6 here)
F32_GRAD_TOL = 1e-4        # of each leaf's largest magnitude
BF16_LOSS_RTOL = 2e-3
BF16_GRAD_COS = 0.95
ADAM_LOSS_RTOL = 1e-5
ADAM_PARAM_TOL_LR = 0.05   # learning rates, after 3 steps
ADAM_AT_EPS_TOL_LR = 2.0
GRAD_AT_EPS = 1e-6         # 100 x Adam's eps


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _np(t):
    return t.detach().cpu().numpy()


def _close(a, b, tol=TARGET_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# targets and losses
# ---------------------------------------------------------------------------

def _offset_case(case):
    """centers (B, P, 2), kps (B, P, K, 2), valid (B, P), kp_mask (B, P, K)
    on a 16 x 20 map."""
    rng = np.random.RandomState(0)
    B, P, K = 2, 3, 17
    centers = rng.uniform(2, [17, 13], size=(B, P, 2)).astype(np.float32)
    valid = np.ones((B, P), bool)
    if case == "ties":          # pixels equidistant from two centers: the first wins
        centers[0, 0], centers[0, 1], centers[0, 2] = [5.0, 6.0], [7.0, 6.0], [6.0, 8.0]
        centers[1, 0], centers[1, 1] = [10.0, 4.0], [10.0, 4.0]     # the same center twice
    elif case == "overlap":     # discs of radius 2 that overlap
        centers[:, 1] = centers[:, 0] + [1.5, 0.5]
        valid[1, 2] = False
    elif case == "all_invalid":  # image 1 has nobody: owner 0, no disc
        valid[1] = False
        valid[0, 1] = False
    kps = (centers[:, :, None] + rng.uniform(-6, 6, size=(B, P, K, 2))).astype(np.float32)
    kp_mask = (rng.rand(B, P, K) > 0.2).astype(np.float32)
    return centers, kps, valid, kp_mask


@pytest.mark.parametrize("case", ["random", "ties", "overlap", "all_invalid"])
def test_offset_targets_match_jax(case):
    c, k, v, m = _offset_case(case)
    jt, jm = J.offset_targets(jnp.asarray(c), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
                              (16, 20), radius=2.0)
    tt, tm = T.offset_targets(*(torch.as_tensor(a) for a in (c, k, v, m)), (16, 20), radius=2.0)
    assert np.array_equal(_np(tm), np.asarray(jm))
    _close(tt, jt)
    if case == "all_invalid":
        assert not _np(tm)[1].any()
        # owner 0 everywhere: the targets point at person 0's keypoints
        ys, xs = np.mgrid[0:16, 0:20]
        _close(_np(tt)[1, ..., 0::2], k[1, 0, :, 0][None, None] - xs[..., None])
    if case == "ties":
        assert _np(tm)[0].any() and _np(tm)[1].any()


def test_heatmap_targets_and_losses_match_jax():
    rng = np.random.RandomState(1)
    kps = rng.uniform(-2, [21, 17], size=(3, 17, 2)).astype(np.float32)
    _close(T.gaussian_heatmaps(torch.as_tensor(kps), (16, 20), sigma=2.0),
           J.gaussian_heatmaps(jnp.asarray(kps), (16, 20), sigma=2.0))
    centers = rng.uniform(0, [20, 16], size=(3, 4, 2)).astype(np.float32)
    valid = (rng.rand(3, 4) > 0.3).astype(np.float32)
    valid[2] = 0.0
    _close(T.center_targets(torch.as_tensor(centers), torch.as_tensor(valid), (16, 20), 1.5),
           J.center_targets(jnp.asarray(centers), jnp.asarray(valid), (16, 20), 1.5))

    pred = rng.randn(2, 16, 20, 34).astype(np.float32) * 2
    tgt = rng.randn(2, 16, 20, 34).astype(np.float32) * 2      # |d| on both sides of 1
    mask = (rng.rand(2, 16, 20, 17) > 0.5).astype(np.float32)
    for m in (mask, np.zeros_like(mask)):                        # an empty mask divides by 1
        a = float(T.offset_loss(*(torch.as_tensor(x) for x in (pred, tgt, m))))
        b = float(J.offset_loss(*(jnp.asarray(x) for x in (pred, tgt, m))))
        assert a == pytest.approx(b, rel=F32_LOSS_RTOL, abs=1e-12)
    heat = rng.rand(2, 16, 20, 17).astype(np.float32)
    other = heat[::-1].copy()
    kp_mask = (rng.rand(2, 17) > 0.3).astype(np.float32)
    a = float(T.heatmap_loss(*(torch.as_tensor(x) for x in (heat, other, kp_mask))))
    b = float(J.heatmap_loss(*(jnp.asarray(x) for x in (heat, other, kp_mask))))
    exact = np.mean((heat.astype(np.float64) - other) ** 2 * kp_mask[:, None, None, :])
    assert a == pytest.approx(exact, rel=F32_LOSS_RTOL)
    assert a == pytest.approx(b, rel=MEAN_RTOL)


@pytest.mark.parametrize("visibility_aware", [False, True], ids=["plain", "visibility_aware"])
def test_generate_samples_match_jax(visibility_aware):
    kw = dict(n_frames=2, n_views=2, n_people_range=(2, 4), visibility_aware=visibility_aware)
    js = j_train.generate_samples([3, 11], JRender(hw=(96, 128)), **kw)
    ts = t_train.generate_samples([3, 11], TRender(hw=(96, 128)), device="cpu", **kw)
    assert ts.images.shape == (8, 96, 128, 3) and ts.heat_tgt.shape == (8, 24, 32, 18)
    assert np.array_equal(ts.images, js.images)
    assert np.array_equal(ts.kps_px, js.kps_px, equal_nan=True)
    assert np.array_equal(ts.present, js.present) and np.array_equal(ts.vis, js.vis)
    for f in ("heat_tgt", "off_tgt", "off_mask"):
        a, b = getattr(ts, f), getattr(js, f)
        assert a.dtype == b.dtype == np.float32, f
        _close(a, b)
    assert js.present.any() and js.off_mask.any()
    if visibility_aware:     # some painted-over joints go unsupervised
        assert (js.present[..., None] & ~js.vis).any()


# ---------------------------------------------------------------------------
# the bottom-up step: loss and gradients
# ---------------------------------------------------------------------------

def _net_pair(dtype="float32", seed=0, **heads):
    heads = heads or BOTTOM_UP
    jcfg = J.PoseNetConfig(compute_dtype=getattr(jnp, dtype), **SMALL, **heads)
    tcfg = T.PoseNetConfig(compute_dtype=getattr(torch, dtype), **SMALL, **heads)
    params = J.PoseNet(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 48, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tcfg, params, t_ckpt.posenet_from_flax(tcfg, params)


def _batch(seed, n=2):
    """Images and bottom-up targets of random people on the SMALL map."""
    rng = np.random.RandomState(seed)
    images = rng.rand(n, 64, 48, 3).astype(np.float32)
    P = 2
    centers = rng.uniform(2, [10, 14], size=(n, P, 2)).astype(np.float32)
    kps = (centers[:, :, None] + rng.uniform(-3, 3, size=(n, P, 17, 2))).astype(np.float32)
    valid = np.ones((n, P), bool)
    valid[-1, 1] = False
    jw = np.broadcast_to(valid[..., None], (n, P, 17)).astype(np.float32)
    g = np.asarray(J.gaussian_heatmaps(jnp.asarray(kps.reshape(n, P * 17, 2)), (16, 12)))
    kt = (g.reshape(n, 16, 12, P, 17) * jw[:, None, None]).max(3)
    ct = np.asarray(J.center_targets(jnp.asarray(centers), jnp.asarray(valid.astype(np.float32)),
                                     (16, 12), 1.5))
    ot, om = J.offset_targets(jnp.asarray(centers), jnp.asarray(kps), jnp.asarray(valid),
                              jnp.asarray(jw), (16, 12))
    return (images, np.concatenate([kt, ct[..., None]], -1).astype(np.float32),
            np.array(ot), np.array(om))


def _grad_capture():
    """An optax transformation whose state is the last gradient and whose
    update is zero: JAX's own step then yields its loss and gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_loss_and_grads(jcfg, params, batch):
    tx = _grad_capture()
    step = j_train.make_train_step(jcfg, tx)
    _, grads, loss = step(params, tx.init(params), *map(jnp.asarray, batch))
    return float(loss), {t_ckpt.keystr(tuple(k.key for k in path)): np.asarray(v)
                         for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}


def _port_loss_and_grads(net, batch):
    net.zero_grad(set_to_none=True)
    loss = t_train.detect_loss(net, *map(torch.as_tensor, batch))
    loss.backward()
    return float(loss.detach()), {t_ckpt.keystr(p): t_ckpt._to_flax(t.grad, kind)
                         for p, t, kind in t_ckpt._posenet_leaves(net)}


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bottom_up_step_loss_and_grads_match_jax(dtype):
    jcfg, _, params, net = _net_pair(dtype)
    batch = _batch(0)
    jl, jg = _jax_loss_and_grads(jcfg, params, batch)
    tl, tg = _port_loss_and_grads(net, batch)
    assert set(tg) == set(jg) and len(tg) == 31
    if dtype == "float32":
        assert tl == pytest.approx(jl, rel=MEAN_RTOL)
        for k in jg:
            err = np.abs(tg[k] - jg[k]).max()
            assert err <= F32_GRAD_TOL * np.abs(jg[k]).max(), (k, err, np.abs(jg[k]).max())
    else:
        assert tl == pytest.approx(jl, rel=BF16_LOSS_RTOL)
        cos = {k: _cos(tg[k], jg[k]) for k in jg}
        assert min(cos.values()) >= BF16_GRAD_COS, sorted(cos.items(), key=lambda kv: kv[1])[:3]


# ---------------------------------------------------------------------------
# AdamW and the schedule against optax
# ---------------------------------------------------------------------------

def _flat_port(net, grad=False):
    return {t_ckpt.keystr(p): t_ckpt._to_flax(t.grad if grad else t, kind)
            for p, t, kind in t_ckpt._posenet_leaves(net)}


def _leaf_diffs_in_lr(jparams, net, lr, min_abs_grad):
    """Per leaf: the largest parameter difference in units of lr where
    every step's gradient exceeds GRAD_AT_EPS, and where one does not."""
    flat_j = {t_ckpt.keystr(tuple(k.key for k in p)): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat_t = _flat_port(net)
    out = {}
    for k in flat_j:
        d = np.abs(flat_t[k] - flat_j[k]) / lr
        at_eps = min_abs_grad[k] <= GRAD_AT_EPS
        out[k] = (float(d[~at_eps].max(initial=0)), float(d[at_eps].max(initial=0)))
    return out


@pytest.mark.parametrize("lr_kind", ["constant", "warmup_cosine"])
def test_adamw_steps_match_optax(lr_kind):
    """3 steps of the bottom-up step with AdamW, from the same parameters
    on the same batches; with the warmup schedule the first update runs at
    lr 0, as optax's (the count before the update)."""
    lr = 1e-3
    jcfg, tcfg, params, net = _net_pair("float32", seed=2)
    if lr_kind == "constant":
        jtx, topt = optax.adamw(lr), t_optim.AdamW(net.parameters(), lr)
    else:
        sched = dict(init_value=0.0, peak_value=lr, warmup_steps=2, decay_steps=5,
                     end_value=lr * 0.02)
        jtx = optax.adamw(optax.warmup_cosine_decay_schedule(**sched))
        topt = t_optim.AdamW(net.parameters(), t_optim.warmup_cosine_decay_schedule(**sched))
    jstep = j_train.make_train_step(jcfg, jtx)
    tstep = t_train.make_train_step(tcfg, net, topt)
    jp, jo = params, jtx.init(params)
    before = _flat_port(net)
    min_abs_grad = None
    for s in range(3):
        batch = _batch(10 + s)
        jp, jo, jl = jstep(jp, jo, *map(jnp.asarray, batch))
        tl = tstep(*map(torch.as_tensor, batch))
        assert float(tl) == pytest.approx(float(jl), rel=ADAM_LOSS_RTOL), s
        g = {k: np.abs(v) for k, v in _flat_port(net, grad=True).items()}
        min_abs_grad = g if min_abs_grad is None else {
            k: np.minimum(min_abs_grad[k], v) for k, v in g.items()}
        if s == 0 and lr_kind == "warmup_cosine":    # lr 0: only the moments moved
            after = _flat_port(net)
            assert all(np.array_equal(before[k], after[k]) for k in before)
    diffs = _leaf_diffs_in_lr(jp, net, lr, min_abs_grad)
    worst = max(diffs, key=lambda k: diffs[k][0])
    assert diffs[worst][0] <= ADAM_PARAM_TOL_LR, (worst, diffs[worst])
    worst = max(diffs, key=lambda k: diffs[k][1])
    assert diffs[worst][1] <= ADAM_AT_EPS_TOL_LR, (worst, diffs[worst])
    assert topt.count == 3


def test_warmup_cosine_schedule_matches_optax():
    for kw in (dict(init_value=0.0, peak_value=1e-3, warmup_steps=300, decay_steps=6000,
                    end_value=2e-5),
               dict(init_value=1e-4, peak_value=1e-3, warmup_steps=0, decay_steps=50)):
        js = optax.warmup_cosine_decay_schedule(**kw)
        ts = t_optim.warmup_cosine_decay_schedule(**kw)
        for c in (0, 1, 7, 150, 299, 300, 301, 3000, 5999, 6000, 9000):
            assert abs(ts(c) - float(js(c))) <= 1e-6 * kw["peak_value"], (kw, c)
    with pytest.raises(ValueError, match="decay_steps"):
        t_optim.warmup_cosine_decay_schedule(0.0, 1.0, 10, 10)


def test_adamw_states_optax_defaults():
    opt = t_optim.AdamW([torch.nn.Parameter(torch.zeros(3))], 1e-3)
    g = opt.param_groups[0]
    assert (g["betas"], g["eps"], g["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-4)


# ---------------------------------------------------------------------------
# create_train_state / train_step, parameter files, the test cache
# ---------------------------------------------------------------------------

@pytest.fixture
def no_orbax(monkeypatch):
    """The JAX package's parameter files take their npz branch."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def test_create_train_state_and_train_step(tmp_path, no_orbax):
    """The counterpart of tests/test_pose_net.py::test_train_step_reduces_loss:
    the keypoint-only step lowers the loss; its first three steps equal
    JAX's `train_step` from the same weights (carried by `save_params` and
    the JAX package's `load_params`)."""
    cfg = T.PoseNetConfig(**SMALL, compute_dtype=torch.float32)
    net, opt = T.create_train_state(torch.Generator().manual_seed(1), cfg, lr=1e-3,
                                    device="cpu")
    rng = np.random.RandomState(2)
    imgs = rng.rand(4, 64, 48, 3).astype(np.float32)
    kps = (rng.rand(4, 17, 2) * [11.0, 15.0]).astype(np.float32)
    target = np.array(J.gaussian_heatmaps(jnp.asarray(kps), (16, 12)))
    mask = np.ones((4, 17), np.float32)

    jcfg = J.PoseNetConfig(**SMALL, compute_dtype=jnp.float32)
    model = J.PoseNet(jcfg)
    like = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3)))["params"]
    t_ckpt.save_params(tmp_path / "init", net)
    params = j_ckpt.load_params(tmp_path / "init", like)
    tx = optax.adamw(1e-3)
    opt_state = tx.init(params)
    jstep = jax.jit(lambda p, o: J.train_step(model, p, o, tx, jnp.asarray(imgs),
                                              jnp.asarray(target), jnp.asarray(mask)))
    losses = []
    for s in range(8):
        loss = float(T.train_step(net, opt, *map(torch.as_tensor, (imgs, target, mask))))
        if s < 3:
            params, opt_state, jl = jstep(params, opt_state)
            assert loss == pytest.approx(float(jl), rel=ADAM_LOSS_RTOL), s
        losses.append(loss)
    assert losses[-1] < losses[0] * 0.9, losses


def test_params_files_both_ways(tmp_path, no_orbax):
    jcfg, tcfg, params, net = _net_pair("float32", seed=3)
    # JAX writes, the port reads into a module and into a nested dict
    j_ckpt.save_params(tmp_path / "j", params)
    assert (tmp_path / "j.npz").is_file()
    other = T.init_posenet(tcfg, torch.Generator().manual_seed(0))
    got = t_ckpt.load_params(tmp_path / "j", other)
    assert got is other
    for (_, a), (_, b) in zip(got.state_dict().items(), net.state_dict().items()):
        assert torch.equal(a, b)
    like = jax.tree_util.tree_map(torch.tensor, params)
    as_dict = t_ckpt.load_params(tmp_path / "j", like)
    assert np.array_equal(as_dict["ConvTranspose_1"]["kernel"].numpy(),
                          params["ConvTranspose_1"]["kernel"])
    # the port writes a module and a nested dict, JAX reads them
    t_ckpt.save_params(tmp_path / "t", net)
    back = j_ckpt.load_params(tmp_path / "t", params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert np.array_equal(np.asarray(a), b)
    t_ckpt.save_params(tmp_path / "d", as_dict)
    back = j_ckpt.load_params(tmp_path / "d", params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert np.array_equal(np.asarray(a), b)
    # an orbax directory is refused by name; a missing file raises
    (tmp_path / "orbax_ckpt").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        t_ckpt.load_params(tmp_path / "orbax_ckpt", net)
    with pytest.raises(FileNotFoundError):
        t_ckpt.load_params(tmp_path / "missing", net)


def test_testcache_matches_jax(tmp_path, monkeypatch):
    srcs = [T.__file__, t_train.__file__]
    fp = t_cache.source_fingerprint(srcs, "steps=300")
    assert fp == j_cache.source_fingerprint(srcs, "steps=300")
    assert fp != t_cache.source_fingerprint(srcs, "steps=301")
    h = hashlib.sha1()
    for p in sorted(srcs):
        h.update(open(p, "rb").read())
    h.update(b"steps=300")
    assert fp == h.hexdigest()[:16]
    monkeypatch.setenv("MVMC_TEST_CKPT_CACHE", str(tmp_path / "cache"))
    assert t_cache.checkpoint_path("posenet", fp) == j_cache.checkpoint_path("posenet", fp)
    assert (tmp_path / "cache").is_dir()
