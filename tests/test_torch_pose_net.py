"""The port's PoseNet and decoders against the JAX package's, on the CPU.

A random-init flax PoseNet at `tests/test_pose_net.py`'s SMALL width is
carried into the port by `models.checkpoint.posenet_from_flax`, and both
run on the same seeded images.  Tolerances:

- f32 compute: heat within 1e-4 (measured here: <= 1e-5 of heat values up
  to ~4; a padding, layout or kernel-flip fault moves it by whole units);
- bf16 compute (the shipped checkpoint's): XLA and PyTorch round the bf16
  sums of each convolution at other places, so single activations differ
  by one bf16 unit in the last place (2^-8 relative) and the differences
  propagate: heat within 0.04 x the heat's largest magnitude (measured:
  <= 0.012 x);
- decoders on the same heatmaps: integers (pixels, valid slots) exactly,
  floats within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch.models import checkpoint as t_ckpt
from multiview_motion_capture_torch.models import pose_net as T
from multiview_motion_capture_tpu.models import pose_net as J
from tests.torch_study_scene import one_thread

SMALL = dict(img_hw=(64, 48), stage_features=(64, 64, 128), blocks_per_stage=1,
             head_features=64)
HEADS = {"keypoints": dict(), "center": dict(predict_center=True),
         "bottom_up": dict(predict_center=True, predict_offsets=True)}
F32_HEAT_TOL = 1e-4
BF16_HEAT_REL_TOL = 0.04


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _pair(head: str, dtype: str, seed: int = 0):
    jcfg = J.PoseNetConfig(compute_dtype=getattr(jnp, dtype), **SMALL, **HEADS[head])
    tcfg = T.PoseNetConfig(compute_dtype=getattr(torch, dtype), **SMALL, **HEADS[head])
    params = J.PoseNet(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 48, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, t_ckpt.posenet_from_flax(tcfg, params).eval()


def _images(hw, n=2, seed=0):
    return np.random.RandomState(seed).rand(n, *hw, 3).astype(np.float32)


@pytest.mark.parametrize("hw", [(64, 48), (61, 45)], ids=["even", "odd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", list(HEADS))
def test_posenet_matches_jax(head, dtype, hw):
    jcfg, params, net = _pair(head, dtype)
    x = _images(hw)
    hj = np.asarray(J.PoseNet(jcfg).apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        ht = net(torch.as_tensor(x)).numpy()
    assert ht.shape == hj.shape == (2, -(-hw[0] // 16) * 4, -(-hw[1] // 16) * 4, jcfg.n_out)
    assert ht.dtype == np.float32
    err = np.abs(hj - ht).max()
    if dtype == "float32":
        assert err <= F32_HEAT_TOL, err
    else:
        assert err <= BF16_HEAT_REL_TOL * np.abs(hj).max(), (err, np.abs(hj).max())


def test_return_features_matches_jax():
    jcfg, params, net = _pair("center", "float32", seed=1)
    x = _images((64, 48), seed=1)
    hj, fj = J.PoseNet(jcfg).apply({"params": params}, jnp.asarray(x), return_features=True)
    with torch.no_grad():
        ht, ft = net(torch.as_tensor(x), return_features=True)
    assert ft.shape == (2, 16, 12, SMALL["head_features"]) and ft.dtype == torch.float32
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=F32_HEAT_TOL, rtol=0)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=F32_HEAT_TOL, rtol=0)


def test_init_posenet_draws_from_its_generator():
    """Random init as flax's, from an explicit torch.Generator: the same
    seed gives the same weights; LeCun-normal scales; zero biases."""
    cfg = T.PoseNetConfig(**SMALL, **HEADS["bottom_up"])
    a = T.init_posenet(cfg, torch.Generator().manual_seed(3))
    b = T.init_posenet(cfg, torch.Generator().manual_seed(3))
    c = T.init_posenet(cfg, torch.Generator().manual_seed(4))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert not torch.equal(a.stem.weight, c.stem.weight)
    w = a.blocks[1].conv1.weight.detach()          # fan-in 9 x 64
    assert abs(float(w.std()) - (1 / 576) ** 0.5) < 0.1 * (1 / 576) ** 0.5
    assert torch.equal(a.head.bias, torch.zeros_like(a.head.bias))


# ---------------------------------------------------------------------------
# decoders on the same heatmaps
# ---------------------------------------------------------------------------

def _gaussians(B, H, W, K, rng, sigma=1.5, peak=1.0):
    ys = np.arange(H)[None, :, None, None]
    xs = np.arange(W)[None, None, :, None]
    cy = rng.uniform(0, H - 1, size=(B, 1, 1, K))
    cx = rng.uniform(0, W - 1, size=(B, 1, 1, K))
    return (peak * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma ** 2))).astype(
        np.float32)


def _assert_close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=0)


@pytest.mark.parametrize("temperature", [1.0, 0.05])
def test_decode_heatmaps_matches_jax(temperature):
    rng = np.random.RandomState(0)
    heat = _gaussians(3, 16, 12, 17, rng) + 0.05 * rng.rand(3, 16, 12, 17).astype(np.float32)
    j = J.decode_heatmaps(jnp.asarray(heat), temperature=temperature)
    t = T.decode_heatmaps(torch.as_tensor(heat), temperature=temperature)
    _assert_close(t, j)


@pytest.mark.parametrize("case", ["interior", "border_and_ties", "center_prior"])
def test_decode_heatmaps_local_matches_jax(case):
    rng = np.random.RandomState(1)
    heat = _gaussians(2, 24, 20, 17, rng) + 0.1 * rng.rand(2, 24, 20, 17).astype(np.float32)
    sigma = 0.0
    if case == "border_and_ties":
        heat[0, 0, 0, 0] = heat[0, 23, 19, 1] = 5.0          # windows clamped at the borders
        heat[1, 5:8, 6:9, 2] = 3.0                          # a plateau: the first index wins
        heat = np.round(heat * 4) / 4                        # many exact ties
    elif case == "center_prior":
        heat[:, 2, 2, :] = heat.max() * 1.02                 # a corner distractor
        sigma = 0.5
    j = J.decode_heatmaps_local(jnp.asarray(heat), window=5, center_prior_sigma=sigma)
    t = T.decode_heatmaps_local(torch.as_tensor(heat), window=5, center_prior_sigma=sigma)
    _assert_close(t, j)


def _center_case(case, rng):
    if case == "peaks":
        c = _gaussians(3, 32, 48, 6, rng, sigma=1.5).max(-1)
    elif case == "plateau":          # tests/test_detect_cascade.py:35
        c = np.zeros((1, 32, 48), dtype=np.float32)
        c[0, 10:13, 20:23] = 1.0
    elif case == "quantized":        # bf16-like steps: ties everywhere
        c = np.round(_gaussians(2, 32, 48, 8, rng, sigma=2.0).max(-1) * 16) / 16
    elif case == "crowded":          # more peaks than slots
        c = _gaussians(2, 32, 48, 16, rng, sigma=1.0).max(-1)
    else:                            # nothing above the threshold
        c = 0.05 * rng.rand(2, 32, 48).astype(np.float32)
    return c.astype(np.float32)


@pytest.mark.parametrize("case", ["peaks", "plateau", "quantized", "crowded", "empty"])
def test_decode_center_peaks_matches_jax(case):
    """Exact: the peaks, their order (a stable descending sort, lax.top_k's
    lower-index-first on ties), the plateau tie-break, and the centers of
    the -inf slots past the last peak (taken from their indices)."""
    c = _center_case(case, np.random.RandomState(2))
    for nms in (3, 5):
        jc, jv = J.decode_center_peaks(jnp.asarray(c), max_people=8, min_score=0.3,
                                       nms_window=nms)
        tc, tv = T.decode_center_peaks(torch.as_tensor(c), max_people=8, min_score=0.3,
                                       nms_window=nms)
        assert np.array_equal(tv.numpy(), np.asarray(jv))
        assert np.array_equal(tc.numpy(), np.asarray(jc))
    if case == "plateau":
        assert int(tv.sum()) == 1


def _bottom_up_heat(rng, B=2, H=24, W=32, K=17, P=3):
    """Keypoint gaussians around P people, their center gaussians, and at
    each pixel the offsets to the nearest person's keypoints (some keypoints
    faint, so the regression stands; some at the borders)."""
    centers = rng.uniform(2, [W - 3, H - 3], size=(B, P, 2))
    kps = centers[:, :, None] + rng.uniform(-6, 6, size=(B, P, K, 2))
    kps[:, 0, :2] = [[-1.0, 0.5], [W + 0.5, H - 0.5]]        # windows clamped at the edge
    ys, xs = np.mgrid[0:H, 0:W]
    heat = np.zeros((B, H, W, 3 * K + 1), dtype=np.float32)
    for b in range(B):
        d2 = (xs[..., None] - centers[b, :, 0]) ** 2 + (ys[..., None] - centers[b, :, 1]) ** 2
        heat[b, ..., K] = np.exp(-d2 / 4.5).max(-1)
        owner = d2.argmin(-1)
        for p in range(P):
            amp = rng.choice([1.0, 0.1], size=K)             # 0.1: below snap_min
            g = np.exp(-((xs[..., None] - kps[b, p, :, 0]) ** 2
                         + (ys[..., None] - kps[b, p, :, 1]) ** 2) / 4.0) * amp
            heat[b, ..., :K] = np.maximum(heat[b, ..., :K], g)
        off = kps[b][owner] - np.stack([xs, ys], -1)[:, :, None, :]
        heat[b, ..., K + 1:] = off.reshape(H, W, 2 * K)
    return heat + 0.01 * rng.rand(*heat.shape).astype(np.float32)


@pytest.mark.parametrize("seed", [3, 4])
def test_decode_bottom_up_matches_jax(seed):
    heat = _bottom_up_heat(np.random.RandomState(seed))
    kw = dict(n_kps=17, max_people=5, min_score=0.3, nms_window=5, snap_window=7,
              snap_min=0.15)
    jk, jc, jv = J.decode_bottom_up(jnp.asarray(heat), **kw)
    tk, tc, tv = T.decode_bottom_up(torch.as_tensor(heat), **kw)
    assert np.array_equal(tv.numpy(), np.asarray(jv)) and int(tv.sum()) >= 2
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    _assert_close(tk, jk)
    # both branches of the snap ran: some keypoints snapped, some regressed
    snapped = np.asarray(jk)[..., 2] > 0.15 * np.asarray(jc)[..., None, 2]
    live = np.asarray(jv)[..., None]
    assert (snapped & live).any() and (~snapped & live).any()


def test_bf16_config_name_round_trip(tmp_path):
    """compute_dtype is stored by name, as the JAX package stores it."""
    _, params, net = _pair("bottom_up", "bfloat16")
    cfg = dataclasses.replace(net.cfg)
    t_ckpt.save_posenet(tmp_path / "p.npz", cfg, net)
    from multiview_motion_capture_tpu.models.checkpoint import load_posenet as j_load

    jcfg, jparams = j_load(tmp_path / "p.npz")
    assert jcfg.compute_dtype == jnp.bfloat16
    tcfg, _ = t_ckpt.load_posenet(tmp_path / "p.npz", device="cpu")
    assert tcfg == cfg and tcfg.compute_dtype is torch.bfloat16
