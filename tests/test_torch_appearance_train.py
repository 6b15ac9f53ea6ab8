"""The port's appearance-head training side against the JAX package's, on
the CPU: `init_head`'s distribution, `supcon_loss` and `cosine_gap`, the
AdamW step from the same weights, and `descriptor_batch`.

Tolerances: losses and cosines on the same inputs within 1e-6 relative
(sums of a few hundred f32 terms; measured <= 2.5e-7); the step's losses
within 1e-5 relative (measured <= 3.5e-7) and its parameters within 0.05
lr after 3 steps (measured 1.2e-4 lr: the head's gradients sit far above
Adam's eps); descriptors within 1e-5 (measured 6e-8: the renders are
bit-equal, the bilinear samples differ by f32 rounding); labels exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multiview_motion_capture_torch.data import appearance_train as t_app
from multiview_motion_capture_torch.models import appearance_net as T
from multiview_motion_capture_torch.models import checkpoint as t_ckpt
from multiview_motion_capture_torch.models import optim as t_optim
from multiview_motion_capture_tpu.data import appearance_train as j_app
from multiview_motion_capture_tpu.models import appearance_net as J
from tests.torch_study_scene import one_thread

RTOL = 1e-6
STEP_LOSS_RTOL = 1e-5
STEP_PARAM_TOL_LR = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _embeddings(seed, n_ids=6, per=5, dim=12, lone=True):
    """Unit rows around per-identity directions; with `lone`, one identity
    seen once (an anchor without a positive)."""
    rng = np.random.RandomState(seed)
    base = rng.randn(n_ids, dim)
    x = np.repeat(base, per, axis=0) + 0.7 * rng.randn(n_ids * per, dim)
    labels = np.repeat(np.arange(n_ids), per)
    if lone:
        x = np.concatenate([x, rng.randn(1, dim)])
        labels = np.concatenate([labels, [99]])
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return x.astype(np.float32), labels.astype(np.int32)


def test_init_head_draws_flax_dense_init():
    cfg = T.AppearanceHeadConfig(in_dim=51, hidden=(128, 64), out_dim=32)
    a = T.init_head(torch.Generator().manual_seed(5), cfg, device="cpu")
    b = T.init_head(torch.Generator().manual_seed(5), cfg, device="cpu")
    c = T.init_head(torch.Generator().manual_seed(6), cfg, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.layers[0].weight, c.layers[0].weight)
    # the same distribution as flax's (lecun_normal: a normal truncated at
    # two standard deviations, unit variance over the fan-in)
    jp = J.init_head(jax.random.PRNGKey(0), cfg)
    for i, layer in enumerate(a.layers):
        w, fan_in = layer.weight.detach().numpy(), layer.in_features
        jw = np.asarray(jp[f"Dense_{i}"]["kernel"])
        assert w.shape == jw.T.shape
        for k in (w, jw):
            assert abs(k.std() * np.sqrt(fan_in) - 1.0) < 0.1
            assert np.abs(k).max() * np.sqrt(fan_in) <= 2.0 / 0.87962566103423978 + 1e-5
        assert torch.equal(layer.bias, torch.zeros_like(layer.bias))
        assert np.array_equal(np.asarray(jp[f"Dense_{i}"]["bias"]), np.zeros(layer.out_features))


@pytest.mark.parametrize("lone", [False, True], ids=["all_positive", "anchor_without_positive"])
def test_supcon_loss_and_cosine_gap_match_jax(lone):
    z, labels = _embeddings(0, lone=lone)
    for tau in (0.1, 0.5):
        a = float(T.supcon_loss(torch.as_tensor(z), torch.as_tensor(labels), tau))
        b = float(J.supcon_loss(jnp.asarray(z), jnp.asarray(labels), tau))
        assert a == pytest.approx(b, rel=RTOL)
    ts, td = T.cosine_gap(torch.as_tensor(z), torch.as_tensor(labels))
    js, jd = J.cosine_gap(jnp.asarray(z), jnp.asarray(labels))
    assert float(ts) == pytest.approx(float(js), rel=RTOL)
    assert float(td) == pytest.approx(float(jd), rel=RTOL)
    # the anchor without a positive changes nothing but the mean's count
    if lone:
        sub = float(T.supcon_loss(torch.as_tensor(z[:-1]), torch.as_tensor(labels[:-1])))
        full = float(T.supcon_loss(torch.as_tensor(z), torch.as_tensor(labels)))
        assert full != sub and np.isfinite(full)


def test_head_step_matches_jax():
    """3 AdamW steps (lr 1e-3, weight decay 1e-4, tau 0.1: the training
    script's settings) from the same weights on the same batch."""
    lr = 1e-3
    cfg = T.AppearanceHeadConfig(in_dim=12, hidden=(32,), out_dim=8)
    params = jax.tree_util.tree_map(np.asarray, J.init_head(jax.random.PRNGKey(1), cfg))
    head = t_ckpt.head_from_flax(cfg, params)
    tx = optax.adamw(lr, weight_decay=1e-4)
    jstep = J.make_train_step(cfg, tx, tau=0.1)
    tstep = T.make_train_step(head, t_optim.AdamW(head.parameters(), lr, weight_decay=1e-4),
                              tau=0.1)
    z, labels = _embeddings(3)
    jp, jo = params, tx.init(params)
    for s in range(3):
        jp, jo, jl = jstep(jp, jo, jnp.asarray(z), jnp.asarray(labels))
        tl = tstep(torch.as_tensor(z), torch.as_tensor(labels))
        assert float(tl) == pytest.approx(float(jl), rel=STEP_LOSS_RTOL), s
    for path, t, kind in t_ckpt._head_leaves(head):
        ref = np.asarray(jp[path[0]][path[1]])
        err = np.abs(t_ckpt._to_flax(t, kind) - ref).max() / lr
        assert err <= STEP_PARAM_TOL_LR, (path, err)


def test_descriptor_batch_matches_jax():
    kw = dict(n_scenes=1, n_frames=2, n_views=2, hw=(96, 128))
    je, jl = j_app.descriptor_batch(seed=4, **kw)
    te, tl = t_app.descriptor_batch(seed=4, device="cpu", **kw)
    assert np.array_equal(tl, jl) and tl.dtype == np.int32 and len(tl) > 4
    assert te.shape == je.shape and te.dtype == np.float32
    np.testing.assert_allclose(te, je, atol=1e-5, rtol=0)
    rng_j, rng_t = np.random.RandomState(9), np.random.RandomState(9)
    assert np.array_equal(t_app.random_person_tints(rng_t, 4), j_app.random_person_tints(rng_j, 4))
