"""The port's ALS association (plain version of the CUDA kernel) against the
JAX package's `match_als` and its fused Pallas kernel in interpret mode.

The problems are the JAX ALS tests' own generator: well-separated
similarities (0.85 same person, 0.08 otherwise, +-0.06 noise) on which the
solve settles, so every solver must return the same binarized matrix and
the same groups.  Decisions are compared exactly: no tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch.ops import als_kernel
from multiview_motion_capture_torch.ops import association as TA
from multiview_motion_capture_torch.ops import cuda_lib
from multiview_motion_capture_tpu.ops import als_pallas as JP
from multiview_motion_capture_tpu.ops import association as JA
from tests.torch_study_scene import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _random_problem(seed, sizes=(3, 3, 2, 3), n_people=3):
    """tests/test_als_pallas.py::_random_problem."""
    rng = np.random.RandomState(seed)
    groups = []
    for s in sizes:
        ids = rng.permutation(n_people)[:s]
        groups.extend(ids.tolist())
    n = len(groups)
    cam_of = np.concatenate([[c] * s for c, s in enumerate(sizes)])
    W = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for j in range(n):
            if i == j or cam_of[i] == cam_of[j]:
                continue
            base = 0.85 if groups[i] == groups[j] else 0.08
            W[i, j] = np.clip(base + rng.uniform(-0.06, 0.06), 0, 1)
    W = 0.5 * (W + W.T)
    return W, groups, sizes


def _port(W, mask, init, **kw):
    return TA.match_als(torch.as_tensor(W), torch.as_tensor(mask), torch.as_tensor(init), **kw)


def _groups_np(x_bin, n):
    g = TA.extract_groups(torch.as_tensor(np.asarray(x_bin)), torch.ones(n, dtype=torch.bool))
    return g.rep.numpy(), g.member.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_plain_als_matches_jax_and_pallas(seed):
    W, groups, sizes = _random_problem(seed)
    n = len(groups)
    mask = JA.block_diag_mask(sizes)
    init = JA.default_init_factor(n, 8)

    xla = JA.match_als(jnp.asarray(W), jnp.asarray(mask), jnp.asarray(init),
                       stable_iters=10)
    ctx = JP.PallasAlsContext.build(n, mask, init)
    x_pal, _ = JP.match_als_pallas(
        JP.pad_similarity(jnp.asarray(W)), ctx.keep, ctx.eye_t, ctx.init_A,
        ctx.n_true, stable_iters=10, rank=ctx.rank, interpret=True)
    port = _port(W, mask, init, stable_iters=10)

    x_port = port.x_bin.numpy()
    np.testing.assert_array_equal(x_port, np.asarray(xla.x_bin))
    np.testing.assert_array_equal(x_port, np.asarray(x_pal)[:n, :n])
    rep, member = _groups_np(x_port, n)
    jg = JA.extract_groups(xla.x_bin, jnp.ones(n, dtype=bool))
    np.testing.assert_array_equal(rep, np.asarray(jg.rep))
    np.testing.assert_array_equal(member, np.asarray(jg.member))
    np.testing.assert_array_equal(port.x_bin.numpy(), port.x_bin.numpy().T)
    for i in range(n):
        for j in range(n):
            if not (mask[i, j] and i != j):
                assert (rep[i] == rep[j]) == (groups[i] == groups[j]), (seed, i, j)


def test_plain_als_multitile_matches_jax():
    """N = 150 (14 cameras x 10-12 detections), past the TPU kernel's
    128-lane tile: the port has no tiles, only the true N."""
    sizes = tuple(np.random.RandomState(100).randint(10, 13, size=14))
    W, groups, sizes = _random_problem(0, sizes=sizes, n_people=12)
    n = len(groups)
    mask = JA.block_diag_mask(sizes)
    init = JA.default_init_factor(n, 20)
    xla = JA.match_als(jnp.asarray(W), jnp.asarray(mask), jnp.asarray(init),
                       stable_iters=10)
    port = _port(W, mask, init, stable_iters=10)
    rep, member = _groups_np(port.x_bin.numpy(), n)
    jg = JA.extract_groups(xla.x_bin, jnp.ones(n, dtype=bool))
    np.testing.assert_array_equal(rep, np.asarray(jg.rep))
    np.testing.assert_array_equal(member, np.asarray(jg.member))


@pytest.mark.parametrize("stable_iters", [0, 10])
def test_residual_stop_and_iteration_count(stable_iters):
    """Where the solve settles, the stop test fires at the same iteration as
    the JAX `match_als` (the residual test alone, or with the stable exit)."""
    W, groups, sizes = _random_problem(2)
    n = len(groups)
    mask, init = JA.block_diag_mask(sizes), JA.default_init_factor(n, 8)
    xla = JA.match_als(jnp.asarray(W), jnp.asarray(mask), jnp.asarray(init),
                       max_iter=300, stable_iters=stable_iters)
    port = _port(W, mask, init, max_iter=300, stable_iters=stable_iters)
    assert int(port.n_iters) == int(xla.n_iters)
    assert int(port.n_iters) < 300
    np.testing.assert_allclose(port.x.numpy(), np.asarray(xla.x), atol=1e-4)


@pytest.mark.parametrize("rank", [16, 32])
@pytest.mark.parametrize("width", [1, 7, 21, 32])
def test_column_strips_equal_the_whole_solve_and_product(rank, width):
    """The invariant the cluster kernel's split rests on: the ridge solve of
    [G + lam I | R] and the ordered product F M, cut into column strips of R
    and M that share the left block, equal the whole, bit for bit."""
    rng = np.random.RandomState(10 * rank + width)
    n, m = 64, 75
    F = torch.as_tensor(rng.rand(rank, n).astype(np.float32))
    M = torch.as_tensor(rng.randn(n, m).astype(np.float32))
    aug = TA._ordered_matmul(F, torch.cat([F.T, M], 1))
    G = TA._ordered_matmul(F, F.T)
    assert torch.equal(G, aug[:, :rank])
    lam = float(np.float32(50.0) / np.float32(64.0))
    whole = TA._ridge_gauss_jordan(aug, lam)
    cuts = range(0, m, width)
    strips = [TA._ridge_gauss_jordan(torch.cat([G, aug[:, rank + c:rank + c + width]], 1), lam)
              for c in cuts]
    assert torch.equal(torch.cat(strips, 1), whole)
    prods = [TA._ordered_matmul(F, M[:, c:c + width]) for c in cuts]
    assert torch.equal(torch.cat(prods, 1), aug[:, rank:])


def _bits(t):
    return t.contiguous().view(torch.int32)


def _dealt_gram(F, S):
    """The Gram F F^T as the cluster kernel forms it: entry t = b (b + 1) / 2
    + a (a <= b) of the upper triangle summed in index order by block t mod S
    (slot t // S), then every block reads all shares and mirrors them."""
    r, n = F.shape
    b, a = zip(*[(b, a) for b in range(r) for a in range(b + 1)])
    a, b = torch.tensor(a), torch.tensor(b)
    prods = F[a] * F[b]                       # (entries, n), one rounding each
    s = prods[:, 0]
    for k in range(1, n):
        s = s + prods[:, k]
    shares = [s[q::S] for q in range(S)]      # block q: entries q, q + S, ...
    t = torch.arange(len(s))
    tri = torch.stack([shares[int(q)][int(u)] for q, u in zip(t % S, t // S)])
    G = torch.empty(r, r, dtype=F.dtype)
    G[a, b] = tri
    G[b, a] = tri
    return G


def _recorded_ridge_solve(G, R, lam):
    """The ridge solve as the kernel splits it: one warp eliminates the left
    block G + lam I alone, recording each step's pivot column as it stood
    before the step and the pivot's correctly rounded double reciprocal;
    the right-hand columns R then take the recorded steps.  Every quotient
    is the double product with that reciprocal rounded once to float
    (gj_elim.cuh's `quotient`)."""
    r = G.shape[0]
    idx = torch.arange(r)
    L = G.clone()
    L[idx, idx] = L[idx, idx] + lam
    steps = []
    for k in range(r):
        col = L[:, k].clone()
        rcp = 1.0 / col[k].double()
        row = (L[k].double() * rcp).float()
        L = L - col[:, None] * row[None, :]
        L[k] = row
        steps.append((col, rcp))
    X = R.clone()
    for k, (col, rcp) in enumerate(steps):
        row = (X[k].double() * rcp).float()
        X = X - col[:, None] * row[None, :]
        X[k] = row
    return X


@pytest.mark.parametrize("part", ["dealt_gram", "recorded_ridge_solve"])
@pytest.mark.parametrize("rank", [16, 24, 32])
def test_cluster_split_equals_the_whole(rank, part):
    """The invariants of the kernel's split of a ridge solve, at the cluster
    shape's 16 blocks: the Gram's upper triangle dealt over the blocks and
    mirrored equals the whole ordered product, and the left block's
    recorded elimination applied to the right-hand columns (quotients by
    the double reciprocal) equals the whole Gauss-Jordan, bit for bit."""
    rng = np.random.RandomState(100 + rank)
    n, m = 80, 21
    F = torch.as_tensor(rng.rand(rank, n).astype(np.float32))
    G = TA._ordered_matmul(F, F.T)
    if part == "dealt_gram":
        assert torch.equal(_bits(_dealt_gram(F, 16)), _bits(G))
        return
    M = torch.as_tensor(rng.randn(n, m).astype(np.float32))
    M[:, 3] = 0.0                              # zero numerators at every step
    Rhs = TA._ordered_matmul(F, M)
    for mu in (64.0, 0.5):
        lam = float(np.float32(50.0) / np.float32(mu))
        whole = TA._ridge_gauss_jordan(torch.cat([G, Rhs], 1), lam)
        assert torch.equal(_bits(_recorded_ridge_solve(G, Rhs, lam)), _bits(whole))


def test_block_diag_mask_and_init_factor_match_jax():
    sizes = (8, 6, 6, 6, 6, 6)
    np.testing.assert_array_equal(TA.block_diag_mask(sizes), JA.block_diag_mask(sizes))
    np.testing.assert_array_equal(TA.default_init_factor(38, 16),
                                  JA.default_init_factor(38, 16))


def test_extract_groups_matches_jax_with_invalid_elements():
    rng = np.random.RandomState(3)
    n = 20
    x = rng.rand(n, n) < 0.12
    x = x | x.T
    valid = rng.rand(n) < 0.8
    tg = TA.extract_groups(torch.as_tensor(x), torch.as_tensor(valid))
    jg = JA.extract_groups(jnp.asarray(x), jnp.asarray(valid))
    for f in ("rep", "group_size", "member"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)))
    np.testing.assert_array_equal(
        TA.transitive_closure(torch.as_tensor(x)).numpy(),
        np.asarray(JA.transitive_closure(jnp.asarray(x))))


def test_float64_runs_the_same_steps():
    """The f64 mode of the plain version (for studies) solves the same
    problem to the same groups."""
    W, groups, sizes = _random_problem(1)
    n = len(groups)
    mask, init = JA.block_diag_mask(sizes), JA.default_init_factor(n, 8)
    a = _port(W, mask, init, stable_iters=10)
    b = TA.match_als(torch.as_tensor(W, dtype=torch.float64), torch.as_tensor(mask),
                     torch.as_tensor(init), stable_iters=10)
    assert b.x.dtype == torch.float64
    np.testing.assert_array_equal(a.x_bin.numpy(), b.x_bin.numpy())


def test_wrapper_takes_plain_version_for_cpu_tensors():
    W, groups, sizes = _random_problem(0)
    n = len(groups)
    mask, init = JA.block_diag_mask(sizes), JA.default_init_factor(n, 8)
    before = cuda_lib.ALS.launches
    res = als_kernel.match_als(torch.as_tensor(W), torch.as_tensor(mask),
                               torch.as_tensor(init), stable_iters=10)
    plain = _port(W, mask, init, stable_iters=10)
    assert cuda_lib.ALS.launches == before
    np.testing.assert_array_equal(res.x_bin.numpy(), plain.x_bin.numpy())
    assert int(res.n_iters) == int(plain.n_iters)


def test_wrapper_rejects_other_devices():
    W = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        als_kernel.match_als(W, torch.zeros((4, 4), dtype=torch.bool, device="meta"),
                             torch.zeros((4, 2), device="meta"))
