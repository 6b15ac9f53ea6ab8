"""The plain reference of the tracker's triangulation mode: one frame's step,
from a state, in plain PyTorch and NumPy.

It follows the published semantics of the cross-view tracker
(arXiv:2003.03972) as the port's configuration states them, and imports
nothing of the program: it works out its own constants (projection,
fundamental and inverse intrinsic matrices, the interleaved camera
clusters, the same-group masks and the ALS's seeded initial factor) from
the calibration and the configuration file.  Per frame:

1. predict: every live track ages by one frame;
2. similarity: the spatial-time matrix [tracks | detections] (the 2D-2D
   symmetric epipolar errors, the 2D-3D reprojection errors of each live
   track, the missing entries at the masked maximum + 1, a sigmoid), or the
   spatial-only matrix when no track is alive (z-normalised symmetric
   epipolar distances); per camera cluster on a clustered rig;
3. the ALS multi-way matching (ADMM with ridge-regularised factor steps,
   the residual test and the stable-binarisation exit) on each matrix,
   the clusters scattered into the global matrix and new-person groups
   linked across clusters by their triangulated centroids;
4. groups as connected components, each track's matched detections, the
   rescue of confirmed tracks about to die, deaths, spawns into free slots;
5. DLT triangulation with Gauss-Newton polish of every updated (its best
   views) and spawned (all its views) track; the lifecycle counters.

Precision: the constants are held in float32, as a calibration is stored;
the similarity, the geometry and the ALS run in `work` (float64 for the
reference), the similarity rounded once to float32 where the ALS takes it,
the poses rounded once to float32 where the state keeps them.  The control
(`control.py`) is this reference one precision below the configuration's:
`work` float32 for the tracker's float64 math, the ALS's products in TF32
for its float32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FREE, TENTATIVE, CONFIRMED = 0, 1, 2
LSH, RSH, LHIP, RHIP = 5, 6, 11, 12
K17, K18 = 17, 18


class RefState(NamedTuple):
    active: np.ndarray     # (T,) 0 free / 1 tentative / 2 confirmed
    track_id: np.ndarray   # (T,)
    hits: np.ndarray       # (T,)
    tsu: np.ndarray        # (T,) frames since the last update
    pose3d: np.ndarray     # (T, 18, 3) float32
    score: np.ndarray      # (T, 18) float32
    root: np.ndarray       # (T, 3) float32
    next_id: int

    @classmethod
    def zeros(cls, T: int) -> "RefState":
        z = np.zeros
        return cls(active=z(T, np.int64), track_id=np.full(T, -1, np.int64),
                   hits=z(T, np.int64), tsu=z(T, np.int64),
                   pose3d=z((T, K18, 3), np.float32), score=z((T, K18), np.float32),
                   root=z((T, 3), np.float32), next_id=0)


class RefContext:
    """The reference's constants for one rig and configuration.  `work`:
    the precision of the similarity, the geometry and the ALS (float64;
    float32 for the control); `als_tf32`: the ALS's products take their
    operands rounded to TF32 (the control's step below float32)."""

    def __init__(self, K: np.ndarray, Rt: np.ndarray, pipeline: dict,
                 work=np.float64, device="cpu", als_tf32: bool = False):
        self.cfg = dict(pipeline)
        self.als_tf32 = als_tf32
        c = self.cfg
        if c["appearance_dim"] or c["motion_gain"]:
            raise ValueError("the reference covers geometry-only association")
        self.work = work
        self.tdt = torch.float64 if work == np.float64 else torch.float32
        self.device = torch.device(device)
        self.V, self.P, self.T = int(c["n_views"]), int(c["max_people"]), int(c["max_tracks"])
        K32 = np.asarray(K, np.float64).astype(np.float32)
        Rt32 = np.asarray(Rt, np.float64).astype(np.float32)
        self.P32 = np.einsum("vij,vjk->vik", np.asarray(K, np.float64),
                             np.asarray(Rt, np.float64)).astype(np.float32)
        self.Kinv32 = np.linalg.inv(K32.astype(np.float64)).astype(np.float32)
        self.F_sp = _fundamental_closed_form(K32.astype(np.float64), Rt32.astype(np.float64))
        self.F_det = _fundamental_minors(self.P32.astype(np.float64))
        C = int(c["assoc_clusters"])
        self.C = C
        self.rank = min(self.T + self.V * self.P,
                        int(c["als_rank_factor"]) * max(self.T, self.P))
        Vc = -(-self.V // C)
        self.Vc = Vc
        self.clusters = []
        for k in range(C):
            views = np.arange(k, self.V, C)
            real = np.ones(Vc, bool)
            if len(views) < Vc:
                real[len(views):] = False
                views = np.concatenate([views, np.full(Vc - len(views), views[0])])
            self.clusters.append((views, real))
        self.nc = self.T + Vc * self.P
        self.mask = _block_mask((self.T,) + (self.P,) * Vc)
        self.init = np.random.RandomState(0).rand(self.nc, self.rank).astype(np.float32)

    def t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(self.tdt)


def _fundamental_closed_form(K: np.ndarray, Rt: np.ndarray) -> np.ndarray:
    """F_ij = K_i^-T (R_i R_j^T) K_j^T [K_j R_j R_i^T (t_i - R_i R_j^T t_j)]_x for
    every pair, Frobenius-normalised, float32."""
    R, t = Rt[..., :3], Rt[..., 3]
    Rij = np.einsum("iab,jcb->ijac", R, R)
    rel = t[:, None] - np.einsum("ijab,jb->ija", Rij, t)
    e = np.einsum("jab,jbc,idc,ijd->ija", K, R, R, rel)   # K_j R_j R_i^T rel
    sk = np.zeros(e.shape[:2] + (3, 3))
    sk[..., 0, 1], sk[..., 0, 2] = -e[..., 2], e[..., 1]
    sk[..., 1, 0], sk[..., 1, 2] = e[..., 2], -e[..., 0]
    sk[..., 2, 0], sk[..., 2, 1] = -e[..., 1], e[..., 0]
    Kinv_T = np.linalg.inv(K).transpose(0, 2, 1)
    F = np.einsum("iab,ijbc,jdc,ijde->ijae", Kinv_T, Rij, K, sk)
    zero = F.sum(axis=(2, 3)) == 0
    F[zero] += 1e-12
    n = np.linalg.norm(F, axis=(2, 3))
    F = np.where((n > 1e-30)[..., None, None], F / np.where(n > 1e-30, n, 1.0)[..., None, None], F)
    return F.astype(np.float32)


def _fundamental_minors(P: np.ndarray) -> np.ndarray:
    """F_ab[i, j] = det([P_a without row j; P_b without row i]) (rows in cyclic
    order), mapping image-a points to image-b lines; normalised, float32."""
    cyc = np.array([[1, 2], [2, 0], [0, 1]])
    V = len(P)
    A = P[:, cyc]                      # (V, 3, 2, 4): rows kept for each left-out row
    M = np.concatenate([np.broadcast_to(A[:, None, None, :], (V, V, 3, 3, 2, 4)),
                        np.broadcast_to(A[None, :, :, None], (V, V, 3, 3, 2, 4))], axis=-2)
    # M[a, b, i, j] = [P_a rows cyc[j]; P_b rows cyc[i]]
    F = np.linalg.det(M)
    n = np.linalg.norm(F, axis=(2, 3))
    F = np.where((n > 0)[..., None, None], F / np.where(n > 0, n, 1.0)[..., None, None], F)
    return F.astype(np.float32)


def _block_mask(sizes) -> np.ndarray:
    n = int(sum(sizes))
    m = np.zeros((n, n), bool)
    o = 0
    for s in sizes:
        m[o:o + s, o:o + s] = True
        o += s
    return m


# ---------------------------------------------------------------------------
# similarity (torch, in the work precision)
# ---------------------------------------------------------------------------

def _homo(xy: torch.Tensor) -> torch.Tensor:
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def _unit_lines(l: torch.Tensor) -> torch.Tensor:
    return l / (torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)[..., None] + 1e-12)


def _epipolar_pairs(kps: torch.Tensor, F: torch.Tensor, min_score: float) -> torch.Tensor:
    """d[a, p, b, q]: the symmetric point-to-epiline distance of detections
    (a, p) and (b, q), averaged over keypoints whose score product passes
    `min_score`; NaN where none does."""
    x = _homo(kps[..., :2])                                     # (V, P, K, 3)
    s = kps[..., 2]
    l_b = _unit_lines(torch.einsum("abij,apkj->abpki", F, x))   # F_ab x_a
    l_a = _unit_lines(torch.einsum("abji,bqkj->abqki", F, x))   # F_ab^T x_b
    d_ab = torch.einsum("abpki,bqki->apbqk", l_b, x).abs()
    d_ba = torch.einsum("abqki,apki->apbqk", l_a, x).abs()
    ok = (s[:, :, None, None, :] * s[None, None]) > min_score
    per = torch.where(ok, 0.5 * (d_ab + d_ba), torch.zeros_like(d_ab))
    cnt = ok.sum(-1)
    return torch.where(cnt > 0, per.sum(-1) / cnt.clamp(min=1),
                       torch.full_like(per[..., 0], float("nan")))


def _reprojection(pose: torch.Tensor, score: torch.Tensor, kps: torch.Tensor,
                  P: torch.Tensor, min_score: float) -> torch.Tensor:
    """d[t, v, p]: mean pixel distance between track t's 17 joints projected
    into view v and detection (v, p), over joints whose 3D score times 2D
    score passes `min_score`; NaN where none does."""
    X = _homo(pose)                                              # (T, 17, 4)
    proj = torch.einsum("vab,tkb->tvka", P, X)                   # (T, V, 17, 3)
    uv = proj[..., :2] / (proj[..., 2:3] + 1e-5)
    d = torch.linalg.vector_norm(uv[:, :, None] - kps[None, ..., :2], dim=-1)  # (T,V,P,K)
    ok = (score[:, None, None, :] * kps[None, ..., 2]) > min_score
    cnt = ok.sum(-1)
    tot = torch.where(ok, d, torch.zeros_like(d)).sum(-1)
    return torch.where(cnt > 0, tot / cnt.clamp(min=1), torch.full_like(tot, float("nan")))


def _sigmoid_sim(dst, valid2, mean, std, scale):
    return torch.where(valid2, torch.sigmoid(-scale * (dst - mean) / std), torch.zeros_like(dst))


def _st_matrix(rc: RefContext, kps, valid, alive, d23, views, real) -> torch.Tensor:
    """The spatial-time matrix of one camera subset, rounded to float32."""
    c, T = rc.cfg, rc.T
    k, v_ok = kps[views], valid[views] & real[:, None]
    Fs = rc.t(rc.F_det)[views][:, views]
    V = len(views)
    d22 = _epipolar_pairs(k, Fs, c["epipolar_min_kps_score"])
    same = torch.eye(V, dtype=torch.bool, device=rc.device)[:, None, :, None]
    pair = v_ok[:, :, None, None] & v_ok[None, None]
    d22 = torch.where(same | ~pair, torch.full_like(d22, float("nan")), d22)
    d23v = torch.where(v_ok[None], d23[:, views], torch.full_like(d23[:, views], float("nan")))
    d23v = d23v.reshape(T, -1)
    nan = torch.full((T, T), float("nan"), dtype=rc.tdt, device=rc.device)
    dst = torch.cat([torch.cat([nan, d23v], 1),
                     torch.cat([d23v.T, d22.reshape(V * rc.P, -1)], 1)])
    ev = torch.cat([alive, v_ok.reshape(-1)])
    valid2 = ev[:, None] & ev[None]
    n = dst.shape[0]
    dst = torch.where(torch.eye(n, dtype=torch.bool, device=rc.device), torch.zeros_like(dst), dst)
    fin = valid2 & ~torch.isnan(dst)
    mx = dst[fin].max() if bool(fin.any()) else torch.zeros((), dtype=rc.tdt, device=rc.device)
    dst = torch.where(torch.isnan(dst), mx + 1.0, dst)
    sim = _sigmoid_sim(dst, valid2, c["st_norm_mean"], c["st_norm_std"],
                       c["affinity_sigmoid_scale"])
    sim = torch.where(sim < c["st_sim_floor"], torch.zeros_like(sim), sim).clamp(max=1.0)
    return sim.to(torch.float32)


def _spatial_matrix(rc: RefContext, kps, valid, views, real) -> torch.Tensor:
    """The spatial-only matrix of one camera subset (track rows empty),
    rounded to float32."""
    c, T, P = rc.cfg, rc.T, rc.P
    k, v_ok = kps[views], valid[views] & real[:, None]
    F = rc.t(rc.F_sp)[views][:, views]
    V = len(views)
    x = _homo(k[..., :2])
    lines = _unit_lines(torch.einsum("abyx,apky->abpkx", F, x))      # F_ab^T x_a
    d = torch.einsum("abpkx,bqkx->abpqk", lines, x).abs().mean(-1)  # (a, b, p, q)
    d = (0.5 * (d + d.permute(1, 0, 3, 2))).permute(0, 2, 1, 3)     # (a, p, b, q)
    same = torch.eye(V, dtype=torch.bool, device=rc.device)[:, None, :, None]
    d = torch.where(same, torch.full_like(d, c["spatial_fill_distance"]), d)
    dst = d.reshape(V * P, V * P)
    eye = torch.eye(V * P, dtype=torch.bool, device=rc.device)
    dst = torch.where(eye, torch.zeros_like(dst), dst)
    dv = v_ok.reshape(-1)
    valid2 = dv[:, None] & dv[None]
    cnt = valid2.sum().clamp(min=1)
    zero = torch.zeros_like(dst)
    mean = torch.where(valid2, dst, zero).sum() / cnt
    std = torch.sqrt(torch.where(valid2, (dst - mean) ** 2, zero).sum() / cnt).clamp(min=1e-6)
    sim = torch.zeros((T + V * P,) * 2, dtype=rc.tdt, device=rc.device)
    sim[T:, T:] = _sigmoid_sim(dst, valid2, mean, std, c["affinity_sigmoid_scale"])
    return sim.to(torch.float32)


# ---------------------------------------------------------------------------
# ALS multi-way matching (torch, batched over problems)
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, as the tensor
    cores round a product's operands."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def als(rc: RefContext, W: torch.Tensor):
    """ALS low-rank matching of the problems W (C, n, n) (float32 inputs,
    solved in the work precision), each stopping at its own test: the
    residuals below `als_tol`, or the binarisation unchanged for
    `als_stable_iters` iterations, or `als_max_iter`.  The problems iterate
    together; each one's result is taken at its own stop.  Returns x_bin
    (C, n, n) bool and the iterations (C,)."""
    c = rc.cfg
    dt, dev = rc.tdt, rc.device
    C, n, _ = W.shape
    W = W.to(dt)
    W = 0.5 * (W + W.transpose(1, 2))
    X, Z, Y = W.clone(), W.clone(), torch.zeros_like(W)
    A = rc.t(rc.init).expand(C, -1, -1).clone()                  # (C, n, r)
    off_block = torch.as_tensor(~rc.mask, device=dev).to(dt)     # no same-group matches
    eye_n = torch.eye(n, dtype=dt, device=dev)                   # the diagonal held at 1
    eye_r = torch.eye(A.shape[-1], dtype=dt, device=dev)
    alpha, beta, tol = float(c["als_alpha"]), float(c["als_beta"]), float(c["als_tol"])
    stable_iters, max_iter = int(c["als_stable_iters"]), int(c["als_max_iter"])
    mm = (lambda a, b: _tf32(a) @ _tf32(b)) if rc.als_tf32 else torch.matmul

    def ridge(F, R, lam):
        """argmin_S |R - F^T S|^2 + lam |S|^2 = (F F^T + lam I)^-1 F R."""
        L = torch.linalg.cholesky_ex(mm(F, F.transpose(1, 2)) + lam * eye_r)[0]
        return torch.cholesky_solve(mm(F, R), L)

    mu = [float(c["als_mu"])] * C
    stable = [0] * C
    iters = [max_iter] * C
    out = torch.zeros_like(W)
    for it in range(max_iter):
        m = torch.tensor(mu, dtype=dt, device=dev)[:, None, None]
        Xs = Z - (Y - W + beta) / m
        lam = (alpha / m)
        B = ridge(A.transpose(1, 2), Xs, lam)                    # (C, r, n)
        A = ridge(B, Xs.transpose(1, 2), lam).transpose(1, 2)    # (C, n, r)
        X_new = mm(A, B)
        Z = ((X_new + Y / m) * off_block + eye_n).clamp(0.0, 1.0)
        dz = X_new - Z
        Y = Y + m * dz
        res = torch.stack([torch.linalg.vector_norm(dz, dim=(1, 2)),
                           torch.linalg.vector_norm(X_new - X, dim=(1, 2)),
                           ((X_new > 0.5) != (X > 0.5)).sum(dim=(1, 2)).to(dt)], 1).tolist()
        X = X_new
        for k, (p_norm, d_norm, flips) in enumerate(res):
            if iters[k] < max_iter:
                continue
            p_res, d_res = p_norm / n, mu[k] * d_norm / n
            stable[k] = stable[k] + 1 if flips == 0 else 0
            if (p_res < tol and d_res < tol) or (stable_iters > 0 and stable[k] >= stable_iters):
                iters[k] = it + 1
                out[k] = X[k]
            mu[k] = 2 * mu[k] if p_res > 10 * d_res else (mu[k] / 2 if d_res > 10 * p_res
                                                            else mu[k])
        if all(i < max_iter for i in iters):
            break
    for k in range(C):
        if iters[k] == max_iter:
            out[k] = X[k]
    out = 0.5 * (out + out.transpose(1, 2))
    return (out > 0.5).cpu().numpy(), np.asarray(iters)


# ---------------------------------------------------------------------------
# groups, triangulation (NumPy, in the work precision)
# ---------------------------------------------------------------------------

def groups(x: np.ndarray, ev: np.ndarray):
    """Connected components of the valid part of the symmetric relation x:
    each element's representative (its component's lowest index; n for an
    invalid element), the component sizes and membership (valid, size >= 2)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(ev)
    adj = x & ev[:, None] & ev[None]
    _, comp = connected_components(csr_matrix(adj), directed=False)
    low = np.full(comp.max() + 1, n)
    np.minimum.at(low, comp, np.arange(n))
    rep = np.where(ev, low[comp], n)
    size = np.bincount(comp, minlength=comp.max() + 1)[comp]
    gsize = np.where(ev, size, 0)
    return rep, gsize, ev & (gsize >= 2)


def triangulate(P: np.ndarray, Kinv: np.ndarray, obs: np.ndarray, vmask: np.ndarray,
                min_score: float, refine: int, work) -> np.ndarray:
    """Per problem (leading dim B) and keypoint: DLT over the views whose
    score passes `min_score` (all masked views when fewer than two do), then
    `refine` Gauss-Newton steps on the score-weighted pixel residual.
    P (B, V, 3, 4), Kinv (B, V, 3, 3), obs (B, V, K, 3), vmask (B, V).
    Returns (B, K, 4): the point and the mean score of the views used; and
    (B, K) the condition number of the last step's normal matrix (1 without
    a step), which bounds how far two float64 orders of operations part."""
    P, Kinv, obs = P.astype(work), Kinv.astype(work), obs.astype(work)
    vm = vmask.astype(work)
    s = obs[..., 2] * vm[..., None]                                  # (B, V, K)
    good = (obs[..., 2] >= min_score) & vmask[..., None]
    fallback = good.sum(1) < 2                                       # (B, K)
    w = np.where(fallback[:, None, :], np.broadcast_to(vm[..., None], s.shape), good.astype(work))
    out_score = (s * w).sum(1) / np.maximum(w.sum(1), 1.0)
    Pn = Kinv @ P                                                    # (B, V, 3, 4)
    xyn = np.einsum("bvij,bvkj->bvki", Kinv, np.concatenate(
        [obs[..., :2], np.ones_like(obs[..., :1])], -1))
    xy = xyn[..., :2] / (xyn[..., 2:3] + 1e-12)                      # (B, V, K, 2)
    r1 = xy[..., 0:1] * Pn[:, :, None, 2, :] - Pn[:, :, None, 0, :]  # (B, V, K, 4)
    r2 = xy[..., 1:2] * Pn[:, :, None, 2, :] - Pn[:, :, None, 1, :]
    M = (np.einsum("bvki,bvkj,bvk->bkij", r1, r1, w)
         + np.einsum("bvki,bvkj,bvk->bkij", r2, r2, w))
    _, vecs = np.linalg.eigh(M)
    h = vecs[..., :, 0]
    h3 = np.where(np.abs(h[..., 3]) < 1e-12, 1e-12, h[..., 3])
    X = h[..., :3] / h3[..., None]                                   # (B, K, 3)
    P2, P3 = P[:, :, :2, :3], P[:, :, 2, :3]
    cond = np.ones(X.shape[:2])
    for _ in range(refine):
        proj = np.einsum("bvij,bkj->bkvi", P, np.concatenate([X, np.ones_like(X[..., :1])], -1))
        wq = proj[..., 2:3] + 1e-6
        uv = proj[..., :2] / wq                                      # (B, K, V, 2)
        sk = s.transpose(0, 2, 1)                                    # (B, K, V)
        res = (uv - obs[..., :2].transpose(0, 2, 1, 3)) * sk[..., None]
        J = ((P2[:, None] - uv[..., None] * P3[:, None, :, None, :]) / wq[..., None]
             * sk[..., None, None])                                  # (B, K, V, 2, 3)
        Jf = J.reshape(J.shape[0], J.shape[1], -1, 3)
        A = np.einsum("bkri,bkrj->bkij", Jf, Jf) + 1e-8 * np.eye(3, dtype=work)
        g = np.einsum("bkri,bkr->bki", Jf, res.reshape(res.shape[0], res.shape[1], -1))
        X = X - np.linalg.solve(A, g[..., None])[..., 0]
        cond = np.linalg.cond(A)
    return np.concatenate([X, out_score[..., None]], -1), cond


def add_mid_spine(obs: np.ndarray) -> np.ndarray:
    """COCO-17 -> 18 with the mid-spine, formed in float32 from the float32
    detections (an observation, in the input's precision): the midpoint of
    the shoulder and hip centres, scored by the product of the four scores."""
    obs = obs.astype(np.float32)
    half = np.float32(0.5)
    sh = half * (obs[..., LSH, :2] + obs[..., RSH, :2])
    hip = half * (obs[..., LHIP, :2] + obs[..., RHIP, :2])
    xy = half * (sh + hip)
    sc = obs[..., LSH, 2] * obs[..., RSH, 2] * obs[..., LHIP, 2] * obs[..., RHIP, 2]
    return np.concatenate([obs, np.concatenate([xy, sc[..., None]], -1)[..., None, :]], -2)


# ---------------------------------------------------------------------------
# one frame
# ---------------------------------------------------------------------------

def associate(rc: RefContext, st: RefState, kps_np: np.ndarray, valid_np: np.ndarray):
    """Steps 2-3: the global binarised match matrix, the valid elements, the
    track -> detection distances (T, V, P) and the ALS iterations."""
    c, T, V, P = rc.cfg, rc.T, rc.V, rc.P
    kps = rc.t(kps_np)
    valid = torch.as_tensor(valid_np, device=rc.device)
    alive_np = st.active > 0
    any_alive = bool(alive_np.any())
    alive = torch.as_tensor(alive_np, device=rc.device)
    d23 = _reprojection(rc.t(st.pose3d[:, :K17]), rc.t(st.score[:, :K17]), kps,
                        rc.t(rc.P32), c["reproj_min_kps_score"])
    d23 = torch.where(alive[:, None, None] & valid[None], d23, torch.full_like(d23, float("nan")))
    mats = []
    for views, real in rc.clusters:
        real_t = torch.as_tensor(real, device=rc.device)
        vi = torch.as_tensor(views, device=rc.device)
        mats.append(_st_matrix(rc, kps, valid, alive, d23, vi, real_t) if any_alive
                    else _spatial_matrix(rc, kps, valid, vi, real_t))
    xb, iters = als(rc, torch.stack(mats))
    ev = np.concatenate([alive_np if any_alive else np.zeros(T, bool), valid_np.reshape(-1)])
    d23_np = d23.cpu().numpy()
    if rc.C == 1:
        return xb[0], ev, d23_np, int(iters.sum())
    # scatter the clusters into the global matrix
    C, Vc = rc.C, rc.Vc
    N = T + V * P
    x = np.zeros((N, N), bool)
    x[:T, :T] = xb[:, :T, :T].any(0)
    x_td = np.zeros((T, V, P), bool)
    x_dd = np.zeros((V, P, V, P), bool)
    for k, (views, real) in enumerate(rc.clusters):
        nr = int(real.sum())
        x_td[:, views[:nr]] = xb[k, :T, T:].reshape(T, Vc, P)[:, :nr]
        blk = xb[k, T:, T:].reshape(Vc, P, Vc, P)[:nr, :, :nr]
        x_dd[np.ix_(views[:nr], np.arange(P), views[:nr], np.arange(P))] = blk
    x[:T, T:] = x_td.reshape(T, -1)
    x[T:, :T] = x_td.reshape(T, -1).T
    x[T:, T:] = x_dd.reshape(V * P, V * P)
    # new people (detection-only groups of >= 2 views) linked across
    # clusters by their triangulated mean-keypoint centroids
    rep, _, member = groups(x, ev)
    rep_d, mem_d = rep[T:].reshape(V, P), member[T:].reshape(V, P)
    w = rc.work
    kw = kps_np.astype(w)
    on = kps_np[..., 2] > c["epipolar_min_kps_score"]
    mean_uv = (kw[..., :2] * on[..., None]).sum(2) / np.maximum(on.sum(-1), 1)[..., None]
    flat_rep, flat_mem = rep_d.reshape(-1), mem_d.reshape(-1)
    leaders = np.nonzero(flat_mem & (flat_rep == T + np.arange(V * P)))[0]
    hit = mem_d[None] & (rep_d[None] == (T + leaders)[:, None, None])   # (L, V, P)
    seen = hit.any(-1)                                                  # (L, V)
    ok_l = leaders[seen.sum(1) >= 2]
    hit, seen = hit[seen.sum(1) >= 2], seen[seen.sum(1) >= 2]
    if len(ok_l) > 1:
        # each view's first member's mean keypoint, triangulated (DLT only)
        first = hit.argmax(-1)                                           # (L, V)
        obs = np.zeros((len(ok_l), V, 1, 3), dtype=w)
        obs[:, :, 0, :2] = mean_uv[np.arange(V)[None], first]
        obs[:, :, 0, 2] = seen
        Pb = np.broadcast_to(rc.P32, (len(ok_l),) + rc.P32.shape)
        Kb = np.broadcast_to(rc.Kinv32, (len(ok_l),) + rc.Kinv32.shape)
        cents = triangulate(Pb, Kb, obs, seen, 0.5, 0, w)[0][:, 0, :3]
        cl = ok_l // P % C
        d = np.linalg.norm(cents[:, None] - cents[None], axis=-1)
        link = (d < c["cluster_merge_m"]) & (cl[:, None] != cl[None])
        i, j = np.nonzero(link)
        x[T + ok_l[i], T + ok_l[j]] = True
    return x, ev, d23_np, int(iters.sum())


def step(rc: RefContext, st: RefState, kps: np.ndarray, valid: np.ndarray):
    """One frame from state `st`: returns the new state and the frame's
    outputs (`track_id`, `active`, `updated`, `spawned`, `died_track_id`,
    `pose3d`, `pose3d_score`, `root`, `matched_pose`, `als_iters`), and the
    touched slots' poses and scores before their rounding to float32
    (`pose3d_exact`, `score_exact`) with each joint's condition number
    (`pose_cond`)."""
    c, T, V, P = rc.cfg, rc.T, rc.V, rc.P
    w = rc.work
    N = T + V * P
    st = st._replace(tsu=st.tsu + (st.active > 0))              # 1. predict
    x, ev, d23, n_iters = associate(rc, st, kps, valid)
    any_alive = bool((st.active > 0).any())
    rep, gsize, member = groups(x, ev)
    det_rep, det_mem = rep[T:].reshape(V, P), member[T:].reshape(V, P)

    def first_match(keys):
        cand = det_mem[None] & (det_rep[None] == np.asarray(keys)[:, None, None])
        ex = cand.any(-1)
        return np.where(ex, cand.argmax(-1), -1), ex

    slots = np.arange(T)
    t_lead = member[:T] & (rep[:T] == slots)
    t_match, t_ex = first_match(slots)
    t_match = np.where(t_lead[:, None], t_match, -1)
    t_ex = t_ex & t_lead[:, None]
    nv = t_ex.sum(1)
    upd = t_lead & (nv >= 2)
    in_dict = t_lead & (nv >= 1)

    # rescue: a confirmed track about to die adopts its nearest unclaimed
    # detection's group within the gate, unless another track is as close
    claimed = np.zeros(N, bool)
    if c["track_rescue_px"] > 0:
        would_die = (st.active == CONFIRMED) & ~in_dict
        rep_det = rep[T:]
        adoptable = valid.reshape(-1) & (rep_det >= T)
        single = c["track_rescue_single_px"]
        single = c["track_rescue_px"] if single is None else single
        gate = np.where(gsize[T:] >= 2, c["track_rescue_px"], single)
        df = d23.reshape(T, V * P)
        fin = np.isfinite(df)
        dflat = np.where(adoptable[None] & fin & (df < gate[None]), df, np.inf)
        best_e = dflat.argmin(1)
        best_d = dflat.min(1)
        cand = would_die & np.isfinite(best_d) & any_alive
        if c["track_rescue_ambiguity"] > 0:
            dfin = np.where(fin, df, np.inf)
            m1, am1 = dfin.min(0), dfin.argmin(0)
            m2 = np.where(slots[:, None] == am1[None], np.inf, dfin).min(0)
            comp = np.where(am1[None] == slots[:, None], m2[None], m1[None])
            cand = cand & (comp[slots, best_e] > c["track_rescue_ambiguity"] * best_d)
        best_key = rep_det[best_e]
        earlier = np.tril(np.ones((T, T), bool), -1)
        same = (best_key[:, None] == best_key[None]) & cand[None] & earlier
        adopt = cand & ~same.any(1)
        claimed = ((best_key[:, None] == np.arange(N)[None]) & adopt[:, None]).any(0)
        a_match, a_ex = first_match(best_key)
        a_ex = a_ex & adopt[:, None]
        bv, bp = best_e // P, best_e % P
        lone = adopt & ~a_ex.any(1)
        at = np.arange(V)[None] == bv[:, None]
        a_match = np.where(lone[:, None] & at, bp[:, None], a_match)
        a_ex = a_ex | (lone[:, None] & at)
        t_match = np.where(adopt[:, None], np.where(a_ex, a_match, -1), t_match)
        t_ex = np.where(adopt[:, None], a_ex, t_ex)
        upd = upd | (adopt & (a_ex.sum(1) >= 2))
        in_dict = in_dict | adopt

    alive = st.active > 0                                        # deaths
    dies = alive & ~in_dict & ((st.active == TENTATIVE) | (st.tsu > c["max_age"]))
    died = np.where(dies, st.track_id, -1)
    act = np.where(dies, FREE, st.active)

    e_idx = np.arange(T, N)                                      # spawns
    d_lead = member[T:] & (rep[T:] == e_idx) & ~claimed[T:]
    s_all, s_ex_all = first_match(e_idx)
    spawn_ok = d_lead & (s_ex_all.sum(1) >= 2)
    free = np.nonzero(act == FREE)[0]
    spawned = np.zeros(T, bool)
    s_match = np.full((T, V), -1)
    for rank, e in enumerate(np.nonzero(spawn_ok)[0][:len(free)]):
        spawned[free[rank]] = True
        s_match[free[rank]] = s_all[e]
    s_ex = s_match >= 0

    def gather(match, ex):
        obs = kps[np.arange(V)[None], np.maximum(match, 0)]     # (T, V, 17, 3)
        return obs * ex[..., None, None], ex.astype(np.float32)

    u_obs, u_w = gather(t_match, t_ex)
    u_w = u_w * upd[:, None]
    n_obs, n_w = gather(s_match, s_ex)
    n_w = n_w * spawned[:, None]
    P_all = np.broadcast_to(rc.P32, (T,) + rc.P32.shape)
    K_all = np.broadcast_to(rc.Kinv32, (T,) + rc.Kinv32.shape)
    k = c["ik_max_views"]
    if k is not None and k < V:
        # updates triangulate from their k best views (summed scores + weight)
        score = u_obs[..., 2].astype(np.float64).sum(-1) + u_w
        idx = np.argsort(-score, axis=1, kind="stable")[:, :k]
        u_obs = np.take_along_axis(u_obs, idx[:, :, None, None], 1)
        u_w = np.take_along_axis(u_w, idx, 1)
        P_u, K_u = rc.P32[idx], rc.Kinv32[idx]
    else:
        P_u, K_u = P_all, K_all
    tri_u, cond_u = triangulate(P_u, K_u, add_mid_spine(u_obs), u_w > 0,
                                c["triangulate_min_score"], c["triangulate_refine_iters"], w)
    tri_n, cond_n = triangulate(P_all, K_all, add_mid_spine(n_obs), n_w > 0,
                                c["triangulate_min_score"], c["triangulate_refine_iters"], w)
    tri_n = np.clip(np.nan_to_num(tri_n), -100.0, 100.0)
    exact = np.where(spawned[:, None, None], tri_n, np.where(upd[:, None, None], tri_u, 0.0))
    cond = np.where(spawned[:, None], cond_n, np.where(upd[:, None], cond_u, 1.0))
    tri = exact.astype(np.float32)
    touched = upd | spawned
    pose = np.where(touched[:, None, None], tri[..., :3], st.pose3d)
    score = np.where(touched[:, None], tri[..., 3], st.score)
    root = np.where(touched[:, None], (0.5 * (pose[:, LHIP] + pose[:, RHIP])).astype(np.float32),
                    st.root)

    hits = np.where(spawned, 1, np.where(upd, st.hits + 1, st.hits))
    tsu = np.where(touched, 0, st.tsu)
    promoted = (act == TENTATIVE) & upd & (hits >= c["n_init_hits"])
    active = np.where(spawned, TENTATIVE, np.where(promoted, CONFIRMED, act))
    new_ids = st.next_id + np.cumsum(spawned) - 1
    track_id = np.where(spawned, new_ids, np.where(active > 0, st.track_id, -1))
    new = RefState(active=active, track_id=track_id, hits=hits, tsu=tsu, pose3d=pose,
                   score=score, root=root, next_id=int(st.next_id + spawned.sum()))
    out = dict(track_id=track_id, active=active, updated=touched, spawned=spawned,
               died_track_id=died, pose3d=pose, pose3d_score=score, root=root,
               pose3d_exact=exact[..., :3], score_exact=exact[..., 3], pose_cond=cond,
               matched_pose=np.where(spawned[:, None], s_match, t_match), als_iters=n_iters)
    return new, out
