"""A deliberately slow, loop-based numpy/scipy oracle of the reference
pipeline semantics (SURVEY.md §3.2): a copy of `tests/oracle_pipeline.py`
that takes its camera, skeleton and keypoint-format constants from the
PyTorch port (`multiview_motion_capture_torch.cameras`, `ops/fk`,
`pose_def`), so the port's studies and tests use it without the JAX
package.  The program is the same host float64 program.

Written from the documented behavior (nan-sentinel distance matrix, ADMM/ALS
multi-way matching, group parsing, tentative/confirmed lifecycle, two-stage
scipy-TRF IK on score-weighted reprojection residuals) — this is the
"fresh CPU reference run" that SURVEY.md §4 says parity must be judged
against, since the shipped golden pickle used different calibration.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
from scipy.optimize import least_squares

from multiview_motion_capture_torch.cameras import (
    pairwise_fundamental_det_np,
    pairwise_fundamental_np,
)
from multiview_motion_capture_torch.ops.fk import (
    REF_BONE_DIRS,
    REF_SIDE_BONE_LENS,
    SIDE_TO_FULL,
)
from multiview_motion_capture_torch.pose_def import (
    BASIC_18_PARENTS,
    IK_OBS_KPS_IDX,
    IK_SKEL_KPS_IDX,
    KpsFormat,
    common_kps_index,
)

PARENTS = np.asarray(BASIC_18_PARENTS)
SKEL_SEL = np.asarray(IK_SKEL_KPS_IDX)   # 16 joints, COCO+spine rows
OBS_SEL = np.asarray(IK_OBS_KPS_IDX)
# 15 joints shared between BASIC_18 and plain COCO (for 3D->2D matching)
M_SKEL_SEL, M_OBS_SEL = common_kps_index(KpsFormat.BASIC_18, KpsFormat.COCO)


# --- geometry -----------------------------------------------------------

def _norm_lines(L):
    return L / (np.linalg.norm(L[:, :2], axis=1, keepdims=True) + 1e-12)


def epipolar_error(kps_a, kps_b, F_ab, gate=0.1):
    ha = np.concatenate([kps_a[:, :2], np.ones((len(kps_a), 1))], 1)
    hb = np.concatenate([kps_b[:, :2], np.ones((len(kps_b), 1))], 1)
    d = 0.5 * (np.abs(np.sum(_norm_lines(ha @ F_ab.T) * hb, 1)) +
               np.abs(np.sum(_norm_lines(hb @ F_ab) * ha, 1)))
    v = (kps_a[:, 2] * kps_b[:, 2]) > gate
    return float(d[v].mean()) if v.any() else np.nan


def reproj_error(X, s3, kps2d, P, gate=0.1):
    homo = np.concatenate([X, np.ones((len(X), 1))], 1)
    uvw = homo @ P.T
    uv = uvw[:, :2] / (1e-5 + uvw[:, 2:3])
    d = np.linalg.norm(uv - kps2d[:, :2], axis=1)
    v = (s3 * kps2d[:, 2]) > gate
    return float(d[v].mean()) if v.any() else np.nan


def triangulate(Pmats, obs, min_score=0.01):
    """Score-gated DLT with all-views fallback + tiny reprojection polish."""
    K = obs.shape[1]
    out = np.zeros((K, 4))
    for k in range(K):
        good = [v for v in range(len(Pmats)) if obs[v, k, 2] >= min_score]
        use = good if len(good) >= 2 else list(range(len(Pmats)))
        score = obs[use, k, 2].mean() if len(good) >= 2 else obs[:, k, 2].mean()
        A = []
        for v in use:
            x, y = obs[v, k, :2]
            A.append(x * Pmats[v][2] - Pmats[v][0])
            A.append(y * Pmats[v][2] - Pmats[v][1])
        _, _, vh = np.linalg.svd(np.asarray(A))
        h = vh[-1]
        out[k, :3] = h[:3] / h[3]
        out[k, 3] = score

    def resid(x):
        pts = x.reshape(-1, 3)
        r = []
        for v in range(len(Pmats)):
            homo = np.concatenate([pts, np.ones((K, 1))], 1)
            uvw = homo @ Pmats[v].T
            uv = uvw[:, :2] / (uvw[:, 2:3] + 1e-6)
            r.append(np.linalg.norm(uv - obs[v, :, :2], axis=1) * obs[v, :, 2])
        return np.concatenate(r)

    res = least_squares(resid, out[:, :3].ravel(), max_nfev=2)
    out[:, :3] = res.x.reshape(-1, 3)
    return out


# --- FK / IK (scipy TRF, reference iteration budgets) ---------------------

def fk(root, euler, side_lens):
    full = side_lens[SIDE_TO_FULL]
    offs = REF_BONE_DIRS * full[:, None]

    def rot(e):
        cx, cy, cz = np.cos(e)
        sx, sy, sz = np.sin(e)
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return rx @ ry @ rz

    g = [None] * 18
    for j in range(18):
        l = np.eye(4)
        l[:3, :3] = rot(euler[j])
        l[:3, 3] = root if j == 0 else offs[j]
        g[j] = l if j == 0 else g[PARENTS[j]] @ l
    return np.stack([t[:3, 3] for t in g])


def add_mid_spine(obs17):
    sp_xy = 0.5 * (0.5 * (obs17[5, :2] + obs17[6, :2]) + 0.5 * (obs17[11, :2] + obs17[12, :2]))
    sp_s = obs17[5, 2] * obs17[6, 2] * obs17[11, 2] * obs17[12, 2]
    return np.concatenate([obs17, [[sp_xy[0], sp_xy[1], sp_s]]], axis=0)


def ik_solve(obs_views, Pmats, init=None, n_iter=None):
    """Two-stage pose / pose+bone-length solve on reprojection residuals."""
    obs = np.stack([add_mid_spine(o) for o in obs_views])  # (V, 18, 3)
    V = len(Pmats)

    if init is None:
        tri = triangulate(Pmats, obs)
        root0 = 0.5 * (tri[11, :3] + tri[12, :3])
        euler0 = np.zeros((18, 3))
        side0 = REF_SIDE_BONE_LENS.copy()
        n_iter = n_iter or 50
    else:
        root0, euler0, side0 = init
        n_iter = n_iter or 5

    tgt = obs[:, OBS_SEL, :]

    def resid(root, euler, side):
        X = fk(root, euler, side)[SKEL_SEL]
        r = []
        for v in range(V):
            homo = np.concatenate([X, np.ones((len(X), 1))], 1)
            uvw = homo @ Pmats[v].T
            uv = uvw[:, :2] / (1e-5 + uvw[:, 2:3])
            r.append(((uv - tgt[v, :, :2]) * tgt[v, :, 2:3]).ravel())
        return np.concatenate(r)

    def r1(x):
        return resid(x[:3], x[3:57].reshape(18, 3), side0)

    res1 = least_squares(r1, np.concatenate([root0, euler0.ravel()]), max_nfev=n_iter)
    root1, euler1 = res1.x[:3], res1.x[3:57].reshape(18, 3)

    def r2(x):
        return resid(x[:3], x[3:57].reshape(18, 3), x[57:])

    res2 = least_squares(r2, np.concatenate([root1, euler1.ravel(), side0]),
                         max_nfev=n_iter)
    root2, euler2, side2 = res2.x[:3], res2.x[3:57].reshape(18, 3), res2.x[57:]
    return (root2, euler2, side2), fk(root2, euler2, side2)


# --- ALS matching ---------------------------------------------------------

def match_als_np(W, offsets, max_iter=1000, stable_iters=10):
    n = W.shape[0]
    rank = min(n, 2 * max(np.diff(offsets))) if len(offsets) > 1 else n
    W = 0.5 * (W + W.T)
    X, Z, Y = W.copy(), W.copy(), np.zeros_like(W)
    mu, alpha, beta = 64.0, 50.0, 0.1
    A = np.random.RandomState(0).rand(n, rank)
    stable = 0
    for _ in range(max_iter):
        X0, bin0 = X.copy(), X > 0.5
        X = Z - (Y - W + beta) / mu
        B = (np.linalg.solve(A.T @ A + alpha / mu * np.eye(rank), A.T @ X)).T
        A = (np.linalg.solve(B.T @ B + alpha / mu * np.eye(rank), B.T @ X.T)).T
        X = A @ B.T
        Z = X + Y / mu
        for g in range(len(offsets) - 1):
            Z[offsets[g]:offsets[g + 1], offsets[g]:offsets[g + 1]] = 0
        np.fill_diagonal(Z, 1.0)
        Z = np.clip(Z, 0, 1)
        Y = Y + mu * (X - Z)
        p = np.linalg.norm(X - Z) / n
        d = mu * np.linalg.norm(X - X0) / n
        if p < 1e-4 and d < 1e-4:
            break
        stable = stable + 1 if np.array_equal(X > 0.5, bin0) else 0
        if stable >= stable_iters:
            break
        if p > 10 * d:
            mu *= 2
        elif d > 10 * p:
            mu /= 2
    X = 0.5 * (X + X.T)
    return X > 0.5


def groups_from_bin(x_bin):
    """True-transitive-closure grouping, first member leads."""
    n = len(x_bin)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(n):
        for j in range(i + 1, n):
            if x_bin[i, j] or x_bin[j, i]:
                ra, rb = find(i), find(j)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
    groups: Dict[int, List[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return [sorted(v) for k, v in sorted(groups.items()) if len(v) >= 2]


# --- the oracle tracker ----------------------------------------------------

@dataclasses.dataclass
class OracleTracklet:
    frames: List[int]
    params: List[tuple]
    poses: List[np.ndarray]
    matched: List[Dict[int, int]]   # view -> pose index per frame
    hits: int = 1
    tsu: int = 0
    state: int = 1  # 1 tentative 2 confirmed 3 dead


def run_oracle(kps, valid, cams, n_frames, use_ik=True,
               n_init=3, max_age=0):
    V = kps.shape[1]
    Pmats = np.asarray(cams.P, dtype=np.float64)
    F_det = pairwise_fundamental_det_np(Pmats)
    F_sp_src = np.asarray(cams.K, dtype=np.float64), np.asarray(cams.Rt, dtype=np.float64)
    F_sp = pairwise_fundamental_np(*F_sp_src)
    tracks: List[OracleTracklet] = []
    dead: List[OracleTracklet] = []

    for f in range(n_frames):
        for t in tracks:
            t.tsu += 1
        alive = [t for t in tracks if t.state != 3]

        dets = [(v, p) for v in range(V) for p in range(kps.shape[2]) if valid[f, v, p]]

        if alive:
            # spatial-time matrix
            elems = [("3d", i) for i in range(len(alive))] + [("2d", d) for d in dets]
            sizes = [len(alive)] + [sum(1 for v, p in dets if v == vv) for vv in range(V)]
            offsets = np.cumsum([0] + sizes)
            n = len(elems)
            dst = np.full((n, n), np.nan)
            for i in range(n):
                for j in range(n):
                    if i == j:
                        dst[i, j] = 0.0
                        continue
                    ki, xi = elems[i]
                    kj, xj = elems[j]
                    if ki == "2d" and kj == "2d":
                        (vi, pi), (vj, pj) = xi, xj
                        if vi == vj:
                            continue
                        dst[i, j] = epipolar_error(kps[f, vi, pi], kps[f, vj, pj], F_det[vi, vj])
                    elif (ki == "3d") != (kj == "3d"):
                        (vv, pp) = xi if ki == "2d" else xj
                        t = alive[xj if kj == "3d" else xi]
                        pose = t.poses[-1]
                        if use_ik:
                            # 18-joint FK pose: compare the COCO-visible rows
                            X = pose[M_SKEL_SEL]
                            s3 = np.ones(len(M_SKEL_SEL))
                            obs2d = kps[f, vv, pp][M_OBS_SEL]
                        else:
                            # COCO+spine triangulated pose with scores
                            X = pose[:17, :3]
                            s3 = pose[:17, 3] if pose.shape[1] == 4 else np.ones(17)
                            obs2d = kps[f, vv, pp]
                        dst[i, j] = reproj_error(X, s3, obs2d, Pmats[vv])
            finite = ~np.isnan(dst)
            maxv = dst[finite].max() if finite.any() else 0.0
            dst[np.isnan(dst)] = maxv + 1.0
            sim = 1.0 / (1.0 + np.exp(5 * (dst - 15.0) / 30.0))
            sim[sim < 1e-3] = 0.0
            sim = np.minimum(sim, 1.0)
        else:
            # spatial-only
            elems = [("2d", d) for d in dets]
            sizes = [sum(1 for v, p in dets if v == vv) for vv in range(V)]
            offsets = np.cumsum([0] + sizes)
            n = len(elems)
            dst = np.full((n, n), 50.0)
            np.fill_diagonal(dst, 0.0)
            for i in range(n):
                for j in range(n):
                    (vi, pi), (vj, pj) = elems[i][1], elems[j][1]
                    if i != j and vi != vj:
                        ha = np.concatenate([kps[f, vi, pi][:, :2], np.ones((17, 1))], 1)
                        hb = np.concatenate([kps[f, vj, pj][:, :2], np.ones((17, 1))], 1)
                        d1 = np.abs(np.sum(_norm_lines(ha @ F_sp[vi, vj]) * hb, 1)).mean()
                        d2 = np.abs(np.sum(_norm_lines(hb @ F_sp[vj, vi]) * ha, 1)).mean()
                        dst[i, j] = 0.5 * (d1 + d2)
            mean, std = dst.mean(), max(dst.std(), 1e-6)
            sim = 1.0 / (1.0 + np.exp(5 * (dst - mean) / std))

        if len(elems) > 0:
            x_bin = match_als_np(sim.astype(np.float64), offsets)
            groups = groups_from_bin(x_bin)
        else:
            groups = []

        matched_tracks = set()
        spawns = []
        for grp in groups:
            t_idx = next((elems[i][1] for i in grp if elems[i][0] == "3d"), None)
            picks: Dict[int, int] = {}
            for i in grp:
                if elems[i][0] == "2d":
                    v, p = elems[i][1]
                    picks.setdefault(v, p)  # first pose per view wins
            if t_idx is not None:
                matched_tracks.add(t_idx)
                if len(picks) >= 2:
                    t = alive[t_idx]
                    obs = [kps[f, v, p] for v, p in sorted(picks.items())]
                    Ps = [Pmats[v] for v in sorted(picks)]
                    if use_ik:
                        params, pose = ik_solve(obs, Ps, init=t.params[-1])
                    else:
                        params, pose = None, triangulate(
                            np.stack(Ps), np.stack([add_mid_spine(o) for o in obs]))[:, :3]
                    t.frames.append(f)
                    t.params.append(params)
                    t.poses.append(pose)
                    t.matched.append(dict(picks))
                    t.hits += 1
                    t.tsu = 0
                    if t.state == 1 and t.hits >= n_init:
                        t.state = 2
                # single-view match: no-op (alive, not missed)
            else:
                if len(picks) >= 2:
                    spawns.append(picks)

        for i, t in enumerate(alive):
            if i not in matched_tracks:
                if t.state == 1 or t.tsu > max_age:
                    t.state = 3

        for picks in spawns:
            obs = [kps[f, v, p] for v, p in sorted(picks.items())]
            Ps = [Pmats[v] for v in sorted(picks)]
            if use_ik:
                params, pose = ik_solve(obs, Ps, init=None)
            else:
                params, pose = None, triangulate(
                    np.stack(Ps), np.stack([add_mid_spine(o) for o in obs]))[:, :3]
            tracks.append(OracleTracklet([f], [params], [pose], [dict(picks)]))

        dead.extend(t for t in tracks if t.state == 3)
        tracks = [t for t in tracks if t.state != 3]

    return sorted(tracks + dead, key=lambda t: -len(t.frames))
