"""Fixed-capacity multi-view tracker: one step function per frame on tensors.

Port of `multiview_motion_capture_tpu/tracker.py` (the reference's
`MvTracker` state machine, ref:src/motion_capture.py:288-963, as a function
over a fixed-size slot-array state), every option: IK or
triangulation mode (`use_ik`), the constant-velocity association gate
(`cfg.motion_gain`) and appearance evidence (`cfg.appearance_dim > 0`, one
(V, P, D) embedding per detection and frame).  Association is one ALS solve
over the whole [tracklets | detections] matrix, or on wide rigs
(`cfg.assoc_clusters > 1`) one batched solve over interleaved camera
clusters merged into the global matrix; `cfg.ik_max_views` caps each
track's LM solve (or refined triangulation) at its best views.  Device
meshes (`TrackerContext.build(mesh=, cluster_mesh=, ik_mesh=)`, the
`parallel` package) spread the camera rows of the similarity blocks, the
cluster ALS solves and the per-slot LM solves over several devices.  Every
per-frame quantity stays on the step's device; the host reads two flags per
frame (whether any slot updates and whether any spawns) so that the LM
solves run only when needed, and the LM loop checks every few iterations
whether a slot is still active.  The JAX step's `lax.cond`s and LM
`while_loop`s give the same results: their outputs are selected per slot by
the same masks.  `run_offline` steps a whole sequence, `MvTracker` one
frame or one chunk at a time (the online mode).

Semantics parity map (ref:src/motion_capture.py):
- predict / time_since_update            :349-350, 874-875
- spatial-only matching (no live tracks) :597-631
- spatial-time matrix assembly           :634-756
- ALS + parse into groups                :758-808, 417-446
- tracklet update (>= 2 views)           :924-934  (single-view match = no-op)
- tracklet death (Tentative or age out)  :387-391
- spawn from >= 2-view spatial groups    :936-958
- IK per update (warm) / per spawn (cold):326-332, 361-368
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multiview_motion_capture_torch.cameras import (
    CameraBank,
    pairwise_fundamental_det_np,
    pairwise_fundamental_np,
)
from multiview_motion_capture_torch.config import PipelineConfig
from multiview_motion_capture_torch.ops import als_kernel
from multiview_motion_capture_torch.ops import association as assoc
from multiview_motion_capture_torch.ops import geometry as geom
from multiview_motion_capture_torch.ops import ik as ik_ops
from multiview_motion_capture_torch.ops.consts import on_device
from multiview_motion_capture_torch.ops.fk import Skeleton
from multiview_motion_capture_torch.ops.triangulate import triangulate_points
from multiview_motion_capture_torch.parallel.sharded_association import (
    sharded_affinity,
    sharded_st_epipolar,
)
from multiview_motion_capture_torch.parallel.sharded_solvers import (
    sharded_cluster_als,
    sharded_lm_solve,
)
from multiview_motion_capture_torch.pose_def import (
    KpsFormat,
    KpsType,
    common_kps_index,
    kps_index,
)
from multiview_motion_capture_torch.utils.precision import (
    WORK_DTYPE,
    high_precision,
    resolve_device,
)
from multiview_motion_capture_torch.utils.profiling import span

Tensor = torch.Tensor

# BASIC_18 joints observable in COCO (15: everything but Mid_Hip, Spine, Neck)
B18_COCO_SKEL_IDX, B18_COCO_OBS_IDX = common_kps_index(KpsFormat.BASIC_18, KpsFormat.COCO)
_COCO_IDX = kps_index(KpsFormat.COCO)
_LHIP, _RHIP = _COCO_IDX[KpsType.L_Hip], _COCO_IDX[KpsType.R_Hip]

FREE, TENTATIVE, CONFIRMED = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class TrackerState:
    """Slot-array tracker state (all shapes static; the JAX package's fields)."""

    active: Tensor             # (T,) int32: 0 free / 1 tentative / 2 confirmed
    track_id: Tensor           # (T,) int32
    hits: Tensor               # (T,) int32
    time_since_update: Tensor  # (T,) int32
    root: Tensor               # (T, 3)
    euler: Tensor              # (T, 18, 3)
    side_lens: Tensor          # (T, 11)
    pose3d: Tensor             # (T, 18, 3) current 3D pose (FK joints)
    pose3d_score: Tensor       # (T, 18)
    root_vel: Tensor           # (T, 3) EMA per-frame root velocity (cfg.motion_gain)
    app_ema: Tensor            # (T, D) EMA appearance embedding (zero-width when off)
    app_stats: Tensor          # (4,) auto-gain stats: EMA cos_same, cos_diff, weight,
                               # var(cos_same)
    next_track_id: Tensor      # () int32

    @classmethod
    def zeros(cls, cfg: PipelineConfig, device="cpu") -> "TrackerState":
        T = cfg.max_tracks

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            active=z(T, dtype=torch.int32),
            track_id=torch.full((T,), -1, dtype=torch.int32, device=device),
            hits=z(T, dtype=torch.int32),
            time_since_update=z(T, dtype=torch.int32),
            root=z(T, 3), euler=z(T, 18, 3), side_lens=z(T, 11),
            pose3d=z(T, 18, 3), pose3d_score=z(T, 18), root_vel=z(T, 3),
            app_ema=z(T, cfg.appearance_dim), app_stats=z(4),
            next_track_id=z(dtype=torch.int32),
        )

    def replace(self, **changes) -> "TrackerState":
        return dataclasses.replace(self, **changes)


_INT_FIELDS = ("active", "track_id", "hits", "time_since_update", "next_track_id")


def from_numpy_state(arrays: Dict[str, np.ndarray], device="cuda") -> TrackerState:
    """A `TrackerState` from the JAX package's state fields given as numpy
    arrays (e.g. `{f: np.asarray(getattr(jax_state, f)) for f in fields}`),
    the motion (`root_vel`) and appearance (`app_ema`, `app_stats`) state
    included."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(TrackerState):
        dt = torch.int32 if f.name in _INT_FIELDS else torch.float32
        kw[f.name] = torch.as_tensor(np.array(arrays[f.name]), dtype=dt, device=dev)
    return TrackerState(**kw)


class FrameOutput(NamedTuple):
    """Per-frame emission; host code reconstructs tracklets from the stack."""

    track_id: Tensor      # (T,) current id per slot (-1 if free)
    active: Tensor        # (T,) state after the update
    updated: Tensor       # (T,) bool — slot received a new pose this frame
    spawned: Tensor       # (T,) bool — slot was born this frame
    died_track_id: Tensor  # (T,) id of a track that died this frame (-1 none)
    root: Tensor          # (T, 3)
    euler: Tensor         # (T, 18, 3)
    side_lens: Tensor     # (T, 11)
    pose3d: Tensor        # (T, 18, 3)
    pose3d_score: Tensor  # (T, 18)
    matched_pose: Tensor  # (T, V) int32 matched detection slot per view (-1)
    app_obs: Tensor       # (T, D) this frame's matched-detection mean embedding per
                          # slot (unit rows, zero where none; zero-width when off)
    als_iters: Tensor     # () int32


def _check_config(cfg: PipelineConfig) -> None:
    """Every option of the JAX tracker is ported; what is left to check is
    the configuration itself."""
    if cfg.ik_solver not in ik_ops.SOLVERS:
        raise ValueError(f"ik_solver={cfg.ik_solver!r}; expected one of {ik_ops.SOLVERS}")
    if cfg.assoc_clusters > cfg.n_views:
        raise ValueError(f"assoc_clusters={cfg.assoc_clusters} exceeds n_views={cfg.n_views}")


class ClusterViews(NamedTuple):
    """One camera cluster of the hierarchical association: its views padded
    to the shared ceil width Vc (a short cluster repeats its first view),
    and which of them are real."""

    views: Tensor                  # (Vc,) int64 view indices
    view_valid: Optional[Tensor]   # (Vc,) bool, None when all Vc are real
    n_real: int


def cluster_layout(cfg: PipelineConfig) -> Tuple[int, List[Tuple[np.ndarray, Optional[np.ndarray]]]]:
    """Interleaved clusters (cluster c = views c, c + C, c + 2C, ...) at the
    ceil width Vc = ceil(V / C): returns Vc and, per cluster, its padded
    view indices and real-view mask (None when no view is a pad)."""
    V, C = cfg.n_views, cfg.assoc_clusters
    Vc = -(-V // C)
    out = []
    for c in range(C):
        views = np.arange(c, V, C)
        if len(views) < Vc:
            # pad the short cluster by repeating its first view with every
            # detection masked: it contributes nothing, as an invalid
            # detection does
            pad = np.full(Vc - len(views), views[0])
            out.append((np.concatenate([views, pad]), np.arange(Vc) < len(views)))
        else:
            out.append((views, None))
    return Vc, out


@dataclasses.dataclass(frozen=True)
class TrackerContext:
    """Static per-sequence context: config, cameras and constants on the
    step's device."""

    cfg: PipelineConfig
    cams: CameraBank
    skel: Skeleton
    F_spatial: Tensor   # (V, V, 3, 3) skew-formula F (spatial affinity)
    F_det: Tensor       # (V, V, 3, 3) minor-formula F (spatial-time epipolar)
    K_inv: Tensor       # (V, 3, 3)
    diag_mask: Tensor   # (N, N) bool same-group block mask for ALS
    init_A: Tensor      # (N, rank) seeded ALS init factor
    device: torch.device
    use_ik: bool = True
    # hierarchical association (cfg.assoc_clusters > 1): every cluster
    # matrix has the same [T | Vc * P] layout, so one mask and one init
    # factor serve all clusters
    cluster_diag_mask: Optional[Tensor] = None   # (Nc, Nc) bool
    cluster_init_A: Optional[Tensor] = None      # (Nc, rank)
    clusters: Tuple[ClusterViews, ...] = ()
    cluster_of_slot: Optional[Tensor] = None     # (V * P,) cluster of each detection slot
    # optional device meshes (parallel/): the camera rows of the epipolar
    # similarity blocks, the per-cluster ALS solves and the per-slot LM
    # solves, each over its own 1-axis mesh; with each, a copy of the
    # constants its devices read, on those devices (`mesh_consts`)
    mesh: object = None
    mesh_axis: str = "dp"
    cluster_mesh: object = None
    cluster_mesh_axis: str = "cl"
    ik_mesh: object = None
    ik_mesh_axis: str = "tk"
    mesh_consts: Optional[Dict[str, tuple]] = None

    @classmethod
    def build(cls, cams: CameraBank, cfg: PipelineConfig, use_ik: bool = True,
              device="cuda", mesh=None, mesh_axis: str = "dp", cluster_mesh=None,
              cluster_mesh_axis: str = "cl", ik_mesh=None,
              ik_mesh_axis: str = "tk") -> "TrackerContext":
        """The context on `device`; `mesh`, `cluster_mesh` and `ik_mesh`
        (`parallel.mesh.Mesh`es, each sharding on the named axis) spread
        the camera-sharded similarity, the cluster ALS and the per-slot LM
        over their devices."""
        with span("setup.context"):
            dev = resolve_device(device)
            _check_config(cfg)
            if cams.n_views != cfg.n_views:
                raise ValueError(f"cams has {cams.n_views} views, cfg.n_views={cfg.n_views}")
            high_precision()
            # host float64 from the f32 calibration, as the JAX context does
            K = cams.K.cpu().numpy().astype(np.float64)
            Rt = cams.Rt.cpu().numpy().astype(np.float64)
            P = cams.P.cpu().numpy().astype(np.float64)
            group_sizes = (cfg.max_tracks,) + (cfg.max_people,) * cfg.n_views
            consts = dict(
                F_spatial=pairwise_fundamental_np(K, Rt),
                F_det=pairwise_fundamental_det_np(P),
                K_inv=np.linalg.inv(K),
                diag_mask=assoc.block_diag_mask(group_sizes),
                init_A=assoc.default_init_factor(cfg.n_matrix, cfg.als_max_rank),
            )
            if cfg.assoc_clusters > 1:
                Vc, _ = cluster_layout(cfg)
                nc = cfg.max_tracks + Vc * cfg.max_people
                consts["cluster_diag_mask"] = assoc.block_diag_mask(
                    (cfg.max_tracks,) + (cfg.max_people,) * Vc)
                consts["cluster_init_A"] = assoc.default_init_factor(nc, cfg.als_max_rank)
            ctx = context_constants_from_numpy(cfg, cams, consts, use_ik=use_ik, device=dev)
            return ctx.with_meshes(mesh=mesh, mesh_axis=mesh_axis, cluster_mesh=cluster_mesh,
                                   cluster_mesh_axis=cluster_mesh_axis, ik_mesh=ik_mesh,
                                   ik_mesh_axis=ik_mesh_axis)

    def with_meshes(self, mesh=None, mesh_axis: str = "dp", cluster_mesh=None,
                    cluster_mesh_axis: str = "cl", ik_mesh=None,
                    ik_mesh_axis: str = "tk") -> "TrackerContext":
        """This context with the given device meshes, validated as the JAX
        package's `TrackerContext.build` validates them (same messages),
        and each mesh device's constants copied to it."""
        from multiview_motion_capture_torch.parallel import sharded_association as sa
        from multiview_motion_capture_torch.parallel.sharded_solvers import replicate

        cfg = self.cfg
        if mesh is not None and cfg.n_views % mesh.shape[mesh_axis] != 0:
            raise ValueError(
                f"n_views={cfg.n_views} not divisible by mesh axis "
                f"{mesh_axis}={mesh.shape[mesh_axis]}"
            )
        if cluster_mesh is not None:
            if cfg.assoc_clusters <= 1:
                raise ValueError("cluster_mesh needs assoc_clusters > 1")
            n_cl = cluster_mesh.shape[cluster_mesh_axis]
            if cfg.assoc_clusters % n_cl != 0:
                raise ValueError(
                    f"assoc_clusters={cfg.assoc_clusters} not divisible by "
                    f"cluster mesh axis {cluster_mesh_axis}={n_cl}"
                )
        if ik_mesh is not None:
            if not self.use_ik:
                raise ValueError("ik_mesh needs use_ik=True")
            n_tk = ik_mesh.shape[ik_mesh_axis]
            if cfg.max_tracks % n_tk != 0:
                raise ValueError(
                    f"max_tracks={cfg.max_tracks} not divisible by ik mesh "
                    f"axis {ik_mesh_axis}={n_tk}"
                )
        consts = {}
        if mesh is not None:
            # the blocks are formed in WORK_DTYPE, as the unsharded path forms them
            consts["F_spatial"] = sa.affinity_constants(self.F_spatial, mesh, mesh_axis,
                                                        WORK_DTYPE)
            consts["F_det"] = sa.st_epipolar_constants(self.F_det, mesh, mesh_axis,
                                                       WORK_DTYPE)
        if cluster_mesh is not None:
            devs = cluster_mesh.axis_devices(cluster_mesh_axis)
            consts["cluster_diag_mask"] = replicate(self.cluster_diag_mask, devs)
            consts["cluster_init_A"] = replicate(self.cluster_init_A, devs)
        if ik_mesh is not None:
            consts["skel"] = tuple(Skeleton(*(t.to(d) for t in self.skel))
                                   for d in ik_mesh.axis_devices(ik_mesh_axis))
        return dataclasses.replace(
            self, mesh=mesh, mesh_axis=mesh_axis, cluster_mesh=cluster_mesh,
            cluster_mesh_axis=cluster_mesh_axis, ik_mesh=ik_mesh,
            ik_mesh_axis=ik_mesh_axis, mesh_consts=consts or None)

    def to(self, device) -> "TrackerContext":
        """A copy of this context with its constants on `device` (its meshes
        and their per-device constants unchanged)."""
        dev = torch.device(device)

        def mv(t):
            return None if t is None else t.to(dev)

        return dataclasses.replace(
            self, cams=self.cams.to(dev), skel=Skeleton(*(t.to(dev) for t in self.skel)),
            F_spatial=mv(self.F_spatial), F_det=mv(self.F_det), K_inv=mv(self.K_inv),
            diag_mask=mv(self.diag_mask), init_A=mv(self.init_A), device=dev,
            cluster_diag_mask=mv(self.cluster_diag_mask),
            cluster_init_A=mv(self.cluster_init_A),
            clusters=tuple(ClusterViews(views=mv(c.views), view_valid=mv(c.view_valid),
                                        n_real=c.n_real) for c in self.clusters),
            cluster_of_slot=mv(self.cluster_of_slot))


def context_constants_from_numpy(cfg: PipelineConfig, cams: CameraBank,
                                 arrays: Dict[str, np.ndarray], use_ik: bool = True,
                                 device="cuda") -> TrackerContext:
    """A `TrackerContext` from context constants given as numpy arrays:
    `F_spatial`, `F_det`, `K_inv`, `diag_mask`, `init_A`, with
    `assoc_clusters > 1` also `cluster_diag_mask` and `cluster_init_A`, and
    optionally the Skeleton fields `bone_dirs`, `side_bone_lens` (else the
    default skeleton).  The JAX context's arrays carried across give a
    context whose step starts from the very same constants."""
    dev = resolve_device(device)
    _check_config(cfg)
    high_precision()

    def f32(a):
        return torch.as_tensor(np.array(a), dtype=torch.float32, device=dev)

    def mask(a):
        return torch.as_tensor(np.array(a), dtype=torch.bool, device=dev)

    skel = Skeleton.default(device=dev)
    if "bone_dirs" in arrays:
        skel = skel._replace(bone_dirs=f32(arrays["bone_dirs"]),
                             side_bone_lens=f32(arrays["side_bone_lens"]))
    cluster = {}
    if cfg.assoc_clusters > 1:
        missing = {"cluster_diag_mask", "cluster_init_A"} - set(arrays)
        if missing:
            raise ValueError(f"assoc_clusters > 1 needs {sorted(missing)}")
        clusters = tuple(
            ClusterViews(views=torch.as_tensor(v, dtype=torch.long, device=dev),
                         view_valid=None if vv is None else mask(vv),
                         n_real=len(range(c, cfg.n_views, cfg.assoc_clusters)))
            for c, (v, vv) in enumerate(cluster_layout(cfg)[1]))
        cluster_of_slot = np.repeat(np.arange(cfg.n_views) % cfg.assoc_clusters,
                                    cfg.max_people)
        cluster = dict(cluster_diag_mask=mask(arrays["cluster_diag_mask"]),
                       cluster_init_A=f32(arrays["cluster_init_A"]).contiguous(),
                       clusters=clusters,
                       cluster_of_slot=torch.as_tensor(cluster_of_slot, device=dev))
    return TrackerContext(
        cfg=cfg, cams=cams.to(dev), skel=skel,
        F_spatial=f32(arrays["F_spatial"]), F_det=f32(arrays["F_det"]),
        K_inv=f32(arrays["K_inv"]),
        diag_mask=mask(arrays["diag_mask"]),
        init_A=f32(arrays["init_A"]).contiguous(),
        device=dev, use_ik=use_ik, **cluster,
    )


# ---------------------------------------------------------------------------
# similarity-matrix assembly
# ---------------------------------------------------------------------------

def _masked_sigmoid_similarity(dst: Tensor, valid2: Tensor, mean, std,
                               scale: float) -> Tensor:
    s = (dst - mean) / std
    return torch.where(valid2, torch.sigmoid(-scale * s), torch.zeros_like(s))


def _track_det_distances(ctx: TrackerContext, state: TrackerState, kps: Tensor,
                         det_valid: Tensor, P_mats: Optional[Tensor] = None) -> Tensor:
    """Tracklet -> detection reprojection distances d23 (T, V, P), NaN where
    either side is invalid (the 2D-3D block of ref:src/motion_capture.py:
    634-741; also feeds the track-rescue gate), in `WORK_DTYPE`.  IK mode
    holds the 15 BASIC_18 joints seen in COCO against their keypoints,
    triangulation mode (poses in COCO order plus the mid-spine) the 17 COCO
    joints.  With `cfg.motion_gain` each track first moves by its
    constant-velocity prediction.  `P_mats` (V, 3, 4): the cameras of
    `kps`' views (a cluster's), all cameras by default."""
    cfg = ctx.cfg
    if P_mats is None:
        P_mats = ctx.cams.P
    dev, wd = kps.device, WORK_DTYPE
    pose3d = state.pose3d.to(wd)
    if cfg.motion_gain:
        # rigid translation by the EMA root velocity, for the gate only
        # (time_since_update was already incremented this frame, so it is
        # the horizon)
        dt = state.time_since_update.to(wd)
        shift = cfg.motion_gain * dt[:, None] * state.root_vel.to(wd)   # (T, 3)
        pose3d = pose3d + shift[:, None, :]
    if ctx.use_ik:
        skel_idx = on_device(B18_COCO_SKEL_IDX, dev)
        pts = pose3d[:, skel_idx, :]                                  # (T, 15, 3)
        sc3 = state.pose3d_score[:, skel_idx].to(wd)
        obs = kps[:, :, on_device(B18_COCO_OBS_IDX, dev), :].to(wd)   # (V, P, 15, 3)
    else:
        pts = pose3d[:, :17, :]                                       # (T, 17, 3)
        sc3 = state.pose3d_score[:, :17].to(wd)
        obs = kps.to(wd)                                              # (V, P, 17, 3)
    d23 = geom.masked_reprojection_error(
        pts[:, None, None], sc3[:, None, None], obs[None],
        P_mats[None, :, None].to(wd), cfg.reproj_min_kps_score)  # (T, V, P)
    t_alive = state.active > 0
    return torch.where(t_alive[:, None, None] & det_valid[None],
                       d23, torch.full_like(d23, float("nan")))


def _appearance_gain(cfg: PipelineConfig, state: TrackerState):
    """The px-per-unit-cosine-distance gain of the appearance penalties
    (the JAX package's `_appearance_gain`, tracker.py:317-350): the static
    `cfg.appearance_gain_px`, or with `cfg.appearance_auto_target_px > 0`
    the gain derived online from the state's matched-vs-unmatched cosine
    statistics: target / max(gap, min_gap), capped by the noise rule
    noise_px / std(cos_same), clamped to [0, appearance_auto_max_px], 0
    when the gap is below `appearance_auto_min_gap` (no identity signal),
    the static gain until the stat weight reaches 0.5.  A python float
    (auto off) or a () tensor in `WORK_DTYPE`."""
    if cfg.appearance_auto_target_px <= 0:
        return cfg.appearance_gain_px
    cs, cd, w, vs = state.app_stats.to(WORK_DTYPE).unbind()
    gap = cs - cd
    auto = cfg.appearance_auto_target_px / gap.clamp(min=cfg.appearance_auto_min_gap)
    if cfg.appearance_auto_noise_px > 0:
        sd = torch.sqrt(vs.clamp(min=1e-12))
        auto = torch.minimum(auto, cfg.appearance_auto_noise_px / sd.clamp(min=1e-6))
    auto = auto.clamp(0.0, cfg.appearance_auto_max_px)
    auto = torch.where(gap >= cfg.appearance_auto_min_gap, auto, torch.zeros_like(auto))
    return torch.where(w >= 0.5, auto, torch.full_like(auto, cfg.appearance_gain_px))


def _cosines(a: Tensor, b: Tensor, spec: str, eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """Cosines between the rows of a and b (einsum `spec` over the last
    axis), in `WORK_DTYPE`, and where both rows are embeddings (norm above
    eps; a zero row is a detection or track without one)."""
    a, b = a.to(WORK_DTYPE), b.to(WORK_DTYPE)
    na = torch.linalg.vector_norm(a, dim=-1)
    nb = torch.linalg.vector_norm(b, dim=-1)
    lead_a, lead_b = na.dim(), nb.dim()
    na_b = na.reshape(na.shape + (1,) * lead_b)
    nb_b = nb.reshape((1,) * lead_a + nb.shape)
    cos = torch.einsum(spec, a, b) / (na_b.clamp(min=eps) * nb_b.clamp(min=eps))
    return cos, (na_b > eps) & (nb_b > eps)


def _appearance_penalty(gain, app_ema: Tensor, app: Tensor) -> Tensor:
    """Appearance term of the 2D-3D similarity block (tracker.py:352-367 of
    the JAX package): `gain` pixels per unit cosine distance between a
    track's EMA embedding and a detection's, zero where either side has
    none.  app_ema: (T, D); app: (V, P, D).  Returns (T, V, P) in
    `WORK_DTYPE`."""
    cos, has = _cosines(app_ema, app, "td,vpd->tvp")
    return torch.where(has, gain * (1.0 - cos), torch.zeros_like(cos))


def _appearance_penalty_d22(gain, app: Tensor) -> Tensor:
    """The same term between detection pairs, for the 2D-2D block
    (tracker.py:370-383 of the JAX package).  app: (V, P, D).  Returns
    (V, P, V, P) in `WORK_DTYPE`."""
    cos, has = _cosines(app, app, "vpd,wqd->vpwq")
    return torch.where(has, gain * (1.0 - cos), torch.zeros_like(cos))


def _select_views(ctx: TrackerContext, kps: Tensor, det_valid: Tensor, F: Tensor,
                  view_idx, view_valid, app: Optional[Tensor] = None):
    """kps, det_valid, the (V, V) block of F, the cameras and the embeddings
    restricted to a camera subset (a cluster; all views when `view_idx` is
    None); a view whose `view_valid` is False (a dead pad) has every
    detection masked."""
    if view_idx is None:
        return kps, det_valid, F, ctx.cams.P, app
    idx = torch.as_tensor(view_idx, dtype=torch.long, device=kps.device)
    det_valid = det_valid[idx]
    if view_valid is not None:
        vv = torch.as_tensor(view_valid, dtype=torch.bool, device=kps.device)
        det_valid = det_valid & vv[:, None]
    return (kps[idx], det_valid, F[idx][:, idx], ctx.cams.P[idx],
            None if app is None else app[idx])


def _spatial_time_similarity(ctx: TrackerContext, state: TrackerState, kps: Tensor,
                             det_valid: Tensor, view_idx=None, view_valid=None,
                             app: Optional[Tensor] = None,
                             app_gain=None) -> Tuple[Tensor, Tensor, Tensor]:
    """The spatial-time similarity matrix (ref:src/motion_capture.py:634-756),
    layout [T tracklet slots | view0 slots | view1 slots | ...].  `view_idx`
    restricts it to a camera subset (a cluster), `view_valid` marks that
    subset's dead pad views (see `_select_views`).  `app` (V, P, D)
    detection embeddings add the appearance penalties to the 2D-2D and the
    2D-3D blocks at `app_gain` (default `_appearance_gain` of the state);
    the returned d23 stays geometric.
    Returns (sim (N, N), elem_valid (N,), d23 (T, V, P)).

    Formed in `WORK_DTYPE` and rounded once to f32, as the spatial-only
    matrix below: given the same state, the card and the CPU give the ALS
    the same matrix."""
    cfg = ctx.cfg
    out_dt = kps.dtype
    kps, det_valid, F_det, P_mats, app = _select_views(ctx, kps, det_valid, ctx.F_det,
                                                       view_idx, view_valid, app)
    kps, F_det = kps.to(WORK_DTYPE), F_det.to(WORK_DTYPE)
    if app is not None and app_gain is None:
        app_gain = _appearance_gain(cfg, state)
    T, V, P = cfg.max_tracks, kps.shape[0], cfg.max_people
    N = T + V * P
    dev = kps.device
    nan = float("nan")

    # 2D-2D epipolar block (V, P, V, P); camera-sharded over ctx.mesh on
    # the full rig (a cluster's subset is never sharded)
    if ctx.mesh is not None and view_idx is None:
        d22 = sharded_st_epipolar(kps, F_det, cfg.epipolar_min_kps_score, ctx.mesh,
                                  ctx.mesh_axis, consts=ctx.mesh_consts["F_det"])
    else:
        ka = kps[:, :, None, None]
        kb = kps[None, None]
        Fab = F_det[:, None, :, None]
        d22 = geom.masked_symmetric_epipolar_error(ka, kb, Fab, cfg.epipolar_min_kps_score)
    if app is not None:
        d22 = d22 + _appearance_penalty_d22(app_gain, app)
    same_view = torch.eye(V, dtype=torch.bool, device=dev)[:, None, :, None]
    pair_valid = det_valid[:, :, None, None] & det_valid[None, None]
    d22 = torch.where(same_view | ~pair_valid, torch.full_like(d22, nan), d22)

    # tracklet -> 2D reprojection block (T, V, P)
    d23 = _track_det_distances(ctx, state, kps, det_valid, P_mats)
    t_alive = state.active > 0
    # appearance perturbs the similarity only; d23 itself stays geometric
    # (the rescue pass gates on physical pixels)
    d23_sim = d23 if app is None else d23 + _appearance_penalty(app_gain, state.app_ema, app)

    d23f = d23_sim.reshape(T, V * P)
    dst = torch.cat([
        torch.cat([torch.full((T, T), nan, dtype=kps.dtype, device=dev), d23f], dim=1),
        torch.cat([d23f.T, d22.reshape(V * P, V * P)], dim=1),
    ], dim=0)

    elem_valid = torch.cat([t_alive, det_valid.reshape(-1)])
    valid2 = elem_valid[:, None] & elem_valid[None, :]
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    dst = torch.where(eye, torch.zeros_like(dst), dst)  # i == j entries stay 0

    # nan -> (masked) max + 1 (ref:742-745)
    finite = valid2 & ~torch.isnan(dst)
    maxv = torch.where(finite, dst, torch.full_like(dst, -float("inf"))).max()
    maxv = torch.where(torch.isfinite(maxv), maxv, torch.zeros_like(maxv))
    dst = torch.where(torch.isnan(dst), maxv + 1.0, dst)

    sim = _masked_sigmoid_similarity(dst, valid2, cfg.st_norm_mean, cfg.st_norm_std,
                                     cfg.affinity_sigmoid_scale)
    sim = torch.where(sim < cfg.st_sim_floor, torch.zeros_like(sim), sim)
    sim = torch.clamp(sim, max=1.0)
    return sim.to(out_dt), elem_valid, d23.to(out_dt)


def _spatial_similarity(ctx: TrackerContext, kps: Tensor, det_valid: Tensor,
                        view_idx=None, view_valid=None, app: Optional[Tensor] = None,
                        app_gain=None) -> Tuple[Tensor, Tensor]:
    """The spatial-only similarity (ref:src/motion_capture.py:597-631 +
    ref:src/mv_math_util.py:320-351): raw epipolar distances, 50 for
    same-view pairs, diagonal 0, z-normalized by the matrix's own masked
    mean/std, sigmoid.  `view_idx` / `view_valid` restrict it to a camera
    subset as in `_spatial_time_similarity`; the z-statistics are then the
    subset matrix's own, as the reference normalizes whatever it solves.

    Formed in `WORK_DTYPE` and rounded once to f32: the card and the CPU
    then give the ALS the same matrix bit for bit.  That matters because the
    ALS may not converge within its iteration cap, and its grouping then
    depends on every rounding of W.

    `app` (V, P, D) detection embeddings add the 2D-2D appearance penalty at
    `app_gain` (default `cfg.appearance_gain_px`) after the z-statistics,
    which stay geometric, so the term cannot dilute its own weight."""
    cfg = ctx.cfg
    kps, det_valid, F_spatial, _, app = _select_views(ctx, kps, det_valid, ctx.F_spatial,
                                                      view_idx, view_valid, app)
    T, V, P = cfg.max_tracks, kps.shape[0], cfg.max_people
    N = T + V * P
    dev = kps.device

    if ctx.mesh is not None and view_idx is None:
        d = sharded_affinity(kps.to(WORK_DTYPE), F_spatial, ctx.mesh, ctx.mesh_axis,
                             consts=ctx.mesh_consts["F_spatial"])
    else:
        d = geom.projected_distance_all_pairs(kps.to(WORK_DTYPE), F_spatial.to(WORK_DTYPE))
    same_view = torch.eye(V, dtype=torch.bool, device=dev)[:, None, :, None]
    d = torch.where(same_view, torch.full_like(d, cfg.spatial_fill_distance), d)
    dst = d.reshape(V * P, V * P)
    eye = torch.eye(V * P, dtype=torch.bool, device=dev)
    dst = torch.where(eye, torch.zeros_like(dst), dst)

    dv = det_valid.reshape(-1)
    valid2 = dv[:, None] & dv[None, :]
    zero = torch.zeros_like(dst)
    cnt = valid2.sum().clamp(min=1)
    mean = torch.where(valid2, dst, zero).sum() / cnt
    var = torch.where(valid2, (dst - mean) ** 2, zero).sum() / cnt
    std = torch.sqrt(var).clamp(min=1e-6)
    if app is not None:
        pen = _appearance_penalty_d22(
            cfg.appearance_gain_px if app_gain is None else app_gain, app)
        dst = dst + torch.where(eye, zero, pen.reshape(V * P, V * P))
    sim2d = _masked_sigmoid_similarity(dst, valid2, mean, std, cfg.affinity_sigmoid_scale)

    sim = torch.zeros((N, N), dtype=kps.dtype, device=dev)
    sim[T:, T:] = sim2d
    elem_valid = torch.cat([torch.zeros(T, dtype=torch.bool, device=dev), dv])
    return sim, elem_valid


# ---------------------------------------------------------------------------
# the tracker step
# ---------------------------------------------------------------------------

def _gather_obs(kps: Tensor, matched_pose: Tensor, exists: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-slot observations from matched detection indices.

    kps: (V, P, K, 3); matched_pose: (T, V) (-1 = none); exists: (T, V).
    Returns obs (T, V, K, 3) and view weights (T, V)."""
    V = kps.shape[0]
    safe = matched_pose.clamp(min=0).long()
    views = torch.arange(V, device=kps.device)[None, :]
    obs = kps[views, safe]                                        # (T, V, K, 3)
    w = exists.to(kps.dtype)
    return obs * w[:, :, None, None], w


def _top_views(obs: Tensor, w: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Each slot's k highest-score views (summed keypoint scores plus the
    view weight; unmatched views score 0, the sum in `WORK_DTYPE`), stable
    in view order: obs (T, k, K, 3), weights (T, k) and the view indices
    (T, k) that pick each slot's cameras."""
    score = obs[..., 2].to(WORK_DTYPE).sum(dim=-1) + w            # (T, V)
    idx = torch.argsort(-score, dim=1, stable=True)[:, :k]
    obs_k = torch.gather(obs, 1, idx[:, :, None, None].expand(-1, -1, *obs.shape[2:]))
    return obs_k, torch.gather(w, 1, idx), idx


class Association(NamedTuple):
    """One frame's association: the ALS match matrix and what the update
    stage needs beside it."""

    x_bin: Tensor       # (N, N) bool binarized match matrix
    n_iters: Tensor     # () int32 ALS iterations
    elem_valid: Tensor  # (N,) bool elements of the solved matrix
    d23: Tensor         # (T, V, P) track -> detection reprojection distances
    any_alive: Tensor   # () bool: the spatial-time matrix was solved


def predict(state: TrackerState) -> TrackerState:
    """Step 1 (ref:349-350): every live track ages by one frame."""
    tsu = state.time_since_update + (state.active > 0).to(torch.int32)
    return state.replace(time_since_update=tsu)


def associate(ctx: TrackerContext, state: TrackerState, kps: Tensor,
              det_valid: Tensor, app: Optional[Tensor] = None) -> Association:
    """Steps 2-3: the similarity (spatial-time when any track is alive,
    spatial otherwise, ref:829-835) and its ALS solve; per camera cluster
    when `cfg.assoc_clusters > 1`.  `app`: the frame's (V, P, D) detection
    embeddings when appearance is on."""
    if ctx.cfg.assoc_clusters > 1:
        return _clustered_association(ctx, state, kps, det_valid, app)
    cfg = ctx.cfg
    with span("step.similarity"):
        any_alive = (state.active > 0).any()
        gain = None if app is None else _appearance_gain(cfg, state)
        sim_st, ev_st, d23 = _spatial_time_similarity(ctx, state, kps, det_valid,
                                                      app=app, app_gain=gain)
        sim_sp, ev_sp = _spatial_similarity(ctx, kps, det_valid, app=app, app_gain=gain)
        sim = torch.where(any_alive, sim_st, sim_sp)
        elem_valid = torch.where(any_alive, ev_st, ev_sp)
    with span("step.als"):
        als = als_kernel.match_als(
            sim.contiguous(), ctx.diag_mask, ctx.init_A,
            alpha=cfg.als_alpha, beta=cfg.als_beta, mu0=cfg.als_mu,
            tol=cfg.als_tol, max_iter=cfg.als_max_iter,
            stable_iters=cfg.als_stable_iters)
    return Association(x_bin=als.x_bin, n_iters=als.n_iters, elem_valid=elem_valid,
                       d23=d23, any_alive=any_alive)


def _clustered_association(ctx: TrackerContext, state: TrackerState, kps: Tensor,
                           det_valid: Tensor, app: Optional[Tensor] = None) -> Association:
    """Hierarchical association for wide rigs (the JAX package's
    `_clustered_association`, tracker.py:581-790).

    Cameras form `cfg.assoc_clusters` interleaved clusters (`cluster_layout`;
    on a ring every cluster spans the full angular range).  Each cluster's
    [T track slots | its Vc views] similarity is built from its own views
    only, and all C ALS problems are solved in one batched launch
    (`als_kernel.match_als_batched`).  The per-cluster binarized matches
    are scattered into the global (N, N) matrix: track rows appear in every
    cluster, so a tracked person's identity merges through the track in
    the closure; the detection blocks land at the cluster's strided views.
    New people (detection-only groups of >= 2 views) are linked across
    clusters when their triangulated mean-keypoint centroids lie within
    `cfg.cluster_merge_m`.  Returns the association over the global layout
    with `n_iters` the sum of the clusters' iterations."""
    cfg = ctx.cfg
    T, V, P = cfg.max_tracks, cfg.n_views, cfg.max_people
    N, C = cfg.n_matrix, cfg.assoc_clusters
    Vc = ctx.clusters[0].views.shape[0]
    dev = kps.device
    i32 = torch.int32

    with span("step.similarity"):
        any_alive = (state.active > 0).any()
        dv_flat = det_valid.reshape(-1)
        ev_st = torch.cat([state.active > 0, dv_flat])
        ev_sp = torch.cat([torch.zeros(T, dtype=torch.bool, device=dev), dv_flat])
        elem_valid = torch.where(any_alive, ev_st, ev_sp)
        d23 = _track_det_distances(ctx, state, kps, det_valid).to(kps.dtype)
        gain = None if app is None else _appearance_gain(cfg, state)

        subs = []
        for cl in ctx.clusters:
            sim_st, _, _ = _spatial_time_similarity(ctx, state, kps, det_valid,
                                                    view_idx=cl.views, view_valid=cl.view_valid,
                                                    app=app, app_gain=gain)
            sim_sp, _ = _spatial_similarity(ctx, kps, det_valid,
                                            view_idx=cl.views, view_valid=cl.view_valid,
                                            app=app, app_gain=gain)
            subs.append(torch.where(any_alive, sim_st, sim_sp))
    with span("step.als"):
        als_kw = dict(alpha=cfg.als_alpha, beta=cfg.als_beta, mu0=cfg.als_mu,
                      tol=cfg.als_tol, max_iter=cfg.als_max_iter,
                      stable_iters=cfg.als_stable_iters)
        if ctx.cluster_mesh is not None:
            # clusters -> devices: one B3 launch per device on its clusters,
            # each problem's result that of its solo solve
            xb, n_iters = sharded_cluster_als(
                torch.stack(subs), ctx.mesh_consts["cluster_diag_mask"],
                ctx.mesh_consts["cluster_init_A"], ctx.cluster_mesh, ctx.cluster_mesh_axis,
                **als_kw)
        else:
            als = als_kernel.match_als_batched(torch.stack(subs), ctx.cluster_diag_mask,
                                               ctx.cluster_init_A, **als_kw)
            xb, n_iters = als.x_bin, als.n_iters                   # (C, Nc, Nc), (C,)

    with span("step.merge"):
        # scatter: cluster c's detections are the strided views c::C of the
        # (V, P) grid; the pad views (if any) sit at the end and are dropped.
        # Blocks are disjoint except the track-track corner, which ORs.
        x_tt = xb[:, :T, :T].any(dim=0)
        x_td = torch.zeros((T, V, P), dtype=torch.bool, device=dev)
        x_dd = torch.zeros((V, P, V, P), dtype=torch.bool, device=dev)
        for c, cl in enumerate(ctx.clusters):
            n = cl.n_real
            x_td[:, c::C] = xb[c, :T, T:].reshape(T, Vc, P)[:, :n]
            x_dd[c::C, :, c::C] = xb[c, T:, T:].reshape(Vc, P, Vc, P)[:n, :, :n]
        x_td = x_td.reshape(T, V * P)
        x_global = torch.cat([torch.cat([x_tt, x_td], dim=1),
                              torch.cat([x_td.T, x_dd.reshape(V * P, V * P)], dim=1)], dim=0)

        # cross-cluster merge of new-person groups: per candidate leader, its
        # first member in each view; the per-detection mean keypoint (computed
        # once) triangulates to one 3D centroid per candidate
        g0 = assoc.extract_groups(x_global, elem_valid)
        rep_det, member_det = g0.rep[T:], g0.member[T:]
        e_global = torch.arange(T, N, dtype=i32, device=dev)
        kps_w = kps.to(WORK_DTYPE)
        w_all = kps[..., 2] > cfg.epipolar_min_kps_score              # (V, P, K)
        cnt_all = w_all.sum(dim=-1).clamp(min=1)
        mean_uv = (kps_w[..., :2] * w_all[..., None]).sum(dim=2) / cnt_all[..., None]  # (V, P, 2)
        cand = (member_det.reshape(V, P)[None]
                & (rep_det.reshape(V, P)[None] == e_global[:, None, None]))  # (VP, V, P)
        exists = cand.any(dim=-1)                                     # (VP, V)
        first = cand.to(i32).argmax(dim=-1)                           # (VP, V)
        uv = mean_uv[torch.arange(V, device=dev)[None, :], first]     # (VP, V, 2)
        point_obs = torch.cat([uv, exists.to(WORK_DTYPE)[..., None]], dim=-1)[:, :, None, :]
        tri = triangulate_points(ctx.cams.P.to(WORK_DTYPE), ctx.K_inv.to(WORK_DTYPE),
                                 point_obs, exists, 0.5, 0)
        cents = tri[:, 0, :3]                                         # (VP, 3)
        # leaders of detection-only groups with >= 2 views (groups holding a
        # track merge through the track)
        ok = ((rep_det == e_global) & member_det & (rep_det >= T)
              & (exists.sum(dim=1) >= 2))
        cents = torch.where(ok[:, None], cents, torch.full_like(cents, 1e6))
        d = torch.linalg.vector_norm(cents[:, None] - cents[None, :], dim=-1)
        cross = ctx.cluster_of_slot[:, None] != ctx.cluster_of_slot[None, :]
        link = (d < cfg.cluster_merge_m) & cross & ok[:, None] & ok[None, :]
        x_global[T:, T:] |= link
    return Association(x_bin=x_global, n_iters=n_iters.sum(dtype=i32),
                       elem_valid=elem_valid, d23=d23, any_alive=any_alive)


def _appearance_ema(cfg: PipelineConfig, state: TrackerState, app: Tensor,
                    m_match: Tensor, m_exists: Tensor, update_mask: Tensor,
                    spawned: Tensor, active_after_miss: Tensor,
                    new_root: Tensor) -> Tuple[Tensor, Tensor]:
    """Step 7c (tracker.py:1184-1234 of the JAX package): the mean embedding
    of each slot's matched detections this frame, folded into the track's
    unit EMA (`cfg.appearance_beta`); a spawn starts from its own
    detections (or from zero without any).  With
    `cfg.appearance_freeze_radius_m` a track that has another live track
    that close keeps its EMA.  Returns the new EMA and the frame's raw unit
    observation per touched slot (`FrameOutput.app_obs`), formed in
    `WORK_DTYPE` and rounded once."""
    wd, eps = WORK_DTYPE, 1e-6
    T, V = m_match.shape
    views = torch.arange(V, device=app.device)[None, :]
    app_det = app.to(wd)[views, m_match.clamp(min=0).long()]           # (T, V, D)
    wv = (m_exists & (torch.linalg.vector_norm(app_det, dim=-1) > eps)).to(wd)
    n_obs = wv.sum(dim=1)
    mean_app = (app_det * wv[..., None]).sum(dim=1) / n_obs.clamp(min=1.0)[:, None]
    has_obs = n_obs > 0
    ema = state.app_ema.to(wd)
    b = cfg.appearance_beta
    blended = torch.where((torch.linalg.vector_norm(ema, dim=-1) > eps)[:, None],
                          b * mean_app + (1.0 - b) * ema, mean_app)
    cand = torch.where(spawned[:, None], mean_app, blended)
    cand = cand / torch.linalg.vector_norm(cand, dim=-1, keepdim=True).clamp(min=eps)
    upd = update_mask
    if cfg.appearance_freeze_radius_m > 0:
        # while another live track is close, keep the last unambiguous
        # signature instead of blending in detections the association may
        # be misattributing
        alive = (active_after_miss > 0) | spawned
        root = new_root.to(wd)
        dd = torch.linalg.vector_norm(root[:, None] - root[None], dim=-1)
        other = alive[:, None] & alive[None] & ~torch.eye(T, dtype=torch.bool,
                                                          device=app.device)
        near = torch.where(other, dd, torch.full_like(dd, float("inf"))).amin(dim=1)
        upd = update_mask & (near >= cfg.appearance_freeze_radius_m)
    touched = (upd | spawned) & has_obs
    new_app = torch.where(touched[:, None], cand,
                          torch.where(spawned[:, None], torch.zeros_like(ema), ema))
    obs_unit = mean_app / torch.linalg.vector_norm(mean_app, dim=-1,
                                                   keepdim=True).clamp(min=eps)
    emit = (update_mask | spawned) & has_obs
    app_obs = torch.where(emit[:, None], obs_unit, torch.zeros_like(obs_unit))
    dt = state.app_ema.dtype
    return new_app.to(dt), app_obs.to(dt)


def _appearance_stats(cfg: PipelineConfig, state: TrackerState, app: Tensor,
                      det_valid: Tensor, m_match: Tensor, m_exists: Tensor,
                      update_mask: Tensor, spawned: Tensor) -> Tensor:
    """Step 7d (tracker.py:1236-1290 of the JAX package): this frame's
    matched (same-person) and claimed-by-another-track (cross-person)
    track-vs-detection cosines, folded into the auto-gain statistics the
    next frame's `_appearance_gain` reads.  The first frame with both kinds
    of sample sets them, later ones fold at `cfg.appearance_auto_beta`; the
    weight ramps 0 -> 1 on such frames only.  Formed in `WORK_DTYPE`,
    rounded once."""
    P = app.shape[1]
    cos, has = _cosines(state.app_ema, app, "td,vpd->tvp")               # (T, V, P)
    has = has & det_valid[None]
    matched = m_exists[:, :, None] & (torch.arange(P, device=app.device)[None, None, :]
                                      == m_match.clamp(min=0)[:, :, None])
    claimed = matched.any(dim=0)                                          # (V, P)
    same_m = has & matched & (update_mask & ~spawned)[:, None, None]
    diff_m = has & ~matched & claimed[None] & ((state.active > 0) & ~spawned)[:, None, None]
    n_s, n_d = same_m.sum(), diff_m.sum()
    zero = torch.zeros_like(cos)
    mean_s = torch.where(same_m, cos, zero).sum() / n_s.clamp(min=1)
    mean_d = torch.where(diff_m, cos, zero).sum() / n_d.clamp(min=1)
    cs, cd, w, vs = state.app_stats.to(WORK_DTYPE).unbind()
    # the matched cosines' spread around the running mean: the appearance
    # noise the penalty amplifies (the noise rule of `_appearance_gain`)
    ref_s = torch.where(w > 0, cs, mean_s)
    var_s = torch.where(same_m, (cos - ref_s) ** 2, zero).sum() / n_s.clamp(min=1)
    b = cfg.appearance_auto_beta
    have_both = (n_s > 0) & (n_d > 0)

    def fold(old, new):
        return torch.where(have_both, torch.where(w > 0, (1 - b) * old + b * new, new), old)

    new_w = torch.where(have_both, (1.0 - b) * w + b, w)
    return torch.stack([fold(cs, mean_s), fold(cd, mean_d), new_w,
                        fold(vs, var_s)]).to(state.app_stats.dtype)


def make_update(ctx: TrackerContext):
    """Build steps 4-8 as `update(state, kps, det_valid, association, app)
    -> (state, out)`: groups, track rescue, death, spawn, IK (or
    triangulation), the motion and appearance state, and lifecycle."""
    cfg = ctx.cfg
    T, V, P = cfg.max_tracks, cfg.n_views, cfg.max_people
    N = cfg.n_matrix
    skel = ctx.skel
    dev = ctx.device
    i32 = torch.int32
    slot_idx = torch.arange(T, dtype=i32, device=dev)
    e_idx = torch.arange(T, N, dtype=i32, device=dev)
    view_ids = torch.arange(V, dtype=i32, device=dev)
    key_ids = torch.arange(N, dtype=i32, device=dev)
    earlier = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev), diagonal=-1)
    minus1 = torch.full((), -1, dtype=i32, device=dev)
    lm_kw = dict(eps=cfg.ik_proj_eps, lam0=cfg.ik_lm_damping_init,
                 lam_up=cfg.ik_lm_damping_up, lam_down=cfg.ik_lm_damping_down,
                 solver=cfg.ik_solver, ftol=cfg.ik_ftol, xtol=cfg.ik_xtol)
    top_k = cfg.ik_max_views if (cfg.ik_max_views is not None
                                 and cfg.ik_max_views < V) else 0
    wd = WORK_DTYPE
    if ctx.ik_mesh is not None:
        # track slots -> devices: each device LM-solves its T/n slots
        solve_fn = functools.partial(sharded_lm_solve, mesh=ctx.ik_mesh,
                                     axis=ctx.ik_mesh_axis)
        solve_skel = ctx.mesh_consts["skel"]
    else:
        solve_fn, solve_skel = ik_ops.solve_two_stage, skel

    def cold_triangulation(obs: Tensor, w: Tensor) -> Tensor:
        """Triangulated COCO+spine points (T, 18, 4) of each slot's matched
        detections over all its views, in `WORK_DTYPE`, kept finite and
        inside +-100 m (a degenerate 2-view match can triangulate near
        infinity)."""
        obs18 = ik_ops.add_mid_spine(obs).to(wd)
        tri = triangulate_points(ctx.cams.P.to(wd), ctx.K_inv.to(wd), obs18, w > 0,
                                 cfg.triangulate_min_score, cfg.triangulate_refine_iters)
        return torch.nan_to_num(tri).clamp(-100.0, 100.0)

    def update(state: TrackerState, kps: Tensor, det_valid: Tensor, a: Association,
               app: Optional[Tensor] = None):
        tsu = state.time_since_update
        d23, any_alive = a.d23, a.any_alive
        with span("step.groups"):
            groups = assoc.extract_groups(a.x_bin, a.elem_valid)
        rep, member, group_size = groups.rep, groups.member, groups.group_size

        # 4. per-slot / per-leader matched detections
        det_rep = rep[T:].reshape(V, P)
        det_member = member[T:].reshape(V, P)

        def first_match(keys: Tensor):
            """(K,) group leaders -> first matched detection per view (K, V)
            (-1 where none) and whether one exists (K, V)."""
            cand = det_member[None] & (det_rep[None] == keys[:, None, None])
            exists = cand.any(dim=-1)
            first = cand.to(i32).argmax(dim=-1).to(i32)   # first True
            return torch.where(exists, first, minus1), exists

        # a tracklet owns its group iff it is the group leader (ref:764-769)
        t_is_leader = member[:T] & (rep[:T] == slot_idx)
        t_match, t_exists = first_match(slot_idx)
        t_match = torch.where(t_is_leader[:, None], t_match, minus1)
        t_exists = t_exists & t_is_leader[:, None]
        t_nviews = t_exists.sum(dim=1)
        update_mask = t_is_leader & (t_nviews >= 2)           # ref:927-928
        in_match_dict = t_is_leader & (t_nviews >= 1)         # 1-view: no-op

        # 4b. track rescue (config-gated deviation of the JAX package): a
        # CONFIRMED track about to die adopts the ALS group of its nearest
        # unclaimed detection within `track_rescue_px` reprojection distance
        claimed_key = torch.zeros(N, dtype=torch.bool, device=dev)
        if cfg.track_rescue_px > 0:
            would_die = (state.active == CONFIRMED) & ~in_match_dict
            rep_det = rep[T:]
            adoptable = det_valid.reshape(-1) & (rep_det >= T)
            single_px = (cfg.track_rescue_px if cfg.track_rescue_single_px is None
                         else cfg.track_rescue_single_px)
            gate_det = torch.where(
                group_size[T:] >= 2,
                torch.full((N - T,), cfg.track_rescue_px, dtype=kps.dtype, device=dev),
                torch.full((N - T,), single_px, dtype=kps.dtype, device=dev))
            if app is not None:
                # appearance-consistent rescue: the same px-per-cosine
                # penalty pushes another person's detections past the gate
                d23 = (d23.to(wd) + _appearance_penalty(
                    _appearance_gain(cfg, state), state.app_ema, app)).to(d23.dtype)
            d23f = d23.reshape(T, V * P)
            inf = torch.full_like(d23f, float("inf"))
            dflat = torch.where(adoptable[None] & torch.isfinite(d23f)
                                & (d23f < gate_det[None]), d23f, inf)
            best_e = dflat.argmin(dim=1)                       # first minimum
            best_d = dflat.min(dim=1).values
            cand = would_die & torch.isfinite(best_d) & any_alive
            if cfg.track_rescue_ambiguity > 0:
                # adopt only when no OTHER live track is competitively close
                dfin = torch.where(torch.isfinite(d23f), d23f, inf)
                m1 = dfin.min(dim=0).values
                am1 = dfin.argmin(dim=0)
                t_ids = torch.arange(T, device=dev)[:, None]
                m2 = torch.where(t_ids == am1[None], inf, dfin).min(dim=0).values
                comp = torch.where(am1[None] == t_ids, m2[None], m1[None])  # (T, VP)
                comp_best = comp.gather(1, best_e[:, None])[:, 0]
                cand = cand & (comp_best > cfg.track_rescue_ambiguity * best_d)
            best_key = rep_det[best_e]                         # (T,) global

            # slot-order allocation, one adopting track per group: slot t
            # adopts unless an earlier candidate slot wants the same group
            # (the JAX package's slot-ordered scan over the T slots)
            same = (best_key[:, None] == best_key[None, :]) & cand[None, :] & earlier
            adopt = cand & ~same.any(dim=1)
            claimed_key = ((best_key[:, None] == key_ids[None, :])
                           & adopt[:, None]).any(dim=0)
            a_match, a_exists = first_match(best_key)
            a_exists = a_exists & adopt[:, None]
            # singleton groups have member=False: adopt the detection itself
            best_v = (best_e // P).to(i32)
            best_p = (best_e % P).to(i32)
            single = adopt & ~a_exists.any(dim=1)
            at_best = view_ids[None, :] == best_v[:, None]
            a_match = torch.where(single[:, None] & at_best, best_p[:, None], a_match)
            a_exists = a_exists | (single[:, None] & at_best)
            a_n = a_exists.sum(dim=1)

            t_match = torch.where(adopt[:, None],
                                  torch.where(a_exists, a_match, minus1), t_match)
            t_exists = torch.where(adopt[:, None], a_exists, t_exists)
            update_mask = update_mask | (adopt & (a_n >= 2))
            in_match_dict = in_match_dict | adopt

        # 5. missed tracks die (ref:387-391,933-934)
        alive = state.active > 0
        missed = alive & ~in_match_dict
        dies = missed & ((state.active == TENTATIVE)
                         | (state.time_since_update > cfg.max_age))
        died_track_id = torch.where(dies, state.track_id, minus1)
        active_after_miss = torch.where(dies, torch.zeros_like(state.active), state.active)

        # 6. spawn leaders: detection-led groups with >= 2 views (ref:936-958);
        # groups adopted by the rescue pass are continuations, not new ids
        d_is_leader = member[T:] & (rep[T:] == e_idx) & ~claimed_key[T:]
        s_match_all, s_exists_all = first_match(e_idx)           # (VP, V)
        s_nviews = s_exists_all.sum(dim=1)
        spawn_ok = d_is_leader & (s_nviews >= 2)
        spawn_rank = torch.cumsum(spawn_ok.to(i32), dim=0, dtype=i32) - 1

        free_slots = active_after_miss == FREE
        free_order = torch.argsort((~free_slots).to(i32), stable=True)  # free first
        n_free = free_slots.sum()
        leader_slot = torch.where(spawn_ok & (spawn_rank < n_free),
                                  free_order[spawn_rank.clamp(0, T - 1).long()].to(i32),
                                  minus1)                                  # (VP,)
        # for each slot, which leader spawns into it (-1 none); leaders past
        # the free capacity go to the extra last entry, which is dropped
        slot_leader = torch.full((T + 1,), -1, dtype=i32, device=dev)
        slot_leader.scatter_(0, torch.where(leader_slot >= 0, leader_slot,
                                            torch.full_like(leader_slot, T)).long(),
                             e_idx)
        slot_leader = slot_leader[:T]
        spawned = slot_leader >= 0
        s_match = torch.where(spawned[:, None],
                              s_match_all[(slot_leader - T).clamp(min=0).long()], minus1)
        s_exists = spawned[:, None] & (s_match >= 0)

        # 7. batched IK, or triangulation
        with span("step.pose"):
            upd_obs, upd_w = _gather_obs(kps, t_match, t_exists)
            upd_w = upd_w * update_mask[:, None].to(upd_w.dtype)
            new_obs, new_w = _gather_obs(kps, s_match, s_exists)
            new_w = new_w * spawned[:, None].to(new_w.dtype)
            any_update, any_spawn = torch.stack([update_mask.any(), spawned.any()]).tolist()
            if top_k:
                # wide rigs: each track's LM solve (or refined triangulation)
                # sees only its k highest-score matched views, with per-slot
                # cameras; the spawns' triangulation keeps all views
                upd_obs_k, upd_w_k, upd_views = _top_views(upd_obs, upd_w, top_k)
                new_obs_k, new_w_k, new_views = _top_views(new_obs, new_w, top_k)
                P_upd, P_new = ctx.cams.P[upd_views], ctx.cams.P[new_views]
                # only the refined triangulation reads the inverse intrinsics
                Kinv_upd = None if ctx.use_ik else ctx.K_inv[upd_views]
            else:
                upd_obs_k, upd_w_k, P_upd, Kinv_upd = upd_obs, upd_w, ctx.cams.P, ctx.K_inv
                new_obs_k, new_w_k, P_new = new_obs, new_w, ctx.cams.P
            sel_u, sel_s = update_mask, spawned

            def pick(cold, warm, old):
                shape = (T,) + (1,) * (old.dim() - 1)
                return torch.where(sel_s.view(shape), cold,
                                   torch.where(sel_u.view(shape), warm, old))

            if ctx.use_ik:
                state_params = ik_ops.IkParams(state.root, state.euler, state.side_lens)
                if any_update:
                    warm_params, warm_joints = solve_fn(
                        state_params, solve_skel, upd_obs_k, upd_w_k, P_upd,
                        n_iters=cfg.ik_warm_iters, stages=cfg.ik_warm_stages, **lm_kw)
                else:
                    warm_params, warm_joints = state_params, state.pose3d
                if any_spawn:
                    # cold init: root = hip midpoint of the triangulation
                    # (ref:src/inverse_kinematics.py:389-397), geometric angle
                    # init (both in WORK_DTYPE, rounded once)
                    tri = cold_triangulation(new_obs, new_w)
                    cold_roots = (0.5 * (tri[:, _LHIP, :3] + tri[:, _RHIP, :3])).to(kps.dtype)
                    cold_euler = ik_ops.geometric_init(tri, skel.to(wd)).to(kps.dtype)
                    init = ik_ops.IkParams(root=cold_roots, euler=cold_euler,
                                           side_lens=skel.side_bone_lens.expand(T, -1))
                    cold_params, cold_joints = solve_fn(
                        init, solve_skel, new_obs_k, new_w_k, P_new,
                        n_iters=cfg.ik_cold_iters, stages=cfg.ik_cold_stages, **lm_kw)
                else:
                    cold_params, cold_joints = state_params, state.pose3d
                new_root = pick(cold_params.root, warm_params.root, state.root)
                new_euler = pick(cold_params.euler, warm_params.euler, state.euler)
                new_side = pick(cold_params.side_lens, warm_params.side_lens, state.side_lens)
                new_pose3d = pick(cold_joints, warm_joints, state.pose3d)
                new_score = torch.where((sel_s | sel_u)[:, None],
                                        torch.ones_like(state.pose3d_score), state.pose3d_score)
            else:
                # triangulation mode (tracker.py:1141-1168 of the JAX package):
                # updates triangulate their capped views, spawns all their views;
                # the pose is COCO order plus the mid-spine, the root the hips'
                # midpoint, angles and side lengths stay
                keep = torch.cat([state.pose3d, state.pose3d_score[..., None]], dim=-1)
                tri_upd = tri_new = keep
                if any_update:
                    tri_upd = triangulate_points(
                        P_upd.to(wd), Kinv_upd.to(wd), ik_ops.add_mid_spine(upd_obs_k).to(wd),
                        upd_w_k > 0, cfg.triangulate_min_score,
                        cfg.triangulate_refine_iters).to(kps.dtype)
                if any_spawn:
                    tri_new = cold_triangulation(new_obs, new_w).to(kps.dtype)
                tri = pick(tri_new, tri_upd, keep)
                new_pose3d, new_score = tri[..., :3], tri[..., 3]
                new_root = torch.where((sel_s | sel_u)[:, None],
                                       0.5 * (new_pose3d[:, _LHIP] + new_pose3d[:, _RHIP]),
                                       state.root)
                new_euler, new_side = state.euler, state.side_lens

        # 7b. association-gate velocity (cfg.motion_gain): EMA of the
        # per-update root delta; fresh spawns start at rest
        new_vel = state.root_vel
        if cfg.motion_gain:
            dt = tsu.clamp(min=1).to(wd)
            dx = (new_root.to(wd) - state.root.to(wd)) / dt[:, None]
            b = cfg.motion_vel_beta
            ema = (b * dx + (1.0 - b) * state.root_vel.to(wd)).to(state.root_vel.dtype)
            new_vel = torch.where(spawned[:, None], torch.zeros_like(ema),
                                  torch.where(update_mask[:, None], ema, state.root_vel))

        m_match = torch.where(spawned[:, None], s_match, t_match)      # (T, V)
        new_app, new_app_stats = state.app_ema, state.app_stats
        app_obs = state.app_ema.new_zeros((T, 0))
        if app is not None:
            m_exists = torch.where(spawned[:, None], s_exists, t_exists)
            new_app, app_obs = _appearance_ema(cfg, state, app, m_match, m_exists,
                                               update_mask, spawned, active_after_miss,
                                               new_root)
            if cfg.appearance_auto_target_px > 0:
                new_app_stats = _appearance_stats(cfg, state, app, det_valid, m_match,
                                                  m_exists, update_mask, spawned)

        # 8. lifecycle bookkeeping
        touched = update_mask | spawned
        new_hits = torch.where(spawned, torch.ones_like(state.hits),
                               torch.where(update_mask, state.hits + 1, state.hits))
        new_tsu = torch.where(touched, torch.zeros_like(tsu), tsu)
        promoted = ((active_after_miss == TENTATIVE) & update_mask
                    & (new_hits >= cfg.n_init_hits))
        new_active = torch.where(
            spawned, torch.full_like(state.active, TENTATIVE),
            torch.where(promoted, torch.full_like(state.active, CONFIRMED),
                        active_after_miss))
        spawn_order = torch.cumsum(spawned.to(i32), dim=0, dtype=i32) - 1
        new_ids = state.next_track_id + spawn_order
        new_track_id = torch.where(spawned, new_ids,
                                   torch.where(new_active > 0, state.track_id, minus1))
        next_tid = state.next_track_id + spawned.sum(dtype=i32)

        new_state = TrackerState(
            active=new_active.to(i32), track_id=new_track_id.to(i32),
            hits=new_hits.to(i32), time_since_update=new_tsu.to(i32),
            root=new_root, euler=new_euler, side_lens=new_side,
            pose3d=new_pose3d, pose3d_score=new_score,
            root_vel=new_vel, app_ema=new_app,
            app_stats=new_app_stats, next_track_id=next_tid.to(i32),
        )
        out = FrameOutput(
            track_id=new_state.track_id, active=new_state.active,
            updated=touched, spawned=spawned,
            died_track_id=died_track_id.to(i32),
            root=new_root, euler=new_euler, side_lens=new_side,
            pose3d=new_pose3d, pose3d_score=new_score,
            matched_pose=m_match.to(i32),
            app_obs=app_obs,
            als_iters=a.n_iters,
        )
        return new_state, out

    return update


def make_step(ctx: TrackerContext):
    """Build the per-frame step: `step(state, kps, det_valid, app=None) ->
    (state, out)` with kps (V, P, K, 3), det_valid (V, P) and, when
    `cfg.appearance_dim > 0`, app (V, P, D) detection embeddings (unit rows,
    zero rows for detections without one), all on the context's device."""
    update = make_update(ctx)
    use_app = ctx.cfg.appearance_dim > 0

    def step(state: TrackerState, kps: Tensor, det_valid: Tensor,
             app: Optional[Tensor] = None):
        if use_app and app is None:
            raise ValueError("cfg.appearance_dim > 0: each frame needs app=(V, P, D) "
                             "detection appearance embeddings")
        app = app if use_app else None
        with span("step", frame=True):
            state = predict(state)
            a = associate(ctx, state, kps, det_valid, app)
            with span("step.update"):
                return update(state, kps, det_valid, a, app)

    return step


# ---------------------------------------------------------------------------
# host-facing API
# ---------------------------------------------------------------------------

def stack_outputs(outs: List[FrameOutput]) -> FrameOutput:
    return FrameOutput(*[torch.stack([getattr(o, f) for o in outs])
                         for f in FrameOutput._fields])


def outputs_to_numpy(out: FrameOutput) -> FrameOutput:
    return FrameOutput(*[t.cpu().numpy() for t in out])


def _frames_to_device(ctx: TrackerContext, kps, valid, app):
    """kps, valid and app (when given and appearance is on) as f32 / bool
    tensors on the context's device."""
    dev = ctx.device
    kps = torch.as_tensor(kps, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    if app is not None and ctx.cfg.appearance_dim > 0:
        app = torch.as_tensor(app, dtype=torch.float32, device=dev)
    else:
        app = None
    return kps, valid, app


def run_offline(ctx: TrackerContext, kps, valid, frame_idxs=None, app=None, *,
                state: Optional[TrackerState] = None) -> Tuple[TrackerState, FrameOutput]:
    """Whole-sequence tracking: one step per frame, from `state` (zeros by
    default), on the context's device.  kps: (F, V, P, K, 3); valid:
    (F, V, P); app: (F, V, P, D) detection embeddings, needed when
    `cfg.appearance_dim > 0`; numpy or tensors.  `frame_idxs` is accepted
    and ignored, as in the JAX package's signature (its fourth positional
    parameter), so a call written for it runs here unchanged; `state` is
    keyword-only.  Returns the last state and the stacked per-frame
    outputs (F, ...) on the device."""
    with span("offline.chunk"):
        kps, valid, app = _frames_to_device(ctx, kps, valid, app)
        if state is None:
            state = TrackerState.zeros(ctx.cfg, device=ctx.device)
        step = make_step(ctx)
        outs = []
        for f in range(kps.shape[0]):
            state, out = step(state, kps[f], valid[f], None if app is None else app[f])
            outs.append(out)
        if not outs:
            raise ValueError("run_offline needs at least one frame")
        return state, stack_outputs(outs)


class MvTracker:
    """Streaming-mode tracker (the JAX package's `MvTracker`,
    tracker.py:1366-1487): a host loop around the per-frame step, one frame
    (`update`) or one chunk of frames (`update_batch`) at a time.  The
    outputs are numpy `FrameOutput`s, equal bit for bit to `run_offline`'s
    frames over the same sequence; `tracklets()` assembles them.  Runs on
    `device` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, cams: CameraBank, cfg: Optional[PipelineConfig] = None,
                 use_ik: bool = True, device="cuda"):
        self.cfg = cfg or PipelineConfig(n_views=cams.n_views)
        self.ctx = TrackerContext.build(cams, self.cfg, use_ik=use_ik, device=device)
        self._step = make_step(self.ctx)
        self.state = TrackerState.zeros(self.cfg, device=self.ctx.device)
        self.outputs: List[FrameOutput] = []
        self.frame_idxs: List[int] = []

    def update(self, frame_idx: int, kps, valid, app=None) -> FrameOutput:
        """Track one frame: kps (V, P, K, 3), valid (V, P), app (V, P, D)
        when `cfg.appearance_dim > 0`.  Returns its output on the host."""
        with span("online.frame"):
            with span("online.input"):
                kps, valid, app = _frames_to_device(self.ctx, kps, valid, app)
            self.state, out = self._step(self.state, kps, valid, app)
            with span("online.output"):
                self.outputs.append(outputs_to_numpy(out))
            self.frame_idxs.append(int(frame_idx))
            return self.outputs[-1]

    def update_batch(self, frame_idxs, kps, valid, pad_to: Optional[int] = None,
                     app=None) -> List[FrameOutput]:
        """Track a chunk of k frames: kps (k, V, P, K, 3), valid (k, V, P),
        app (k, V, P, D) when `cfg.appearance_dim > 0`.  The outputs come to
        the host once for the chunk; they equal k `update` calls.

        `pad_to` is the serving path's steady chunk size.  The JAX package
        compiles one scan of that length and pads a shorter chunk (the
        sequence's tail) with inert frames that leave the state untouched
        and whose outputs it drops; a host loop has nothing to compile, so
        here a shorter chunk runs its real frames only, with the same
        result.  A chunk longer than `pad_to` raises, as there."""
        k = len(frame_idxs)
        if kps.shape[0] != k or valid.shape[0] != k:
            raise ValueError(f"{k} frame indices, kps for {kps.shape[0]} frames and "
                             f"valid for {valid.shape[0]}")
        if pad_to is not None and k > pad_to:
            raise ValueError(f"chunk of {k} frames exceeds pad_to={pad_to}")
        kps, valid, app = _frames_to_device(self.ctx, kps, valid, app)
        outs = []
        for i in range(k):
            self.state, out = self._step(self.state, kps[i], valid[i],
                                         None if app is None else app[i])
            outs.append(out)
        if not outs:
            return []
        stacked = outputs_to_numpy(stack_outputs(outs))
        per_frame = [FrameOutput(*[a[i] for a in stacked]) for i in range(k)]
        self.outputs.extend(per_frame)
        self.frame_idxs.extend(int(f) for f in frame_idxs)
        return per_frame

    def tracklets(self) -> List["Tracklet"]:
        if not self.outputs:
            return []
        stacked = FrameOutput(*[np.stack([getattr(o, f) for o in self.outputs])
                                for f in FrameOutput._fields])
        return assemble_tracklets(stacked, self.frame_idxs)


@dataclasses.dataclass
class Tracklet:
    """Host-side reconstructed tracklet (the reference's MvTracklet record,
    ref:src/motion_capture.py:312-400, minus live solver state)."""

    track_id: int
    frame_idxs: List[int]
    roots: np.ndarray        # (L, 3)
    eulers: np.ndarray       # (L, 18, 3)
    side_lens: np.ndarray    # (L, 11)
    poses_3d: np.ndarray     # (L, 18, 3)
    poses_score: np.ndarray  # (L, 18)
    matched_pose: np.ndarray  # (L, V)
    app: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.frame_idxs)


def assemble_tracklets(out: FrameOutput, frame_idxs=None) -> List[Tracklet]:
    """Reconstruct per-track histories from stacked per-frame emissions
    (numpy or tensors), sorted by descending length (ref:src/
    motion_capture.py:1120-1121)."""
    out = FrameOutput(*[t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                        for t in out])
    F, T = out.track_id.shape
    if frame_idxs is None:
        frame_idxs = list(range(F))
    has_app = out.app_obs.size and out.app_obs.shape[-1] > 0
    tracks: Dict[int, dict] = {}
    for f in range(F):
        for t in range(T):
            if not out.updated[f, t]:
                continue
            tid = int(out.track_id[f, t])
            if tid < 0:
                continue
            rec = tracks.setdefault(tid, {"frames": [], "idx": []})
            rec["frames"].append(frame_idxs[f])
            rec["idx"].append((f, t))
    tlets = []
    for tid, rec in tracks.items():
        fi, ti = (np.asarray(a) for a in zip(*rec["idx"]))
        tlets.append(Tracklet(
            track_id=tid, frame_idxs=rec["frames"],
            roots=out.root[fi, ti], eulers=out.euler[fi, ti],
            side_lens=out.side_lens[fi, ti], poses_3d=out.pose3d[fi, ti],
            poses_score=out.pose3d_score[fi, ti],
            matched_pose=out.matched_pose[fi, ti],
            app=out.app_obs[fi, ti] if has_app else None,
        ))
    return sorted(tlets, key=lambda t: -len(t))
