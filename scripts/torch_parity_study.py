#!/usr/bin/env python3
"""Where the PyTorch port's decisions part from the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_parity_study.py [--frames 300] [--draws 12]
    JAX_PLATFORMS=cpu python scripts/torch_parity_study.py --study wide [--frames 60] \
        [--solver gj_fused]
    JAX_PLATFORMS=cpu python scripts/torch_parity_study.py --study rig128 [--frames 8]
    JAX_PLATFORMS=cpu python scripts/torch_parity_study.py --study clustered_appearance \
        [--frames 30] [--draws 4]
    JAX_PLATFORMS=cpu python scripts/torch_parity_study.py --study bench [--frames 12] [--draws 4]
    JAX_PLATFORMS=cpu python scripts/torch_parity_study.py --study cold [--draws 2]
    JAX_PLATFORMS=cpu python scripts/torch_parity_study.py --study default [--frames 300]
    JAX_PLATFORMS=cpu python scripts/torch_parity_study.py --study appearance [--frames 200]
    JAX_PLATFORMS=cpu python scripts/torch_parity_study.py --study identity [--frames 200]
    JAX_PLATFORMS=cpu python scripts/torch_parity_study.py --study detect [--frames 60]
    JAX_PLATFORMS=cpu python scripts/torch_parity_study.py --study train
    python scripts/torch_parity_study.py --study steps [--scene appearance] [--frames 20]

The default study runs the synthetic scene of the port's smoke test
(synthetic_sequence(300 frames, 4 people, 5 views, seed 0), SHELF_BENCH)
through both packages on the CPU and prints JSON lines:

- "frame0": the first frame's ALS problem (spatial-only similarity, no live
  track) solved by the JAX `match_als` (f32), the JAX fused kernel in
  interpret mode, the port's plain version in f32 and in f64.  For each: the
  iteration count, the grouping of the valid detections, whether it is the
  ground truth's, and the smallest |X - 0.5| over the valid entries (the
  binarization margin).  Then the entries whose binarization differs
  between the JAX f32 and port f32 results, with both X values.  Then
  `--draws` perturbations of W by one unit in the last place at random
  entries: how often each f32 solver returns the ground-truth grouping.
- "sequence": both packages' per-frame outputs over `--frames` frames, each
  run on its own; the first frame where each decision differs, and on how
  many frames each ALS ran into its iteration cap.
- "stepwise": every frame stepped by both packages from the same state (the
  JAX state carried across with `from_numpy_state`): the frames whose
  decisions differ with both ALS iteration counts, and the largest pose
  difference where they agree.
- "ik_sensitivity": the port's first 60 frames on the CPU, once as is and
  once with each LM normal matrix multiplied entrywise by (1 + 6e-8 noise),
  about one unit in the last place: whether decisions change, and how far
  the poses move.
- "quality": `pipeline.run` tracklet structure and reprojection error of
  both packages.

`--study wide` runs the wide-rig scene (synthetic_sequence(60 frames, 10
people, 64 views, seed 0, noise 1 px, drop 0.05), PipelineConfig.wide(64):
two interleaved camera clusters) and prints:

- "wide_reference": the JAX package's `pipeline.run` quality (tracklets,
  top lengths, mean / median reprojection, degenerate poses), its per-frame
  ALS iterations and per-frame decision digests (`eval.decision_digests`):
  the constants `chip_smoke.py` holds the card's wide run against;
- "wide_sequence": the port's run on the CPU over the same frames: the
  same quality numbers, the first frame whose decisions differ from the
  JAX run's, and both runs' ALS iterations there;
- "wide_stepwise": every frame stepped by both packages from the same
  carried state: the frames whose decisions differ, with both packages'
  ALS iterations; for the first of them, each cluster's ALS problem solved
  by the JAX `match_als` and by the port's plain version on the same W:
  iterations, binarized entries that differ, and the smallest |X - 0.5|
  over the valid entries (the binarization margin); the same for the
  "wide_sequence" run's first diverging frame, from the JAX run's state.

`--solver gj_fused` runs the same with the fused LM solve (the wide
preset's other LM route, B4 in the port); every line then carries
`"solver"`.

`--study rig128` runs scripts/torch_bench_scaled.py's
128cam_x_10ppl_4clusters rig (128 views in 4 interleaved clusters, 10
people, seed 0, noise 1 px, drop 0.05, `ik_max_views=16`) over `--frames`
frames as its bench_config tracks it (one `run_offline` in IK mode, no
bad-pose filter) and prints "rig128_reference" (the JAX package's
tracklets, reprojection and per-frame ALS iterations) and
"rig128_sequence" (the port's on the CPU, the first frame whose decisions
differ, both ALS iteration counts there and each cluster's ALS problem at
that frame from the JAX run's state, as "wide_stepwise" prints them).

`--study clustered_appearance` runs the clustered association with
appearance: tests/test_torch_appearance.py's clustered rig at 10 views in 3
interleaved clusters (synthetic_sequence(`--frames` frames, 3 people, seed
2), ALS cap 100, `synthetic_appearance(dim=8, noise=0.05,
shared_frac=0.83)` with the auto gain at 8 px; the JAX side on its XLA
ALS), the filter and one `run_offline` in each package, and prints
"clustered_appearance_reference" (JAX's tracklets, reprojection and
per-frame ALS iterations, summed over the clusters) and
"clustered_appearance_sequence" (the port's, the first frame whose
decisions differ, the largest pose difference before it, and that frame's
clusters from the JAX run's state: each cluster's ALS iterations and
whether it ran into the cap, in both packages; the entries that binarize
otherwise with |X - 0.5| in each and the reach of JAX's own X there under
the port's W and `--draws` one-ulp draws of JAX's W; whether each split
is such a tie; the smallest margins; and whether the port's ALS on JAX's
own W gives JAX's grouping).

`--study bench` runs tests/test_torch_bench.py's scene
(synthetic_sequence(`--frames` frames, 3 people, 5 views), written in the
Shelf dataset's layout and read back, SHELF_BENCH with the ALS capped at
1,000) at seeds 0-3 in both packages and in the port with every LM solve in
float64 (the Cholesky route on float64 inputs, rounded to f32 for the
state: the witness).  One "bench" line a seed: the first frame where each
decision differs, the largest ALS iteration count of each package, the
largest pose difference before the decisions part, and `pipeline.run`'s
tracklets and reprojection for the three runs.  Where the decisions part,
that frame's ALS problem from the JAX run's state (iterations, binarized
entries that differ, margins) and, at frame 0, each solver's grouping and
whether it is the ground truth's.  Where a slot's pose parts by more than
1 mm first (`first_pose_gap`): the difference after one step of each
package from the JAX run's state there; the warm LM solve of that step on
the port's inputs by the port (f32), the JAX package (interpret mode) and
the witness, each with its cost and its joints' distance from the
witness's, the cost at the start and after 200 float64 iterations, the
normal matrix's extreme eigenvalues and the parameters of its softest
direction, and how far each solution moves for `--draws` random +-1e-7 rad
steps of the start's angles; then that slot's trajectory in the three
runs (their pairwise distances and each one's error against the ground
truth, frame by frame).

`--study cold` runs the 10-view, 3-cluster scene of
tests/test_torch_clusters.py (synthetic_sequence(6 frames, 3 people, 10
views), SHELF_BENCH with assoc_clusters=3, the JAX side on its XLA ALS) at
seeds 1 and 2 and prints one "cold_sensitivity" line per seed: the first
frame where each decision differs between the packages, the largest pose
difference on each frame where both updated a slot, and for every spawn
frame's cold LM solve, with the inputs the port's run gave it: for each
spawned slot, its views, the joint difference between the two packages'
solvers on those identical inputs, and for `--draws` random +-1e-7 steps of
the initial angles, how far each package's solution moves (largest joint
shift, m).

`--study default` runs the smoke test's `default` scene (the scene above
under `PipelineConfig(n_views=5)`, the JAX package's default preset: the
per-slot Cholesky LM, ALS capped at 1,000 iterations); `--study appearance`
the `appearance` scene (scripts/identity_study.py's
10cam_x_10ppl_f200_appearance_extractorgrade_auto8: 10 views, 10 people,
200 frames, `synthetic_appearance(noise=0.05, shared_frac=0.83)` with the
auto gain).  Each prints:

- "<study>_reference": the JAX package's tracklets, top lengths, mean /
  median reprojection and degenerate poses (its `pipeline.run` tracklets:
  the filter, one `run_offline`, the ghost filter), the frames whose ALS
  ran into its cap; for `default` the same in triangulation mode
  (`use_ik=False`, measured on the 17 COCO joints), for `appearance` the
  final auto-gain statistics (`app_stats`);
- "<study>_sequence": the port's run on the CPU over the same frames: the
  same numbers, the first frame whose decisions differ from the JAX run's,
  both runs' ALS iterations there, and that frame's ALS problem from the
  JAX run's state, solved by the JAX `match_als` and the port's plain
  version on each package's W (iterations, binarized entries that differ,
  the smallest |X - 0.5| over the valid entries).

`--study identity` runs the smoke test's `identity` phase on both packages:
the `appearance` scene's raw tracklets (the filter and one `run_offline`,
as that phase's `pipeline.run` gives them at min_track_length 1), then
`resolve_crossings`, `merge_tracklets` and `filter_ghost_tracklets(.,
chip_smoke.IDENTITY_MIN_TRACK_LENGTH)`, with `identity_metrics` against the
ground truth after each stage.  It prints:

- "identity_reference": the JAX package's stages (IDF1, ID switches,
  tracks, fragments per identity, and for the crossings stage its crossing
  events, swaps and cuts): the constants `chip_smoke.py`'s
  IDENTITY_REFERENCE holds;
- "identity_sequence": the port's stages on its own CPU run, and whether
  the port's post-passes on the JAX package's raw tracklets give the JAX
  package's tracklets and logs at every stage (they must: any difference
  then enters through the raw tracklets);
- "identity_divergence": the first raw tracklet of either run that the
  other lacks (id, frames, first frame), the first crossing-log entry that
  differs (both entries), the first frame whose decisions differ, both
  runs' ALS iterations there and that frame's ALS problem from the JAX
  run's state (iterations, binarized entries that differ, the smallest
  |X - 0.5|), as `--study appearance` prints it.

`--study detect` runs the smoke test's `detect` scene (scripts/
appearance_e2e_study.py's: synthetic_sequence(60 frames, 4 people, 5
views, seed 1), rendered at 192 x 256 with hue-spread tints and fed as
uint8) through the shipped bottom-up PoseNet and appearance head, then
`pipeline.run(use_ik=True, app=, crossings=True)`, in both packages on
the CPU, and prints:

- "detect_reference": the JAX package's detection recall, precision and
  mean error at 12 px, the valid detections of every (frame, view) as
  digits, the embeddings' same / different-person cosines, tracklets, top
  lengths, IDF1, ID switches and MPJPE: the constants `chip_smoke.py`'s
  DETECT_REFERENCE holds;
- "detect_sequence": the same numbers for the port, and the two detectors'
  outputs frame by frame (`chip_smoke.compare_detections`): images whose
  valid masks and center pixels are equal, the largest center shift and
  keypoint differences, the first image whose centers differ; the largest
  heat difference of the keypoint and center channels and of the offset
  channels; the first (frame, view) whose valid detections differ with
  both packages' top center-peak scores there;
- "cascade_reference": the JAX package's `make_multi_person_detector` and
  `make_detector` + `crops_to_frame_batch` on the scene's first 4 frames
  (`chip_smoke.run_cascade`): the constants of CASCADE_REFERENCE;
- "cascade_sequence": the port's, held against them
  (`chip_smoke.compare_cascade`).

`--study train` computes the references of the smoke test's training
phases on the CPU and prints:

- "train_reference": the JAX package's losses for `train_parity`'s steps
  (the shipped PoseNet from its checkpoint, TRAIN_PARITY_STEPS steps of
  `make_train_step` with `optax.adamw(TRAIN_PARITY_LR)` on the 8 samples of
  TRAIN_PARITY_SAMPLES), in f32 and bf16 compute: the constants
  `chip_smoke.py`'s TRAIN_REFERENCE holds;
- "train_port_cpu": the port's losses for the same steps on the CPU, their
  relative differences from JAX's, and the first step's gradients against
  JAX's (the largest difference over each leaf's largest magnitude, the
  smallest cosine, with their leaves); whether the two packages' samples
  are equal (images bit for bit, targets within 1e-6);
- "appearance_train_reference": the JAX package's held-out raw gap, best
  gap and its iteration for `appearance_train` (APPEARANCE_TRAIN, as
  scripts/train_appearance.py trains): APPEARANCE_TRAIN_REFERENCE;
- "appearance_train_port_cpu": the port's on the CPU (its head's initial
  weights come from a torch.Generator, not JAX's);
- "appearance_train_init_spread": the best gap of each package with the
  head initialised from seeds 1-4 on the same descriptors: how far the
  initial weights alone move it.

`--study steps` holds the port on the card against the port on the CPU, on
the `default` or `appearance` scene (`--scene`), frame by frame from one
state: it steps the scene on the CPU and carries the CPU's state to the card
before every frame.  One "steps" line a frame: the ALS input W that
`tracker.associate` forms on each device from that state (entries that
differ and by how much), the appearance penalties' largest difference, the
ALS iterations of the kernel on the card's W, of the plain version on the
card's W and of the CPU's association, the binarized entries where kernel
and plain differ on the same W; then how many entries of each float field
of the new state differ after the whole step on both devices.  Where every
W is equal, a card-vs-CPU difference of a whole run (`chip_smoke.py`'s
parity phases) enters through the state, not the association.  It needs an
NVIDIA GPU and not JAX.

The scenes' constants are `chip_smoke.py`'s.  It is a study script of the
port, not part of it: it imports both packages (`--study steps` only the
port).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from multiview_motion_capture_torch import eval as t_eval  # noqa: E402
from multiview_motion_capture_torch import pipeline as t_pipeline  # noqa: E402
from multiview_motion_capture_torch import tracker as t_tracker  # noqa: E402
from multiview_motion_capture_torch.config import SHELF_BENCH as T_SHELF_BENCH  # noqa: E402
from multiview_motion_capture_torch.data.ingest import filter_bad_poses as t_filter  # noqa: E402
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth  # noqa: E402
from multiview_motion_capture_torch.ops import association as t_assoc  # noqa: E402

try:    # every study but `steps` (which runs where there is a GPU and no JAX)
    import jax
    import jax.numpy as jnp

    from multiview_motion_capture_tpu import eval as j_eval
    from multiview_motion_capture_tpu import pipeline as j_pipeline
    from multiview_motion_capture_tpu import tracker as j_tracker
    from multiview_motion_capture_tpu.config import SHELF_BENCH as J_SHELF_BENCH
    from multiview_motion_capture_tpu.data.ingest import filter_bad_poses as j_filter
    from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth
    from multiview_motion_capture_tpu.ops import als_pallas
    from multiview_motion_capture_tpu.ops import association as j_assoc
except ImportError:
    jax = None

DECISIONS = ("track_id", "active", "updated", "spawned", "died_track_id", "matched_pose")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def grouping(x_bin: np.ndarray, elem_valid: np.ndarray) -> list:
    g = t_assoc.extract_groups(torch.as_tensor(x_bin), torch.as_tensor(elem_valid))
    rep = g.rep.numpy()
    return [int(r) if v else -1 for r, v in zip(rep, elem_valid)]


def same_group(reps: list) -> np.ndarray:
    """(n, n) bool: elements i != j are valid and share a group."""
    r = np.asarray(reps)
    return (r[:, None] == r[None, :]) & (r[:, None] >= 0) & ~np.eye(len(r), dtype=bool)


def ulp_draw(W: np.ndarray, rng) -> np.ndarray:
    """W (f32) moved one unit in the last place up or down at a tenth of its
    nonzero entries, kept symmetric."""
    step = np.where(rng.rand(*W.shape) < 0.1, rng.choice([-1, 1], W.shape), 0)
    step = np.triu(step, 1)
    step = step + step.T
    out = np.where(step > 0, np.nextafter(W, np.float32(2)),
                   np.where(step < 0, np.nextafter(W, np.float32(-1)), W))
    return np.where(W == 0, W, out).astype(np.float32)


def frame0_study(jctx, tctx, jb, tb, cfg, draws: int, gt_slot_person) -> None:
    kw = dict(alpha=cfg.als_alpha, beta=cfg.als_beta, mu0=cfg.als_mu, tol=cfg.als_tol,
              max_iter=cfg.als_max_iter, stable_iters=cfg.als_stable_iters)
    Wj, evj = j_tracker._spatial_similarity(jctx, jnp.asarray(jb.kps[0]),
                                            jnp.asarray(jb.valid[0]))
    Wt, evt = t_tracker._spatial_similarity(tctx, torch.as_tensor(tb.kps[0]),
                                            torch.as_tensor(tb.valid[0]))
    Wj, ev = np.asarray(Wj), np.asarray(evj)
    Wt = Wt.numpy()
    assert np.array_equal(ev, evt.numpy())
    valid2 = ev[:, None] & ev[None, :]
    mask, init = np.asarray(jctx.diag_mask), np.asarray(jctx.init_A)

    def jax_xla(W):
        r = j_assoc.match_als(jnp.asarray(W), jnp.asarray(mask), jnp.asarray(init), **kw)
        return np.asarray(r.x_bin), int(r.n_iters), np.asarray(r.x)

    def jax_pallas(W):
        pc = als_pallas.PallasAlsContext.build(W.shape[0], mask, init)
        xb, it = als_pallas.match_als_pallas(
            als_pallas.pad_similarity(jnp.asarray(W), pc.pad), pc.keep, pc.eye_t,
            pc.init_A, pc.n_true, rank=pc.rank, interpret=True, **kw)
        return np.asarray(xb)[:W.shape[0], :W.shape[0]], int(it), None

    def port(W, dtype=torch.float32):
        r = t_assoc.match_als(torch.as_tensor(W, dtype=dtype), torch.as_tensor(mask),
                              torch.as_tensor(init), **kw)
        return r.x_bin.numpy(), int(r.n_iters), r.x.numpy()

    runs = {"jax_xla_f32": jax_xla(Wj), "jax_pallas_f32": jax_pallas(Wj),
            "port_f32": port(Wt), "port_f64": port(Wt, torch.float64)}
    # ground truth over the detection slots: same person id >= 0
    T = cfg.max_tracks
    gt = np.concatenate([np.full(T, -1), gt_slot_person.reshape(-1)])
    gt_same = same_group(np.where(ev, gt, -1))
    out = {"w_max_abs_diff": float(np.abs(Wj - Wt).max()),
           "w_entries_differing": int((Wj != Wt).sum()), "solvers": {}}
    for name, (xb, it, x) in runs.items():
        g = grouping(xb, ev)
        out["solvers"][name] = {
            "iters": it, "grouping": g,
            "is_ground_truth": bool(np.array_equal(same_group(g), gt_same)),
            "min_margin": (float(np.abs(x - 0.5)[valid2].min()) if x is not None else None)}
    xj, xt = runs["jax_xla_f32"][2], runs["port_f32"][2]
    flip = np.argwhere((runs["jax_xla_f32"][0] != runs["port_f32"][0]) & valid2)
    out["flipped_entries"] = [{"i": int(i), "j": int(j), "x_jax": float(xj[i, j]),
                               "x_port": float(xt[i, j])} for i, j in flip if i < j]
    rng = np.random.RandomState(0)
    hits = {"jax_xla_f32": 0, "port_f32": 0}
    for _ in range(draws):
        W = ulp_draw(Wt, rng)
        for name, solve in (("jax_xla_f32", jax_xla), ("port_f32", port)):
            hits[name] += bool(np.array_equal(same_group(grouping(solve(W)[0], ev)), gt_same))
    out["perturbed_draws"] = draws
    out["draws_with_ground_truth_grouping"] = hits
    emit({"study": "frame0", **out})


def stepwise_study(jctx, tctx, jb, tb, cfg, n_frames: int) -> None:
    jstep = jax.jit(j_tracker.make_step(jctx))
    tstep = t_tracker.make_step(tctx)
    jstate = j_tracker.TrackerState.zeros(cfg)
    differ, pose = [], 0.0
    for f in range(n_frames):
        arrays = {k: np.asarray(getattr(jstate, k))
                  for k in t_tracker.TrackerState.__dataclass_fields__}
        _, to = tstep(t_tracker.from_numpy_state(arrays, device="cpu"),
                      torch.as_tensor(tb.kps[f]), torch.as_tensor(tb.valid[f]))
        jstate, jo = jstep(jstate, (jnp.asarray(jb.kps[f]), jnp.asarray(jb.valid[f])))
        jo = jax.device_get(jo)
        if any(not np.array_equal(np.asarray(getattr(jo, k)), getattr(to, k).numpy())
               for k in DECISIONS):
            differ.append({"frame": f, "als_iters_jax": int(jo.als_iters),
                           "als_iters_port": int(to.als_iters)})
            continue
        upd = np.asarray(jo.updated)
        if upd.any():
            pose = max(pose, float(np.abs(np.asarray(jo.pose3d) - to.pose3d.numpy())[upd].max()))
    emit({"study": "stepwise", "frames": n_frames, "frames_with_differing_decisions": differ,
          "max_pose_diff_m_where_equal": pose})


def ik_sensitivity_study(tctx, tb, n_frames: int) -> None:
    from multiview_motion_capture_torch.ops import ik

    def run():
        _, o = t_tracker.run_offline(tctx, tb.kps[:n_frames], tb.valid[:n_frames])
        return t_tracker.outputs_to_numpy(o)

    base = run()
    solve = ik.batched_spd_solve
    rng = np.random.RandomState(1)

    def perturbed(A, g, one_program=True):
        noise = torch.as_tensor(rng.randn(*A.shape).astype(np.float32))
        A = A * (1 + 6e-8 * noise)
        return solve((0.5 * (A + A.transpose(1, 2))).contiguous(), g)

    ik.batched_spd_solve = perturbed
    try:
        pert = run()
    finally:
        ik.batched_spd_solve = solve
    same = all(np.array_equal(getattr(base, k), getattr(pert, k)) for k in DECISIONS)
    upd = base.updated & pert.updated
    d = np.abs(base.pose3d - pert.pose3d).max(-1)[upd]       # (n, 18) per joint
    emit({"study": "ik_sensitivity", "frames": n_frames, "decisions_equal": same,
          "max_pose_diff_m": float(d.max()),
          "p99_joint_pose_diff_m": float(np.percentile(d, 99))})


def _quality(tracklets, seq, ev) -> dict:
    m = ev.reprojection_metrics(tracklets, seq.batch, seq.cameras)
    return {"n_tracklets": m.n_tracklets, "top_lengths": m.lengths[:10],
            "mean_reproj_px": m.mean_reproj_px, "median_reproj_px": m.median_reproj_px,
            "n_degenerate_poses": m.n_degenerate_poses}


def _als_margins(Wj, Wt, ev, mask, init, kw) -> dict:
    """One ALS problem solved by the JAX `match_als` on JAX's W and by the
    port's plain version on the port's W: iterations, binarized entries
    that differ among the valid ones, and the binarization margins."""
    ev = np.asarray(ev)
    valid2 = ev[:, None] & ev[None, :] & ~np.eye(len(ev), dtype=bool)
    rj = j_assoc.match_als(Wj, jnp.asarray(mask), jnp.asarray(init), **kw)
    rt = t_assoc.match_als(Wt, torch.as_tensor(mask), torch.as_tensor(init), **kw)
    xj, xt = np.asarray(rj.x), rt.x.numpy()
    flips = (np.asarray(rj.x_bin) != rt.x_bin.numpy()) & valid2
    return {"w_max_abs_diff": float(np.abs(np.asarray(Wj) - Wt.numpy()).max()),
            "iters_jax": int(rj.n_iters), "iters_port": int(rt.n_iters),
            "x_bin_entries_differing": int(flips.sum() // 2),
            "min_margin_jax": float(np.abs(xj - 0.5)[valid2].min()),
            "min_margin_port": float(np.abs(xt - 0.5)[valid2].min()),
            "flipped_min_dist_from_half_jax": (float(np.abs(xj - 0.5)[flips].min())
                                               if flips.any() else None),
            "flipped_min_dist_from_half_port": (float(np.abs(xt - 0.5)[flips].min())
                                                if flips.any() else None)}


def _als_kw(cfg) -> dict:
    return dict(alpha=cfg.als_alpha, beta=cfg.als_beta, mu0=cfg.als_mu, tol=cfg.als_tol,
                max_iter=cfg.als_max_iter, stable_iters=cfg.als_stable_iters)


def _carry(jstate):
    return t_tracker.from_numpy_state(
        {k: np.asarray(getattr(jstate, k)) for k in t_tracker.TrackerState.__dataclass_fields__},
        device="cpu")


def _cluster_margins(jctx, tctx, jstate, kps, valid, cfg) -> list:
    """Each cluster's ALS problem at one frame, from the same state: the JAX
    `match_als` (f32) and the port's plain version on each package's own W."""
    jws = _cluster_ws(jctx, jstate, jnp.asarray(kps), jnp.asarray(valid), None, tctx.clusters,
                      j_tracker)
    tws = _cluster_ws(tctx, _carry(jstate), torch.as_tensor(kps), torch.as_tensor(valid), None,
                      tctx.clusters, t_tracker)
    return [{"cluster": c, **_als_margins(Wj, Wt, evj, jctx.cluster_diag_mask,
                                          jctx.cluster_init_A, _als_kw(cfg))}
            for c, ((Wj, evj), (Wt, _)) in enumerate(zip(jws, tws))]


def frame_ws(ctx, state, kps, valid, pkg, app=None):
    """A frame's one ALS input W (`assoc_clusters=1`) as `pkg`'s association
    forms it from `state`: spatial-time with a live track, else spatial,
    with the appearance terms and the auto gain when `app` is given; and
    the elements' validity, in `pkg`'s arrays."""
    as_array = jnp.asarray if pkg is j_tracker else torch.as_tensor
    kps, valid = as_array(kps), as_array(valid)
    app = None if app is None else as_array(app)
    if np.asarray(state.active).max() > 0:
        W, ev, _ = pkg._spatial_time_similarity(ctx, state, kps, valid, app=app)
        return W, ev
    gain = None if app is None else pkg._appearance_gain(ctx.cfg, state)
    return pkg._spatial_similarity(ctx, kps, valid, app=app, app_gain=gain)


def _single_margins(jctx, tctx, jstate, kps, valid, cfg, app=None) -> dict:
    """The one ALS problem of a frame (`assoc_clusters=1`), from the same
    state, with the frame's embeddings when appearance is on."""
    Wj, evj = frame_ws(jctx, jstate, kps, valid, j_tracker, app)
    Wt, _ = frame_ws(tctx, _carry(jstate), kps, valid, t_tracker, app)
    return _als_margins(Wj, Wt, evj, jctx.diag_mask, jctx.init_A, _als_kw(cfg))


def als_split(Wj, Wt, ev, mask, init, kw: dict, nudged=()) -> dict:
    """One ALS problem on which the packages part: the JAX `match_als`
    (f32) on JAX's W against the port's plain version on the port's W.

    For each entry the two binarize otherwise ("flips"): X and |X - 0.5|
    (the margin) in both packages, and the reach of JAX's own X there: how
    far it moves when JAX's input moves by the measured difference between
    the packages' inputs (`nudged`: the W JAX forms from each input so
    moved).  The split is a tie that rounding decides (`near_tie`) when
    that reach carries JAX's X across 0.5 at the flip with the smallest
    JAX margin: `tie_margin` <= `tie_bound`.  Also whether the port's plain
    version on JAX's own W gives JAX's grouping."""
    ev = np.array(ev)
    Wj = np.array(Wj, np.float32)
    Wt = np.array(Wt.numpy() if torch.is_tensor(Wt) else Wt, np.float32)
    m, a = jnp.asarray(mask), jnp.asarray(init)
    solve = jax.jit(lambda W: j_assoc.match_als(W, m, a, **kw))
    rj = solve(jnp.asarray(Wj))
    xj, bj = np.asarray(rj.x), np.array(rj.x_bin)

    def port(W):
        return t_assoc.match_als(torch.as_tensor(W), torch.as_tensor(np.array(mask)),
                                 torch.as_tensor(np.array(init)), **kw)

    rt, rtj = port(Wt), port(Wj)
    xt, bt = rt.x.numpy(), rt.x_bin.numpy()
    valid2 = ev[:, None] & ev[None, :] & ~np.eye(len(ev), dtype=bool)
    flips = np.argwhere(np.triu((bj != bt) & valid2))
    reach = np.zeros_like(xj)
    for W in nudged:
        reach = np.maximum(reach, np.abs(np.asarray(solve(jnp.asarray(W, jnp.float32)).x) - xj))
    entries = [{"i": int(i), "j": int(j), "x_jax": float(xj[i, j]), "x_port": float(xt[i, j]),
                "margin_jax": float(abs(xj[i, j] - 0.5)),
                "margin_port": float(abs(xt[i, j] - 0.5)),
                "reach_jax": float(reach[i, j])} for i, j in flips]
    tie = min(entries, key=lambda e: e["margin_jax"], default=None)
    same = np.array_equal(same_group(grouping(bj, ev)), same_group(grouping(rtj.x_bin.numpy(),
                                                                             ev)))
    return {"w_max_abs_diff": float(np.abs(Wj - Wt).max()),
            "iters_jax": int(rj.n_iters), "iters_port": int(rt.n_iters),
            "at_cap_jax": int(rj.n_iters) >= kw["max_iter"],
            "at_cap_port": int(rt.n_iters) >= kw["max_iter"],
            "x_bin_entries_differing": len(entries), "flips": entries,
            "min_margin_jax": float(np.abs(xj - 0.5)[valid2].min()),
            "min_margin_port": float(np.abs(xt - 0.5)[valid2].min()),
            "nudges": len(nudged),
            "tie_margin": None if tie is None else tie["margin_jax"],
            "tie_bound": None if tie is None else tie["reach_jax"],
            "near_tie": tie is not None and tie["margin_jax"] <= tie["reach_jax"],
            "port_on_jax_w_iters": int(rtj.n_iters),
            "port_on_jax_w_gives_jax_grouping": bool(same)}


def _cluster_ws(ctx, state, kps, valid, app, clusters, pkg):
    """Each cluster's ALS input W as `pkg`'s `_clustered_association`
    forms it (spatial-time with a live track, else spatial, with the
    appearance terms and the auto gain when `app` is given), and the
    elements' validity; `clusters` are the port context's."""
    cfg = ctx.cfg
    alive = bool(np.asarray(state.active).max() > 0)
    out = []
    for cl in clusters:
        views, vvalid = cl.views, cl.view_valid
        if pkg is j_tracker:
            views, vvalid = views.numpy(), None if vvalid is None else vvalid.numpy()
        if alive:
            W, ev, _ = pkg._spatial_time_similarity(ctx, state, kps, valid, view_idx=views,
                                                    app=app, view_valid=vvalid)
        else:
            gain = None if app is None else pkg._appearance_gain(cfg, state)
            W, ev = pkg._spatial_similarity(ctx, kps, valid, view_idx=views, app=app,
                                            app_gain=gain, view_valid=vvalid)
        out.append((W, ev))
    return out


def cluster_splits(jctx, tctx, jstate, kps, valid, app=None, draws: int = 4) -> list:
    """`als_split` for each camera cluster's ALS problem at one frame, from
    the JAX run's state, both packages on the same detections (and
    embeddings).  The inputs differ by the rounding of W alone, so the
    nudges are the port's W itself and `draws` one-ulp draws of JAX's."""
    tstate = _carry(jstate)
    ja = None if app is None else jnp.asarray(app)
    ta = None if app is None else torch.as_tensor(app)
    jws = _cluster_ws(jctx, jstate, jnp.asarray(kps), jnp.asarray(valid), ja, tctx.clusters,
                      j_tracker)
    tws = _cluster_ws(tctx, tstate, torch.as_tensor(kps), torch.as_tensor(valid), ta,
                      tctx.clusters, t_tracker)
    rng = np.random.RandomState(0)
    out = []
    for c, ((Wj, ev), (Wt, _)) in enumerate(zip(jws, tws)):
        Wj = np.asarray(Wj, np.float32)
        nudged = [Wt.numpy().astype(np.float32)] + [ulp_draw(Wj, rng) for _ in range(draws)]
        out.append({"cluster": c, **als_split(Wj, Wt, ev, jctx.cluster_diag_mask,
                                              jctx.cluster_init_A, _als_kw(jctx.cfg), nudged)})
    return out


def _coco17(tracklets):
    """Triangulation-mode poses are COCO order plus the mid-spine; the
    reprojection metric reads an 18-joint pose as BASIC_18, so measure
    them on their 17 COCO joints."""
    return [dataclasses.replace(t, poses_3d=np.asarray(t.poses_3d)[:, :17]) for t in tracklets]


def _preset(name: str):
    """The smoke test's `default` or `appearance` scene: the config's
    fields, synthetic_sequence's arguments (n_frames included) and the
    embeddings' (None without appearance)."""
    if name == "default":
        return chip_smoke.DEFAULT_CFG, chip_smoke.SCENE, None
    return chip_smoke.APPEARANCE_CFG, chip_smoke.APPEARANCE_SCENE, chip_smoke.APPEARANCE_EMBED


def preset_study(name: str, n_frames: int) -> None:
    from multiview_motion_capture_torch.config import PipelineConfig as TConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_appearance as t_app
    from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
    from multiview_motion_capture_tpu.data.synthetic import synthetic_appearance as j_app

    over, scene, embed = _preset(name)
    scene = dict(scene, n_frames=n_frames)
    jcfg, tcfg = JConfig(**over), TConfig(**over)
    js, ts = j_synth(cfg=jcfg, **scene), t_synth(cfg=tcfg, **scene)
    assert np.array_equal(js.batch.kps, ts.batch.kps)
    japp = tapp = None
    if embed is not None:
        japp, tapp = j_app(js, **embed), t_app(ts, **embed)
        assert np.array_equal(japp, tapp)
    jb, tb = j_filter(js.batch, jcfg), t_filter(ts.batch, tcfg)
    cap = tcfg.als_max_iter

    def j_run(use_ik=True):
        ctx = j_tracker.TrackerContext.build(js.cameras, jcfg, use_ik=use_ik)
        st, o = j_tracker.run_offline(ctx, jnp.asarray(jb.kps), jnp.asarray(jb.valid),
                                      app=None if japp is None else jnp.asarray(japp))
        o = jax.device_get(o)
        tl = j_pipeline.filter_ghost_tracklets(j_tracker.assemble_tracklets(o),
                                               jcfg.min_track_length)
        return ctx, jax.device_get(st), o, tl

    def t_run(use_ik=True):
        ctx = t_tracker.TrackerContext.build(ts.cameras, tcfg, use_ik=use_ik, device="cpu")
        st, o = t_tracker.run_offline(ctx, tb.kps, tb.valid, app=tapp)
        o = t_tracker.outputs_to_numpy(o)
        tl = t_pipeline.filter_ghost_tracklets(t_tracker.assemble_tracklets(o),
                                               tcfg.min_track_length)
        return ctx, st, o, tl

    jctx, jst, jo, jtl = j_run()
    ref = {"study": f"{name}_reference", "frames": n_frames, **_quality(jtl, js, j_eval),
           "als_iters_at_cap_frames": int((np.asarray(jo.als_iters) >= cap).sum()),
           "als_iters_mean": float(np.asarray(jo.als_iters).mean())}
    if name == "default":
        _, _, _, jtl_tri = j_run(use_ik=False)
        ref["no_ik"] = _quality(_coco17(jtl_tri), js, j_eval)
    else:
        ref["app_stats"] = np.asarray(jst.app_stats).tolist()
    emit(ref)

    tctx, tst, to, ttl = t_run()
    j_dig, t_dig = t_eval.decision_digests(jo), t_eval.decision_digests(to)
    first = next((f for f in range(n_frames) if j_dig[f] != t_dig[f]), None)
    out = {"study": f"{name}_sequence", "frames": n_frames, **_quality(ttl, ts, t_eval),
           "als_iters_at_cap_frames": int((to.als_iters >= cap).sum()),
           "als_iters_mean": float(to.als_iters.mean()),
           "frames_decisions_equal": sum(a == b for a, b in zip(j_dig, t_dig)),
           "first_diverging_frame": first,
           "als_iters_there": (None if first is None else
                               {"jax": int(jo.als_iters[first]), "port": int(to.als_iters[first])})}
    if name == "default":
        out["no_ik"] = _quality(_coco17(t_run(use_ik=False)[3]), ts, t_eval)
    else:
        out["app_stats"] = tst.app_stats.numpy().tolist()
    if first is not None:
        # the JAX run's state before the first diverging frame, by its own step
        jstep = jax.jit(j_tracker.make_step(jctx))
        jstate = j_tracker.TrackerState.zeros(jcfg)
        for f in range(first):
            frame = (jnp.asarray(jb.kps[f]), jnp.asarray(jb.valid[f]))
            if japp is not None:
                frame = frame + (jnp.asarray(japp[f]),)
            jstate, _ = jstep(jstate, frame)
        out["als_there_from_jax_state"] = _single_margins(
            jctx, tctx, jstate, jb.kps[first], jb.valid[first], jcfg,
            None if japp is None else japp[first])
    emit(out)


def _identity_stages(tracklets, gt_slot_person, crossings, reid, ghost_filter, ev) -> tuple:
    """One package's post-passes in `pipeline.run`'s order; returns (the
    stages' identity scores, each stage's tracklets, the crossing log)."""

    def score(ts):
        m = ev.identity_metrics(ts, gt_slot_person)
        return {"n_tracks": m.n_pred_tracks, "idf1": m.idf1, "id_switches": m.id_switches,
                "fragments": m.fragments_per_identity, "gt_identities": m.n_gt_identities}

    crossed, log = crossings.resolve_crossings(list(tracklets), return_log=True)
    merged = reid.merge_tracklets(crossed)
    final = ghost_filter(merged, chip_smoke.IDENTITY_MIN_TRACK_LENGTH)
    stages = {"raw": tracklets, "crossings": crossed, "reid": merged, "ghost_filter": final}
    scores = {k: score(v) for k, v in stages.items()}
    scores["crossings"].update(
        events=sum(1 for e in log if "t_star" in e), swaps=sum(1 for e in log if e.get("swap")),
        cuts=sum(1 for e in log if "cut_track" in e or "cut" in e))
    return scores, stages, log


def _tracklet_key(t) -> tuple:
    return (int(t.track_id), tuple(int(f) for f in t.frame_idxs),
            np.asarray(t.matched_pose).tobytes())


def _same_tracklets(a, b) -> bool:
    return len(a) == len(b) and all(
        _tracklet_key(x) == _tracklet_key(y)
        and all(np.array_equal(np.asarray(getattr(x, f)), np.asarray(getattr(y, f)),
                               equal_nan=True)
                for f in ("roots", "eulers", "side_lens", "poses_3d", "poses_score", "app"))
        for x, y in zip(a, b))


def identity_study(n_frames: int) -> None:
    from multiview_motion_capture_torch import crossings as t_crossings
    from multiview_motion_capture_torch import reid as t_reid
    from multiview_motion_capture_torch.config import PipelineConfig as TConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_appearance as t_app
    from multiview_motion_capture_torch.tracker import Tracklet as TTracklet
    from multiview_motion_capture_tpu import crossings as j_crossings
    from multiview_motion_capture_tpu import reid as j_reid
    from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
    from multiview_motion_capture_tpu.data.synthetic import synthetic_appearance as j_app

    over, scene, embed = _preset("appearance")
    scene = dict(scene, n_frames=n_frames)
    jcfg, tcfg = JConfig(**over), TConfig(**over)
    js, ts = j_synth(cfg=jcfg, **scene), t_synth(cfg=tcfg, **scene)
    japp, tapp = j_app(js, **embed), t_app(ts, **embed)
    assert np.array_equal(js.batch.kps, ts.batch.kps) and np.array_equal(japp, tapp)
    jb, tb = j_filter(js.batch, jcfg), t_filter(ts.batch, tcfg)
    gt = js.gt_slot_person

    jctx = j_tracker.TrackerContext.build(js.cameras, jcfg)
    _, jo = j_tracker.run_offline(jctx, jnp.asarray(jb.kps), jnp.asarray(jb.valid),
                                  app=jnp.asarray(japp))
    jo = jax.device_get(jo)
    j_raw = j_tracker.assemble_tracklets(jo)
    tctx = t_tracker.TrackerContext.build(ts.cameras, tcfg, device="cpu")
    _, to = t_tracker.run_offline(tctx, tb.kps, tb.valid, app=tapp)
    to = t_tracker.outputs_to_numpy(to)
    t_raw = t_tracker.assemble_tracklets(to)

    j_scores, j_stages, j_log = _identity_stages(j_raw, gt, j_crossings, j_reid,
                                                 j_pipeline.filter_ghost_tracklets, j_eval)
    emit({"study": "identity_reference", "frames": n_frames,
          "min_track_length": chip_smoke.IDENTITY_MIN_TRACK_LENGTH, **j_scores})
    t_scores, _, t_log = _identity_stages(t_raw, gt, t_crossings, t_reid,
                                          t_pipeline.filter_ghost_tracklets, t_eval)
    # the port's post-passes on the JAX run's raw tracklets
    fields = [f.name for f in dataclasses.fields(TTracklet)]
    as_port = [TTracklet(**{k: getattr(t, k) for k in fields}) for t in j_raw]
    x_scores, x_stages, x_log = _identity_stages(as_port, gt, t_crossings, t_reid,
                                                 t_pipeline.filter_ghost_tracklets, t_eval)
    emit({"study": "identity_sequence", "frames": n_frames, **t_scores,
          "port_post_passes_on_jax_raw_equal_jax": {
              **{k: _same_tracklets(x_stages[k], j_stages[k]) for k in j_stages},
              "crossing_log": x_log == j_log, "scores": x_scores == j_scores}})

    j_keys = {_tracklet_key(t) for t in j_raw}
    t_keys = {_tracklet_key(t) for t in t_raw}

    def first_unmatched(tl, other):
        odd = sorted((t for t in tl if _tracklet_key(t) not in other),
                     key=lambda t: (t.frame_idxs[0], t.track_id))
        return None if not odd else {"track_id": int(odd[0].track_id),
                                     "first_frame": int(odd[0].frame_idxs[0]),
                                     "frames": len(odd[0]), "of": len(odd)}

    j_dig, t_dig = t_eval.decision_digests(jo), t_eval.decision_digests(to)
    first = next((f for f in range(n_frames) if j_dig[f] != t_dig[f]), None)
    k = next((i for i, (a, b) in enumerate(zip(j_log, t_log)) if a != b),
             None if len(j_log) == len(t_log) else min(len(j_log), len(t_log)))
    out = {"study": "identity_divergence",
           "raw_tracklet_only_in_jax": first_unmatched(j_raw, t_keys),
           "raw_tracklet_only_in_port": first_unmatched(t_raw, j_keys),
           "first_crossing_log_entry_differing": None if k is None else {
               "index": k, "jax": j_log[k] if k < len(j_log) else None,
               "port": t_log[k] if k < len(t_log) else None},
           "first_diverging_frame": first,
           "als_iters_there": (None if first is None else
                               {"jax": int(jo.als_iters[first]), "port": int(to.als_iters[first])})}
    if first is not None:
        jstep = jax.jit(j_tracker.make_step(jctx))
        jstate = j_tracker.TrackerState.zeros(jcfg)
        for f in range(first):
            jstate, _ = jstep(jstate, (jnp.asarray(jb.kps[f]), jnp.asarray(jb.valid[f]),
                                       jnp.asarray(japp[f])))
        out["als_there_from_jax_state"] = _single_margins(
            jctx, tctx, jstate, jb.kps[first], jb.valid[first], jcfg, japp[first])
    emit(out)


def detect_study(n_frames: int) -> None:
    from examples.e2e_fullframe import scaled_cameras as j_scaled_cameras
    from multiview_motion_capture_torch.data import detect as t_detect
    from multiview_motion_capture_torch.data.detect_train import (
        evaluate_detections as t_evaluate,
    )
    from multiview_motion_capture_torch.models import checkpoint as t_ckpt
    from multiview_motion_capture_torch.pose_def import KpsFormat as TKps
    from multiview_motion_capture_torch.pose_def import common_kps_index as t_common
    from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
    from multiview_motion_capture_tpu.data import detect as j_detect
    from multiview_motion_capture_tpu.data.detect_train import evaluate_detections as j_evaluate
    from multiview_motion_capture_tpu.data.detect_train import render_sequence as j_render
    from multiview_motion_capture_tpu.data.render import RenderConfig as JRender
    from multiview_motion_capture_tpu.models import checkpoint as j_ckpt
    from multiview_motion_capture_tpu.models.pose_net import PoseNet as JPoseNet
    from multiview_motion_capture_tpu.pose_def import KpsFormat as JKps
    from multiview_motion_capture_tpu.pose_def import common_kps_index as j_common

    ts, tcfg, frames, tcams = chip_smoke.detect_scene(n_frames)
    jcfg = JConfig(**chip_smoke.DETECT_CFG)
    scene = dict(chip_smoke.DETECT_SCENE, n_frames=n_frames)
    js = j_synth(cfg=jcfg, **scene)
    r = chip_smoke.DETECT_RENDER
    jframes = j_render(js, JRender(hw=r["hw"]), world_scale=r["world_scale"], seed=r["seed"],
                       person_tints=chip_smoke.person_tints(scene["n_people"]))
    assert np.array_equal(chip_smoke.to_uint8(jframes), frames)
    jcams = j_scaled_cameras(js.cameras, r["world_scale"])
    ck = chip_smoke.CHECKPOINTS
    jm, jparams = j_ckpt.load_posenet(ck / "posenet_synth.npz")
    jhead = j_ckpt.load_appearance_head(ck / "appearance_head.npz")
    tm, tnet = t_ckpt.load_posenet(ck / "posenet_synth.npz", device="cpu")
    _, thead = t_ckpt.load_appearance_head(ck / "appearance_head.npz", device="cpu")
    jdet = j_detect.make_bottom_up_detector(jm, appearance_head=jhead, **chip_smoke.DETECTOR)
    tdet = t_detect.make_bottom_up_detector(tm, appearance_head=thead, **chip_smoke.DETECTOR)

    jbatch, japp = j_detect.frames_to_frame_batch(jdet, jparams, frames, jcfg,
                                                  collect_appearance=True)
    jres = j_pipeline.run(jbatch, jcams, jcfg, use_ik=True, app=japp, crossings=True)
    jq = chip_smoke.detect_quality(js, jbatch, japp, jres.tracklets, j_evaluate,
                                   j_eval.identity_metrics, j_eval.mpjpe_vs_ground_truth,
                                   j_common(JKps.BASIC_18, JKps.COCO))
    emit({"study": "detect_reference", "frames": n_frames, **jq})

    tbatch, tapp = t_detect.frames_to_frame_batch(tdet, tnet, frames, tcfg,
                                                  collect_appearance=True)
    tres = t_pipeline.run(tbatch, tcams, tcfg, use_ik=True, app=tapp, crossings=True,
                          device="cpu")
    tq = chip_smoke.detect_quality(ts, tbatch, tapp, tres.tracklets, t_evaluate,
                                   t_eval.identity_metrics, t_eval.mpjpe_vs_ground_truth,
                                   t_common(TKps.BASIC_18, TKps.COCO))
    jraw, traw, heat_kc, heat_off = [], [], 0.0, 0.0
    K = jm.n_kps
    jnet = JPoseNet(jm)
    for f in range(n_frames):
        jraw.append([np.asarray(a) for a in jdet(jparams, frames[f])[:3]])
        traw.append([a.numpy() for a in tdet(tnet, frames[f])[:3]])
        x = frames[f].astype(np.float32) / 255.0
        hj = np.asarray(jnet.apply({"params": jparams}, jnp.asarray(x)))
        with torch.no_grad():
            ht = tnet(torch.as_tensor(x)).numpy()
        heat_kc = max(heat_kc, float(np.abs(hj[..., :K + 1] - ht[..., :K + 1]).max()))
        heat_off = max(heat_off, float(np.abs(hj[..., K + 1:] - ht[..., K + 1:]).max()))
    first = next((i for i, (a, b) in enumerate(zip(jq["valid_counts"], tq["valid_counts"]))
                  if a != b), None)
    there = None
    if first is not None:
        f, v = divmod(first, tcfg.n_views)
        there = {"frame": f, "view": v, "jax_centers": jraw[f][1][v].tolist(),
                 "port_centers": traw[f][1][v].tolist()}
    emit({"study": "detect_sequence", "frames": n_frames, **tq,
          "detections_vs_jax": chip_smoke.compare_detections(jraw, traw),
          "max_heat_diff_keypoint_center": heat_kc, "max_heat_diff_offsets": heat_off,
          "first_view_frame_counts_differ": there})

    cf = frames[:chip_smoke.CASCADE_FRAMES]
    jc = chip_smoke.run_cascade(j_detect, jm, jparams, jcfg, cf, np.asarray)
    emit({"study": "cascade_reference", **jc})
    tc = chip_smoke.run_cascade(t_detect, tm, tnet, tcfg, cf, lambda a: a.cpu().numpy())
    emit({"study": "cascade_sequence", **chip_smoke.compare_cascade(tc, jc)})


def _jax_step_grads(cfg, params, batch):
    """JAX's bottom-up step's loss and gradients, through its own
    make_train_step with a transformation that keeps the gradient as its
    state and updates nothing."""
    import optax

    from multiview_motion_capture_torch.models import checkpoint as t_ckpt
    from multiview_motion_capture_tpu.data import detect_train as j_train

    tx = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    _, grads, _ = j_train.make_train_step(cfg, tx)(params, tx.init(params), *batch)
    return {t_ckpt.keystr(tuple(k.key for k in path)): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}


def _jax_appearance_train(embs, labels, ve, vl, A, init_seed) -> dict:
    """scripts/train_appearance.py's loop in the JAX package, the head
    initialised from PRNGKey(init_seed)."""
    import optax

    from multiview_motion_capture_tpu.models import appearance_net as j_app_net

    cfg = j_app_net.AppearanceHeadConfig(in_dim=embs.shape[-1])
    params = j_app_net.init_head(jax.random.PRNGKey(init_seed), cfg)
    tx = optax.adamw(A["lr"], weight_decay=A["weight_decay"])
    opt = tx.init(params)
    step = j_app_net.make_train_step(cfg, tx, tau=A["tau"])
    e, lab, ve, vl = map(jnp.asarray, (embs, labels, ve, vl))
    s, d = j_app_net.cosine_gap(ve, vl)
    best, best_it = -1.0, 0
    for i in range(A["iters"]):
        params, opt, _ = step(params, opt, e, lab)
        if (i + 1) % 25 == 0:
            gs, gd = j_app_net.cosine_gap(j_app_net.apply_head(cfg, params, ve), vl)
            if float(gs - gd) > best:
                best, best_it = float(gs - gd), i + 1
    return {"n_train": int(len(labels)), "n_val": int(len(vl)), "raw_gap": float(s - d),
            "gap": best, "best_iter": best_it}


def train_study() -> None:
    import optax

    from multiview_motion_capture_tpu.data import appearance_train as j_app
    from multiview_motion_capture_tpu.data import detect_train as j_train
    from multiview_motion_capture_tpu.data.render import RenderConfig as JRender
    from multiview_motion_capture_tpu.models import checkpoint as j_ckpt

    kw = dict(chip_smoke.TRAIN_PARITY_SAMPLES)
    seeds = kw.pop("seeds")
    js = j_train.generate_samples(seeds, JRender(hw=(192, 256)), **kw)
    ts = chip_smoke.train_parity_samples("cpu")
    same = bool(np.array_equal(js.images, ts.images) and all(
        np.abs(getattr(js, f) - getattr(ts, f)).max() <= 1e-6
        for f in ("heat_tgt", "off_tgt", "off_mask")))
    batch = [jnp.asarray(a) for a in (ts.images, ts.heat_tgt, ts.off_tgt, ts.off_mask)]
    jm, jparams = j_ckpt.load_posenet(chip_smoke.CHECKPOINTS / "posenet_synth.npz")
    ref, port = {}, {}
    for name in ("float32", "bfloat16"):
        cfg = dataclasses.replace(jm, compute_dtype=getattr(jnp, name))
        tx = optax.adamw(chip_smoke.TRAIN_PARITY_LR)
        step = j_train.make_train_step(cfg, tx)
        p, o, losses = jparams, tx.init(jparams), []
        for _ in range(chip_smoke.TRAIN_PARITY_STEPS):
            p, o, loss = step(p, o, *batch)
            losses.append(float(loss))
        ref[name] = losses
        tl, tg = chip_smoke.train_parity_run(torch, "cpu", getattr(torch, name), ts)
        port[name] = {"losses": tl, "vs_jax_rel": chip_smoke.rel_diffs(tl, losses),
                      "grads_vs_jax": chip_smoke.grad_agreement(
                          _jax_step_grads(cfg, jparams, batch), tg)}
    emit({"study": "train_reference", **ref})
    emit({"study": "train_port_cpu", "samples_equal": same, **port})

    A = chip_smoke.APPEARANCE_TRAIN
    script = chip_smoke.script_module("torch_train_appearance")
    embs, labels = j_app.descriptor_batch(seed=A["seed"], n_scenes=A["n_scenes"],
                                          n_frames=A["n_frames"])
    ve, vl = j_app.descriptor_batch(seed=A["seed"] + script.VAL_SEED_OFFSET,
                                    n_scenes=A["val_scenes"], n_frames=A["n_frames"])
    emit({"study": "appearance_train_reference",
          **_jax_appearance_train(embs, labels, ve, vl, A, A["seed"])})
    emit({"study": "appearance_train_port_cpu", **chip_smoke.appearance_train_run(torch, "cpu")})
    # how far the best gap moves with the head's initial weights alone
    te, tv = torch.as_tensor(embs), torch.as_tensor(ve)
    spread = {"jax": [], "port": []}
    for seed in range(1, 5):
        spread["jax"].append(_jax_appearance_train(embs, labels, ve, vl, A, seed)["gap"])
        spread["port"].append(script.train_head(
            te, torch.as_tensor(labels), tv, torch.as_tensor(vl), A["iters"], A["lr"],
            A["weight_decay"], A["tau"], seed, "cpu", log=lambda m: None)[1])
    emit({"study": "appearance_train_init_spread", "init_seeds": [1, 2, 3, 4], **spread})


def wide_study(n_frames: int, solver: str = "gj") -> None:
    from multiview_motion_capture_torch.config import PipelineConfig as TConfig
    from multiview_motion_capture_tpu.config import PipelineConfig as JConfig

    jcfg = JConfig.wide(64, max_frames=None, ik_solver=solver)
    tcfg = TConfig.wide(64, max_frames=None, ik_solver=solver)
    kw = dict(n_frames=n_frames, n_people=10, n_views=64, seed=0, noise_px=1.0, drop_prob=0.05)
    js, ts = j_synth(cfg=jcfg, **kw), t_synth(cfg=tcfg, **kw)
    assert np.array_equal(js.batch.kps, ts.batch.kps)
    jb, tb = j_filter(js.batch, jcfg), t_filter(ts.batch, tcfg)
    jctx = j_tracker.TrackerContext.build(js.cameras, jcfg)
    tctx = t_tracker.TrackerContext.build(ts.cameras, tcfg, device="cpu")

    jr = j_pipeline.run(js.batch, js.cameras, jcfg, use_ik=True)
    _, jo = j_tracker.run_offline(jctx, jnp.asarray(jb.kps), jnp.asarray(jb.valid))
    jo = jax.device_get(jo)
    j_dig = t_eval.decision_digests(jo)
    emit({"study": "wide_reference", "solver": solver, "frames": n_frames,
          **_quality(jr.tracklets, js, j_eval),
          "als_iters": np.asarray(jo.als_iters).tolist(), "decision_digests": j_dig})

    _, to = t_tracker.run_offline(tctx, tb.kps, tb.valid)
    to = t_tracker.outputs_to_numpy(to)
    t_dig = t_eval.decision_digests(to)
    first = next((f for f in range(n_frames) if j_dig[f] != t_dig[f]), None)
    tl = t_pipeline.filter_ghost_tracklets(t_tracker.assemble_tracklets(to), tcfg.min_track_length)
    emit({"study": "wide_sequence", "solver": solver, "frames": n_frames,
          **_quality(tl, ts, t_eval),
          "first_diverging_frame": first,
          "als_iters_there": (None if first is None else
                              {"jax": int(jo.als_iters[first]), "port": int(to.als_iters[first])}),
          "als_iters": to.als_iters.tolist()})

    jstep = jax.jit(j_tracker.make_step(jctx))
    tstep = t_tracker.make_step(tctx)
    jstate = j_tracker.TrackerState.zeros(jcfg)
    differ, margins, seq_margins = [], None, None
    for f in range(n_frames):
        if f == first:
            seq_margins = {"frame": f, "clusters": _cluster_margins(
                jctx, tctx, jstate, jb.kps[f], jb.valid[f], jcfg)}
        arrays = {k: np.asarray(getattr(jstate, k))
                  for k in t_tracker.TrackerState.__dataclass_fields__}
        _, o = tstep(t_tracker.from_numpy_state(arrays, device="cpu"),
                     torch.as_tensor(tb.kps[f]), torch.as_tensor(tb.valid[f]))
        new_jstate, o_j = jstep(jstate, (jnp.asarray(jb.kps[f]), jnp.asarray(jb.valid[f])))
        o_j = jax.device_get(o_j)
        if any(not np.array_equal(np.asarray(getattr(o_j, k)), getattr(o, k).numpy())
               for k in DECISIONS):
            differ.append({"frame": f, "als_iters_jax": int(o_j.als_iters),
                           "als_iters_port": int(o.als_iters)})
            if margins is None:
                margins = {"frame": f, "clusters": _cluster_margins(
                    jctx, tctx, jstate, jb.kps[f], jb.valid[f], jcfg)}
        jstate = new_jstate
    emit({"study": "wide_stepwise", "solver": solver, "frames": n_frames,
          "frames_with_differing_decisions": differ,
          "first_differing_frame_clusters": margins,
          "sequence_first_diverging_frame_clusters": seq_margins})


def rig128_study(n_frames: int) -> None:
    """scripts/torch_bench_scaled.py's 128cam_x_10ppl_4clusters rig in both
    packages on the CPU, as its bench_config tracks it (no bad-pose filter,
    one run_offline in IK mode): tracklets, reprojection, the first frame
    whose decisions differ, both runs' ALS iterations there, and each
    cluster's ALS problem at that frame from the JAX run's state."""
    from multiview_motion_capture_tpu.config import PipelineConfig as JConfig

    bs = chip_smoke.script_module("torch_bench_scaled")
    kw = dict(bs.configs(cam128=True)["128cam_x_10ppl_4clusters"], n_frames=n_frames)
    tcfg = bs.scaled_config(kw["n_views"], kw["n_people"], clusters=kw["clusters"],
                            ik_max_views=kw["ik_max_views"])
    # the JAX side on its XLA ALS, as on any non-TPU backend
    jcfg = JConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(JConfig)})
    ts = bs.scaled_scene(tcfg, kw["n_people"], n_frames)
    js = j_synth(n_frames=n_frames, n_people=kw["n_people"], n_views=kw["n_views"], cfg=jcfg,
                 seed=0, noise_px=1.0, drop_prob=0.05)
    assert np.array_equal(js.batch.kps, ts.batch.kps)
    jctx = j_tracker.TrackerContext.build(js.cameras, jcfg)
    tctx = t_tracker.TrackerContext.build(ts.cameras, tcfg, device="cpu")
    kps, valid = ts.batch.kps, ts.batch.valid
    _, jo = j_tracker.run_offline(jctx, jnp.asarray(kps), jnp.asarray(valid))
    jo = jax.device_get(jo)
    _, to = t_tracker.run_offline(tctx, kps, valid)
    to = t_tracker.outputs_to_numpy(to)
    j_dig, t_dig = t_eval.decision_digests(jo), t_eval.decision_digests(to)
    first = next((f for f in range(n_frames) if j_dig[f] != t_dig[f]), None)
    emit({"study": "rig128_reference", "frames": n_frames,
          **_quality(j_tracker.assemble_tracklets(jo), js, j_eval),
          "als_iters": np.asarray(jo.als_iters).tolist()})
    margins = None
    if first is not None:
        jstate = j_tracker.TrackerState.zeros(jcfg)
        if first > 0:
            jstate, _ = j_tracker.run_offline(jctx, jnp.asarray(kps[:first]),
                                              jnp.asarray(valid[:first]))
        margins = _cluster_margins(jctx, tctx, jstate, kps[first], valid[first], jcfg)
    emit({"study": "rig128_sequence", "frames": n_frames,
          **_quality(t_tracker.assemble_tracklets(to), ts, t_eval),
          "first_diverging_frame": first,
          "als_iters_there": (None if first is None else
                              {"jax": int(jo.als_iters[first]), "port": int(to.als_iters[first])}),
          "first_diverging_frame_clusters": margins, "als_iters": to.als_iters.tolist()})


# the clustered path with appearance: tests/test_torch_appearance.py's
# clustered rig (its CLUSTERED config) at 10 views in 3 clusters, seed 2
CLUSTERED_APPEARANCE_CFG = dict(n_views=10, max_people=4, max_tracks=6, max_frames=None,
                                als_max_iter=100, assoc_clusters=3, appearance_dim=8,
                                appearance_auto_target_px=8.0)
CLUSTERED_APPEARANCE_SCENE = dict(n_frames=30, n_people=3, n_views=10, seed=2)
CLUSTERED_APPEARANCE_EMBED = dict(dim=8, noise=0.05, shared_frac=0.83)


def clustered_appearance_study(over: dict = CLUSTERED_APPEARANCE_CFG,
                               scene: dict = CLUSTERED_APPEARANCE_SCENE,
                               embed: dict = CLUSTERED_APPEARANCE_EMBED,
                               draws: int = 4) -> dict:
    """Both packages' whole run of the clustered association with
    appearance on the CPU (the JAX side on its XLA ALS): the filter and one
    `run_offline` each, with `synthetic_appearance(**embed)`.  Prints and
    returns "clustered_appearance_reference" (the JAX run's tracklets,
    reprojection and per-frame ALS iterations, summed over the clusters)
    and "clustered_appearance_sequence" (the port's, the first frame whose
    decisions differ, the largest pose difference before it, and at that
    frame `cluster_splits` from the JAX run's state: each cluster's ALS
    iterations and caps, the entries that binarize otherwise with their
    margins and reach, whether each split is a tie that rounding decides,
    and whether the port's ALS on JAX's W gives JAX's grouping)."""
    from multiview_motion_capture_torch.config import PipelineConfig as TConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_appearance as t_app
    from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
    from multiview_motion_capture_tpu.data.synthetic import synthetic_appearance as j_app

    jcfg, tcfg = JConfig(**over, als_backend="xla"), TConfig(**over)
    js, ts = j_synth(cfg=jcfg, **scene), t_synth(cfg=tcfg, **scene)
    assert np.array_equal(js.batch.kps, ts.batch.kps)
    japp, tapp = j_app(js, **embed), t_app(ts, **embed)
    assert np.array_equal(japp, tapp)
    jb, tb = j_filter(js.batch, jcfg), t_filter(ts.batch, tcfg)
    jctx = j_tracker.TrackerContext.build(js.cameras, jcfg)
    tctx = t_tracker.TrackerContext.build(ts.cameras, tcfg, device="cpu")
    F = scene["n_frames"]
    _, jo = j_tracker.run_offline(jctx, jnp.asarray(jb.kps), jnp.asarray(jb.valid),
                                  app=jnp.asarray(japp))
    jo = jax.device_get(jo)
    _, to = t_tracker.run_offline(tctx, tb.kps, tb.valid, app=tapp)
    to = t_tracker.outputs_to_numpy(to)
    j_dig, t_dig = t_eval.decision_digests(jo), t_eval.decision_digests(to)
    first = next((f for f in range(F) if j_dig[f] != t_dig[f]), None)
    rig = {"frames": F, "views": over["n_views"], "clusters": over["assoc_clusters"],
           "seed": scene["seed"], "als_max_iter": over["als_max_iter"]}

    def tracklets(pkg, out):
        return t_pipeline.filter_ghost_tracklets(pkg.assemble_tracklets(out),
                                                 tcfg.min_track_length)

    ref = {"study": "clustered_appearance_reference", **rig,
           **_quality(tracklets(j_tracker, jo), js, j_eval),
           "als_iters": np.asarray(jo.als_iters).tolist()}
    emit(ref)
    stop = F if first is None else first
    upd = np.asarray(jo.updated)[:stop] & to.updated[:stop]
    splits = None
    if first is not None:
        jstate = j_tracker.TrackerState.zeros(jcfg)
        if first > 0:
            jstate, _ = j_tracker.run_offline(jctx, jnp.asarray(jb.kps[:first]),
                                              jnp.asarray(jb.valid[:first]),
                                              app=jnp.asarray(japp[:first]))
        splits = cluster_splits(jctx, tctx, jstate, jb.kps[first], jb.valid[first],
                                japp[first], draws)
    differing = [c for c in splits or () if c["x_bin_entries_differing"]]
    seq = {"study": "clustered_appearance_sequence", **rig,
           **_quality(tracklets(t_tracker, to), ts, t_eval),
           "first_diverging_frame": first,
           "max_pose_diff_m_before": (float(np.abs(np.asarray(jo.pose3d)[:stop]
                                                   - to.pose3d[:stop])[upd].max())
                                      if upd.any() else None),
           "als_iters_there": (None if first is None else
                               {"jax": int(jo.als_iters[first]),
                                "port": int(to.als_iters[first])}),
           "first_diverging_frame_clusters": splits,
           "smallest_margin": (None if splits is None else
                               {"jax": min(c["min_margin_jax"] for c in splits),
                                "port": min(c["min_margin_port"] for c in splits)}),
           "port_als_on_jax_w_gives_jax_grouping": (
               None if splits is None
               else all(c["port_on_jax_w_gives_jax_grouping"] for c in splits)),
           "split_is_rounding_tie": (None if splits is None else
                                     bool(differing) and all(c["near_tie"]
                                                             for c in differing)),
           "als_iters": to.als_iters.tolist()}
    emit(seq)
    return {"reference": ref, "sequence": seq}


def cold_sensitivity_study(seeds, draws: int, n_frames: int = 6, delta: float = 1e-7) -> None:
    import functools

    from multiview_motion_capture_torch.ops import ik as t_ik
    from multiview_motion_capture_tpu.ops import ik as j_ik

    for seed in seeds:
        change = dict(n_views=10, assoc_clusters=3, max_frames=None)
        jcfg = dataclasses.replace(J_SHELF_BENCH, als_backend="xla", **change)
        tcfg = dataclasses.replace(T_SHELF_BENCH, **change)
        assert tcfg.ik_cold_iters != tcfg.ik_warm_iters
        kw = dict(n_frames=n_frames, n_people=3, n_views=10, seed=seed)
        js, ts = j_synth(cfg=jcfg, **kw), t_synth(cfg=tcfg, **kw)
        jb, tb = j_filter(js.batch, jcfg), t_filter(ts.batch, tcfg)
        jctx = j_tracker.TrackerContext.build(js.cameras, jcfg)
        tctx = t_tracker.TrackerContext.build(ts.cameras, tcfg, device="cpu")
        _, jo = j_tracker.run_offline(jctx, jnp.asarray(jb.kps), jnp.asarray(jb.valid))
        jo = jax.device_get(jo)

        # the port's run, keeping each cold LM solve's inputs (one call per
        # frame that spawns a track)
        cold, solve = [], t_ik.solve_two_stage

        def recording(init, skel, obs, w, P, n_iters, **lm_kw):
            if n_iters == tcfg.ik_cold_iters:
                cold.append((init, obs, w, P, lm_kw))
            return solve(init, skel, obs, w, P, n_iters, **lm_kw)

        t_ik.solve_two_stage = recording
        try:
            _, to = t_tracker.run_offline(tctx, tb.kps, tb.valid)
        finally:
            t_ik.solve_two_stage = solve
        to = t_tracker.outputs_to_numpy(to)

        first = {}
        for f in DECISIONS:
            bad = np.nonzero((np.asarray(getattr(jo, f)) != getattr(to, f))
                             .reshape(n_frames, -1).any(1))[0]
            first[f] = int(bad[0]) if len(bad) else None
        both = np.asarray(jo.updated) & to.updated
        pose_by_frame = [float(np.abs(np.asarray(jo.pose3d)[f] - to.pose3d[f])[both[f]].max())
                         if both[f].any() else None for f in range(n_frames)]

        spawn_frames = np.nonzero(to.spawned.any(1))[0].tolist()
        assert len(spawn_frames) == len(cold)
        solves = []
        for f, (init, obs, w, P, lm_kw) in zip(spawn_frames, cold):
            j_solve = jax.jit(functools.partial(j_ik.solve_two_stage, n_iters=tcfg.ik_cold_iters,
                                                interpret=True, **lm_kw))

            def both_solvers(euler):
                t_j = solve(init._replace(euler=euler), tctx.skel, obs, w, P,
                            tcfg.ik_cold_iters, **lm_kw)[1].numpy()
                j_init = j_ik.IkParams(jnp.asarray(init.root.numpy()), jnp.asarray(euler.numpy()),
                                       jnp.asarray(init.side_lens.numpy()))
                j_j = np.asarray(j_solve(j_init, jctx.skel, jnp.asarray(obs.numpy()),
                                         jnp.asarray(w.numpy()), jnp.asarray(P.numpy()))[1])
                return t_j, j_j

            slots = np.nonzero(to.spawned[f])[0]
            t0, j0 = both_solvers(init.euler)
            shifts = []
            for d in range(draws):
                rng = np.random.RandomState(d)
                step = torch.as_tensor(delta * rng.choice([-1.0, 1.0], tuple(init.euler.shape)),
                                       dtype=init.euler.dtype)
                euler = init.euler + step
                t1, j1 = both_solvers(euler)
                shifts.append({
                    "max_euler_change": float((euler - init.euler).abs().max()),
                    "port_joint_shift_m": [float(np.abs(t1[s] - t0[s]).max()) for s in slots],
                    "jax_joint_shift_m": [float(np.abs(j1[s] - j0[s]).max()) for s in slots]})
            solves.append({"frame": f, "slots": slots.tolist(),
                           "views": (w.numpy()[slots] > 0).sum(1).tolist(),
                           "port_vs_jax_same_inputs_m": [float(np.abs(t0[s] - j0[s]).max())
                                                         for s in slots],
                           "draws": shifts})
        emit({"study": "cold_sensitivity", "seed": seed, "frames": n_frames,
              "first_diverging_frame": first, "max_pose_diff_m_by_frame": pose_by_frame,
              "cold_solves": solves})


def _lm_f64(solve):
    """`solve_two_stage` with every input in float64 and the Cholesky route
    (the LM with no f32 rounding), its result rounded to f32 for the
    tracker's state: the witness of the bench study."""
    from multiview_motion_capture_torch.ops import ik as t_ik

    def solve64(init, skel, obs, w, P, n_iters, **lm_kw):
        d = torch.float64
        p, j = solve(t_ik.IkParams(*(a.to(d) for a in init)), skel.to(d), obs.to(d), w.to(d),
                     P.to(d), n_iters, **dict(lm_kw, solver="chol"))
        return t_ik.IkParams(*(a.float() for a in p)), j.float()

    return solve64


def _param_name(i: int) -> str:
    from multiview_motion_capture_torch.ops.ik import N_JOINTS

    if i < 3:
        return f"root[{i}]"
    if i < 3 + 3 * N_JOINTS:
        return f"euler[{(i - 3) // 3}][{(i - 3) % 3}]"
    return f"side_lens[{i - 3 - 3 * N_JOINTS}]"


def _lm_conditioning(x, skel, obs, w, P, eps, slot) -> dict:
    """The damping-free normal matrix JᵀJ of one slot at x, in float64: its
    extreme eigenvalues and the parameters that dominate its softest
    direction."""
    from multiview_motion_capture_torch.ops import ik as t_ik

    d = torch.float64
    _, J = t_ik._residual_and_jacobian(x.to(d), skel.to(d), t_ik.add_mid_spine(obs.to(d)),
                                       w.to(d), P.to(d), eps)
    ev, vec = torch.linalg.eigh(J[slot].T @ J[slot])
    soft = vec[:, 0].abs()
    top = torch.argsort(soft, descending=True)[:3].tolist()
    return {"eig_min": float(ev[0]), "eig_max": float(ev[-1]),
            "softest_direction": {_param_name(i): round(float(soft[i]), 4) for i in top}}


def _lm_cost(params, skel, obs, w, P, eps) -> np.ndarray:
    """Each slot's LM objective (sum of squared weighted residuals) at
    params, in float64."""
    from multiview_motion_capture_torch.ops import ik as t_ik

    d = torch.float64
    r = t_ik._residual(params.pack().to(d), skel.to(d), t_ik.add_mid_spine(obs.to(d)),
                       w.to(d), P.to(d), eps)
    return (r * r).sum(1).numpy()


def _slot_mpjpe(pose3d, updated, gt_3d, slot) -> list:
    """One slot's error (m) against the nearest ground-truth person, on the
    joints common to BASIC_18 and COCO, on each frame it was updated."""
    from multiview_motion_capture_torch.pose_def import KpsFormat, common_kps_index

    sk, gt = common_kps_index(KpsFormat.BASIC_18, KpsFormat.COCO)
    out = []
    for f in range(len(pose3d)):
        if not updated[f, slot]:
            out.append(None)
            continue
        X, G = pose3d[f, slot][sk], gt_3d[f][:, gt]
        out.append(round(float(np.linalg.norm(G - X[None], axis=-1).mean(-1).min()), 5))
    return out


def _first_frame_groupings(jctx, tctx, jb, tb, cfg, gt_slot_person) -> dict:
    """The first frame's ALS problem (no live track) solved by the JAX
    `match_als` on JAX's W and by the port's plain version on the port's W,
    in f32 and f64: iterations, the grouping of the valid detections, and
    whether it is the ground truth's."""
    kw = _als_kw(cfg)
    Wj, evj = j_tracker._spatial_similarity(jctx, jnp.asarray(jb.kps[0]),
                                            jnp.asarray(jb.valid[0]))
    Wt, _ = t_tracker._spatial_similarity(tctx, torch.as_tensor(tb.kps[0]),
                                          torch.as_tensor(tb.valid[0]))
    ev = np.asarray(evj)
    mask, init = np.asarray(jctx.diag_mask), np.asarray(jctx.init_A)
    gt = np.concatenate([np.full(cfg.max_tracks, -1), gt_slot_person.reshape(-1)])
    gt_same = same_group(np.where(ev, gt, -1))
    rj = j_assoc.match_als(Wj, jnp.asarray(mask), jnp.asarray(init), **kw)
    runs = {"jax_f32": (np.asarray(rj.x_bin), int(rj.n_iters))}
    for name, dt in (("port_f32", torch.float32), ("port_f64", torch.float64)):
        r = t_assoc.match_als(Wt.to(dt), torch.as_tensor(mask), torch.as_tensor(init), **kw)
        runs[name] = (r.x_bin.numpy(), int(r.n_iters))
    out = {}
    for name, (xb, it) in runs.items():
        g = grouping(xb, ev)
        out[name] = {"iters": it, "grouping": g,
                     "is_ground_truth": bool(np.array_equal(same_group(g), gt_same))}
    return out


def bench_study(seeds, n_frames: int, draws: int, gap_m: float = 1e-3,
                delta: float = 1e-7) -> None:
    """tests/test_torch_bench.py's scene (synthetic_sequence(n_frames, 3
    people, 5 views), written in Shelf's layout and read back, SHELF_BENCH
    with the ALS capped at SETTLED_CAP) at each seed, in both packages and in
    the port with a float64 LM (the witness)."""
    import functools
    import tempfile

    from multiview_motion_capture_torch.cameras import CameraBank as TCams
    from multiview_motion_capture_torch.data.ingest import load_openpose_dir as t_load
    from multiview_motion_capture_torch.ops import ik as t_ik
    from multiview_motion_capture_tpu.cameras import CameraBank as JCams
    from multiview_motion_capture_tpu.data.ingest import load_openpose_dir as j_load
    from multiview_motion_capture_tpu.ops import ik as j_ik

    cap = 1000      # tests/test_torch_bench.py's SETTLED_CAP
    for seed in seeds:
        tcfg = dataclasses.replace(T_SHELF_BENCH, als_max_iter=cap, max_frames=n_frames)
        jcfg = dataclasses.replace(J_SHELF_BENCH, als_max_iter=cap, max_frames=n_frames)
        seq = t_synth(cfg=dataclasses.replace(T_SHELF_BENCH, max_frames=None),
                      n_frames=n_frames, n_people=3, n_views=5, seed=seed)
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            chip_smoke.write_scene_files(seq, root, n_frames, kps_dir="kps_opn")
            t_raw, j_raw = t_load(root / "kps_opn", tcfg), j_load(root / "kps_opn", jcfg)
            tcams = TCams.from_json_dir(root / "calibs")
            jcams = JCams.from_json_dir(root / "calibs")
        tb, jb = t_filter(t_raw, tcfg), j_filter(j_raw, jcfg)
        assert np.array_equal(tb.kps, np.asarray(jb.kps))
        tctx = t_tracker.TrackerContext.build(tcams, tcfg, device="cpu")
        jctx = j_tracker.TrackerContext.build(jcams, jcfg)
        _, jo = j_tracker.run_offline(jctx, jnp.asarray(jb.kps), jnp.asarray(jb.valid))
        jo = jax.device_get(jo)
        _, to = t_tracker.run_offline(tctx, tb.kps, tb.valid)
        to = t_tracker.outputs_to_numpy(to)
        solve = t_ik.solve_two_stage
        t_ik.solve_two_stage = _lm_f64(solve)
        try:
            _, wo = t_tracker.run_offline(tctx, tb.kps, tb.valid)
            w_res = t_pipeline.run(t_raw, tcams, tcfg, device="cpu")
        finally:
            t_ik.solve_two_stage = solve
        wo = t_tracker.outputs_to_numpy(wo)

        first = {}
        for f in DECISIONS:
            bad = np.nonzero((np.asarray(getattr(jo, f)) != getattr(to, f))
                             .reshape(n_frames, -1).any(1))[0]
            first[f] = int(bad[0]) if len(bad) else None
        stop = min([v for v in first.values() if v is not None], default=n_frames)
        jpose = np.asarray(jo.pose3d)
        both = np.asarray(jo.updated) & to.updated
        diff = np.abs(jpose - to.pose3d).max(axis=(2, 3))
        gaps = [(f, s) for f in range(stop) for s in np.nonzero(both[f])[0]
                if diff[f, s] > gap_m]
        quality = {}
        for name, res, ev, batch, cams in (
                ("port", t_pipeline.run(t_raw, tcams, tcfg, device="cpu"), t_eval, t_raw, tcams),
                ("jax", j_pipeline.run(j_raw, jcams, jcfg, use_ik=True), j_eval, j_raw, jcams),
                ("port_f64_lm", w_res, t_eval, t_raw, tcams)):
            m = ev.reprojection_metrics(res.tracklets, batch, cams)
            quality[name] = {"n_tracklets": m.n_tracklets, "lengths": m.lengths,
                             "mean_reproj_px": m.mean_reproj_px,
                             "median_reproj_px": m.median_reproj_px}
        row = {"study": "bench", "seed": seed, "frames": n_frames,
               "first_diverging_frame": first,
               "als_iters_max": {"jax": int(np.asarray(jo.als_iters).max()),
                                 "port": int(to.als_iters.max())},
               "max_pose_diff_m_before_divergence": float(diff[:stop][both[:stop]].max())
               if both[:stop].any() else None,
               "quality": quality, "first_pose_gap": None}
        if stop < n_frames:
            jstate = j_tracker.TrackerState.zeros(jcfg)
            if stop > 0:
                jstate, _ = j_tracker.run_offline(jctx, jnp.asarray(jb.kps[:stop]),
                                                  jnp.asarray(jb.valid[:stop]))
            row["diverging_frame_als"] = _single_margins(jctx, tctx, jstate, jb.kps[stop],
                                                         jb.valid[stop], jcfg)
            if stop == 0:
                row["diverging_frame_groupings"] = _first_frame_groupings(
                    jctx, tctx, jb, tb, jcfg, seq.gt_slot_person[0])
        if gaps:
            f, s = gaps[0]
            s = int(s)
            # one step of each package from the JAX run's state before f,
            # keeping the port's warm LM inputs
            jstate = j_tracker.TrackerState.zeros(jcfg)
            if f > 0:
                jstate, _ = j_tracker.run_offline(jctx, jnp.asarray(jb.kps[:f]),
                                                  jnp.asarray(jb.valid[:f]))
            warm = []

            def recording(init, skel, obs, w, P, n_iters, **lm_kw):
                if n_iters == tcfg.ik_warm_iters:
                    warm.append((init, skel, obs, w, P, lm_kw))
                return solve(init, skel, obs, w, P, n_iters, **lm_kw)

            t_ik.solve_two_stage = recording
            try:
                _, t1 = t_tracker.make_step(tctx)(_carry(jstate), torch.as_tensor(tb.kps[f]),
                                                  torch.as_tensor(tb.valid[f]))
            finally:
                t_ik.solve_two_stage = solve
            _, j1 = jax.jit(j_tracker.make_step(jctx))(
                jstate, (jnp.asarray(jb.kps[f]), jnp.asarray(jb.valid[f])))
            one_step = float(np.abs(np.asarray(j1.pose3d)[s] - t1.pose3d[s].numpy()).max())
            assert len(warm) == 1
            init, skel, obs, w, P, lm_kw = warm[0]
            n_it, eps = tcfg.ik_warm_iters, lm_kw.get("eps", 1e-5)
            j_solve = jax.jit(functools.partial(j_ik.solve_two_stage, n_iters=n_it,
                                                interpret=True, **lm_kw))

            def solved(euler):
                start = init._replace(euler=euler)
                p32, t32 = solve(start, skel, obs, w, P, n_it, **lm_kw)
                p64, t64 = _lm_f64(solve)(start, skel, obs, w, P, n_it, **lm_kw)
                j_init = j_ik.IkParams(*(jnp.asarray(a.numpy()) for a in start))
                pj, tj = j_solve(j_init, jctx.skel, jnp.asarray(obs.numpy()),
                                 jnp.asarray(w.numpy()), jnp.asarray(P.numpy()))
                pj = t_ik.IkParams(*(torch.as_tensor(np.asarray(a)) for a in pj))
                return ({"port": (p32, t32.numpy()), "jax": (pj, np.asarray(tj)),
                         "port_f64_lm": (p64, t64.numpy())})

            sols = solved(init.euler)
            conv, _ = _lm_f64(solve)(init, skel, obs, w, P, 200, **lm_kw)
            wit = sols["port_f64_lm"][1][s]
            shifts = []
            for d in range(draws):
                rng = np.random.RandomState(d)
                step = torch.as_tensor(delta * rng.choice([-1.0, 1.0], tuple(init.euler.shape)),
                                       dtype=init.euler.dtype)
                moved = solved(init.euler + step)
                shifts.append({k: float(np.abs(moved[k][1][s] - sols[k][1][s]).max())
                               for k in sols})
            row["first_pose_gap"] = {
                "frame": f, "slot": s, "pose_diff_m": float(diff[f, s]),
                "views": int((w[s] > 0).sum()),
                "one_step_from_jax_state_m": one_step,
                "same_inputs": {k: {"cost": float(_lm_cost(p, skel, obs, w, P, eps)[s]),
                                    "joints_vs_f64_lm_m": float(np.abs(j[s] - wit).max())}
                                for k, (p, j) in sols.items()},
                "cost_at_start": float(_lm_cost(init, skel, obs, w, P, eps)[s]),
                "cost_converged_f64_200_iters": float(_lm_cost(conv, skel, obs, w, P, eps)[s]),
                "normal_matrix_at_start": _lm_conditioning(init.pack(), skel, obs, w, P, eps, s),
                "euler_steps": {"delta_rad": delta, "joint_shift_m": shifts},
            }
            row["slot_trajectory"] = {
                "slot": s,
                "port_vs_jax_m": [round(float(x), 5) for x in diff[:, s]],
                "port_vs_f64_lm_m": [round(float(x), 5) for x in
                                     np.abs(wo.pose3d - to.pose3d).max(axis=(2, 3))[:, s]],
                "jax_vs_f64_lm_m": [round(float(x), 5) for x in
                                    np.abs(wo.pose3d - jpose).max(axis=(2, 3))[:, s]],
                "mpjpe_vs_truth_m": {
                    "port": _slot_mpjpe(to.pose3d, to.updated, seq.gt_3d, s),
                    "jax": _slot_mpjpe(jpose, np.asarray(jo.updated), seq.gt_3d, s),
                    "port_f64_lm": _slot_mpjpe(wo.pose3d, wo.updated, seq.gt_3d, s)}}
        emit(row)


def steps_study(scene: str, n_frames: int) -> None:
    from multiview_motion_capture_torch.config import PipelineConfig as TConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_appearance as t_app
    from multiview_motion_capture_torch.ops import als_kernel

    if not torch.cuda.is_available():
        raise SystemExit("--study steps needs an NVIDIA GPU")
    over, scene_kw, embed = _preset(scene)
    cfg = TConfig(**over)
    seq = t_synth(cfg=cfg, **dict(scene_kw, n_frames=n_frames))
    app = None if embed is None else t_app(seq, **embed)
    b = t_filter(seq.batch, cfg)
    devs = ("cpu", "cuda")
    ctx = {d: t_tracker.TrackerContext.build(seq.cameras, cfg, device=d) for d in devs}
    step = {d: t_tracker.make_step(ctx[d]) for d in devs}
    fields = t_tracker.TrackerState.__dataclass_fields__
    floats = ("root", "euler", "side_lens", "pose3d", "root_vel", "app_ema", "app_stats")
    seen, match_als = {}, als_kernel.match_als

    def capturing(W, *args, **kwargs):      # the ALS input `associate` formed
        seen[W.device.type] = W
        return match_als(W, *args, **kwargs)

    als_kernel.match_als = capturing
    state = t_tracker.TrackerState.zeros(cfg, device="cpu")
    try:
        for f in range(n_frames):
            on = {"cpu": state, "cuda": t_tracker.from_numpy_state(
                {k: getattr(state, k).numpy() for k in fields}, device="cuda")}
            frame = {d: (torch.as_tensor(b.kps[f], device=d),
                         torch.as_tensor(b.valid[f], device=d),
                         None if app is None else torch.as_tensor(app[f], device=d))
                     for d in devs}
            pred = {d: t_tracker.predict(on[d]) for d in devs}
            assoc = {d: t_tracker.associate(ctx[d], pred[d], *frame[d]) for d in devs}
            Wc, Wg = seen["cpu"], seen["cuda"].cpu()
            plain = t_assoc.match_als(Wg, ctx["cpu"].diag_mask, ctx["cpu"].init_A, **_als_kw(cfg))
            row = {"study": "steps", "scene": scene, "frame": f,
                   "w_entries_differing": int((Wg != Wc).sum()),
                   "w_max_abs_diff": float((Wg - Wc).abs().max()),
                   "iters_kernel_card_w": int(assoc["cuda"].n_iters),
                   "iters_plain_card_w": int(plain.n_iters),
                   "iters_plain_cpu_w": int(assoc["cpu"].n_iters),
                   "kernel_vs_plain_x_bin_differing": int(
                       (assoc["cuda"].x_bin.cpu() != plain.x_bin).sum())}
            if app is not None:
                pen = {}
                for d in devs:
                    gain = t_tracker._appearance_gain(cfg, pred[d])
                    pen[d] = (t_tracker._appearance_penalty(gain, pred[d].app_ema, frame[d][2]),
                              t_tracker._appearance_penalty_d22(gain, frame[d][2]))
                row["penalty_max_abs_diff"] = max(float((a.cpu() - c).abs().max())
                                                  for a, c in zip(pen["cuda"], pen["cpu"]))
            new = {d: step[d](on[d], *frame[d])[0] for d in devs}
            row["state_entries_differing"] = {
                k: n for k in floats
                if (n := int((getattr(new["cuda"], k).cpu() != getattr(new["cpu"], k)).sum()))}
            emit(row)
            state = new["cpu"]
    finally:
        als_kernel.match_als = match_als


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--study", choices=("shelf", "wide", "rig128", "clustered_appearance",
                                        "bench", "cold", "default", "appearance", "identity",
                                        "detect", "train", "steps"),
                    default="shelf")
    ap.add_argument("--solver", choices=("gj", "gj_fused"), default="gj",
                    help="the LM solver of --study wide")
    ap.add_argument("--scene", choices=("appearance", "default"), default="appearance",
                    help="the scene of --study steps")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames of the scene (300 for shelf and default, 60 for wide "
                         "and detect, 200 for appearance and identity, 20 for steps, "
                         "8 for rig128, 12 for bench, 30 for clustered_appearance)")
    ap.add_argument("--draws", type=int, default=None,
                    help="perturbation draws (12 for shelf, 2 for cold, 4 for bench and "
                         "clustered_appearance)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.study == "steps":
        steps_study(args.scene, args.frames or 20)
        return
    jax.config.update("jax_platforms", "cpu")
    if args.study == "cold":
        cold_sensitivity_study((1, 2), args.draws or 2)
        return
    if args.study == "bench":
        bench_study((0, 1, 2, 3), args.frames or 12, args.draws or 4)
        return
    if args.study == "identity":
        identity_study(args.frames or 200)
        return
    if args.study == "detect":
        detect_study(args.frames or chip_smoke.DETECT_SCENE["n_frames"])
        return
    if args.study == "train":
        train_study()
        return
    if args.study in ("default", "appearance"):
        preset_study(args.study, args.frames or (300 if args.study == "default" else 200))
        return
    if args.study == "clustered_appearance":
        clustered_appearance_study(scene=dict(CLUSTERED_APPEARANCE_SCENE,
                                              n_frames=args.frames or 30),
                                   draws=args.draws or 4)
        return
    args.draws = args.draws or 12
    if args.study == "wide":
        wide_study(args.frames or 60, args.solver)
        return
    if args.study == "rig128":
        rig128_study(args.frames or 8)
        return
    args.frames = args.frames or 300

    jcfg = dataclasses.replace(J_SHELF_BENCH, max_frames=None)
    tcfg = dataclasses.replace(T_SHELF_BENCH, max_frames=None)
    js = j_synth(n_frames=args.frames, n_people=4, n_views=5, cfg=jcfg, seed=0)
    ts = t_synth(n_frames=args.frames, n_people=4, n_views=5, cfg=tcfg, seed=0)
    assert np.array_equal(js.batch.kps, ts.batch.kps)
    jb, tb = j_filter(js.batch, jcfg), t_filter(ts.batch, tcfg)
    jctx = j_tracker.TrackerContext.build(js.cameras, jcfg)
    tctx = t_tracker.TrackerContext.build(ts.cameras, tcfg, device="cpu")

    frame0_study(jctx, tctx, jb, tb, jcfg, args.draws, js.gt_slot_person[0])

    _, jo = j_tracker.run_offline(jctx, jnp.asarray(jb.kps), jnp.asarray(jb.valid))
    jo = jax.device_get(jo)
    _, to = t_tracker.run_offline(tctx, tb.kps, tb.valid)
    to = t_tracker.outputs_to_numpy(to)
    first = {}
    for f in DECISIONS:
        a, c = np.asarray(getattr(jo, f)), np.asarray(getattr(to, f))
        bad = np.nonzero((a != c).reshape(a.shape[0], -1).any(1))[0]
        first[f] = int(bad[0]) if len(bad) else None
    stop = min([v for v in first.values() if v is not None], default=args.frames)
    upd = np.asarray(jo.updated)[:stop]
    pose = (float(np.abs(np.asarray(jo.pose3d)[:stop] - to.pose3d[:stop])[upd].max())
            if upd.any() else None)
    emit({"study": "sequence", "frames": args.frames, "first_diverging_frame": first,
          "max_pose_diff_m_before_divergence": pose,
          "als_iters_equal_frames": int((np.asarray(jo.als_iters) == to.als_iters).sum()),
          "frames_at_iteration_cap": {
              "jax": int((np.asarray(jo.als_iters) >= jcfg.als_max_iter).sum()),
              "port": int((to.als_iters >= tcfg.als_max_iter).sum())}})

    stepwise_study(jctx, tctx, jb, tb, jcfg, args.frames)
    ik_sensitivity_study(tctx, tb, min(60, args.frames))

    jr = j_pipeline.run(js.batch, js.cameras, jcfg, use_ik=True)
    tr = t_pipeline.run(ts.batch, ts.cameras, tcfg, device="cpu")
    for name, m in (("jax", j_eval.reprojection_metrics(jr.tracklets, js.batch, js.cameras)),
                    ("port", t_eval.reprojection_metrics(tr.tracklets, ts.batch, ts.cameras))):
        emit({"study": "quality", "package": name, "n_tracklets": m.n_tracklets,
              "top_lengths": m.lengths[:6], "mean_reproj_px": m.mean_reproj_px,
              "median_reproj_px": m.median_reproj_px,
              "n_degenerate_poses": m.n_degenerate_poses})


if __name__ == "__main__":
    main()
