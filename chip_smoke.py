#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `multiview_motion_capture_torch/csrc/`
(one nvcc per source, all started together) and holds each against its
plain torch version on the card, then drives the port's paths on the card,
each with the launch counters set to 0 just before it and read just after:

- `slice`: `pipeline.run` on SHELF_BENCH over a 300-frame, 4-person,
  5-camera synthetic scene (kernels B1 ALS, B2 Gauss-Jordan), its quality
  against the JAX package's numbers for that scene, a card-vs-CPU decision
  check (`parity`) and a profiler window (`profile`);
- `default`: `pipeline.run` on `PipelineConfig(n_views=5)`, the JAX
  package's default preset (the per-slot Cholesky LM with staged solves,
  ALS capped at 1,000 iterations; kernel B1), on the slice's scene, its
  quality against the JAX package's, `default_parity` (card vs CPU) and
  `default_profile`;
- `no_ik`: the same in triangulation mode (`use_ik=False`), its
  reprojection on the 17 COCO joints against the JAX skill's 3 px bound;
- `stream`: the streaming `MvTracker` (with the motion gate,
  `motion_gain=1.0`) over 30 frames of that scene, one `update` per frame
  and `update_batch` in chunks of 8 (the tail padded), each bit-equal to
  `run_offline`; the latency of one `update`;
- `appearance`: `pipeline.run` with appearance evidence on the identity
  study's 10-camera, 10-person, 200-frame scene (extractor-grade synthetic
  embeddings, the auto gain; kernels B1 as a cluster of 16, B2), its
  quality against the JAX package's, and `appearance_parity`;
- `identity`: the host post-passes on the appearance run's raw tracklets
  (`resolve_crossings`, `merge_tracklets`, the ghost filter at length 2),
  IDF1 and ID switches after each against the ground truth, the final IDF1
  held within IDF1_TOL of the JAX package's on the same scene;
- `checkpoint`: `pipeline.run(crossings=True, checkpoint_dir=...)` on that
  scene in chunks of 50 frames (B1, B2), its tracklets bit-equal to the
  `identity` phase's final ones, again after a resume from chunk 1, with
  the resumed state loaded onto the card;
- `detect`: the detection path from camera frames: a 60-frame, 4-person,
  5-camera scene rendered at 192 x 256 and fed as uint8 through the
  shipped bottom-up PoseNet and appearance head (`frames_to_frame_batch`),
  then `pipeline.run(use_ik=True, app=, crossings=True)` (B1, B2); its
  detection and identity quality against the JAX package's numbers for
  that scene, detection frames/s and the kernels a frame;
  `detect_parity` (the detector on the card against the CPU, bf16 and
  f32) and `cascade` (the propose -> crop -> top-down cascade and the
  top-down detector on its boxes against the JAX package's outputs);
- `train_parity`: the bottom-up PoseNet's training step at the shipped
  width from the shipped weights, 5 AdamW steps on 8 generated samples,
  card against the CPU (f32: losses and first-step gradients) and against
  the JAX package's losses (f32 and bf16), two card runs bit-equal under
  deterministic algorithms; `train`: a fresh PoseNet trained on the card in
  bf16 (400 steps of batch 16, the training script's warmup-cosine AdamW),
  steps/s, images/s, device ms, launches and idle share a step against the
  step's bound, gated on the loss falling; `appearance_train`: the
  appearance head's SupCon training on descriptors computed on the card,
  its held-out cosine gap gated as tests/test_appearance.py gates the
  shipped head and held near the JAX package's on the same data;
- `cli`: the CLI as a user runs it (`python -m multiview_motion_capture_torch`,
  child processes, on the card): the default preset's scene cut to 40
  frames and written as calibration and OpenPose files, `prepare` (its npz
  equal to `load_openpose_dir`), then `run --bvh --reid --crossings
  --debug_dump` (B1 at N = 66, rank 32): its tracklets bit-equal to an
  in-process `pipeline.run`, each BVH replayed by `fk_generic.animate_bvh`
  on the card within 2 cm, the dump's x_bin at every dumped frame equal to
  the step's association; `detect_cli`: the CLI's `detect` after its
  image reading on 10 rendered frames, its tracklets bit-equal to the
  library path's; `debug_clustered`: the association dump on an 8-view,
  2-cluster rig (B3 in its replay, B1 with its X output per cluster)
  against the same dump on the CPU; `alt`: `match_svt` and
  `associate_frame` (B1) on the card against the CPU;
- `wide`: `pipeline.run` on `PipelineConfig.wide(64)` over a 60-frame,
  10-person, 64-camera scene (two camera clusters: kernel B3 batched ALS,
  B2), its quality and per-frame decisions against the JAX package's run
  of that scene, `wide_fused` (the same with ik_solver="gj_fused": kernel
  B4), `wide_parity` (card vs CPU decisions) and `wide_profile`.

- the multi-device paths (`parallel/`), on meshes whose entries all are
  this card (what needs a second GPU is not certified here): `mesh_wide`
  (the wide rig's cluster ALS on a 2-entry cluster mesh, one B3 launch an
  entry, and its LM on a 4-entry track mesh, B2, then B4 under
  "gj_fused"), `mesh_cameras` (`PipelineConfig.wide(32)`: one cluster, B1
  at N 336, the similarity blocks camera-sharded over 4 entries), each
  bit-equal in x_bin, decisions and tracklets to the unsharded run;
  `mesh_spec` (`pipeline.run(mesh_spec=)` through the visible-device
  route on SHELF_BENCH, bit-equal to `slice`; JAX's errors for a cluster
  mesh without clusters and for more devices than visible); `streams`
  (four SHELF_BENCH streams in four threads, each bit-equal to
  `run_offline` alone); `mesh_train` (the dp x tp PoseNet step at (2, 2)
  and (1, 1) against the unsharded step, steps/s).

- the benchmark programs: `bench` (the CLI's `bench` mode, the package's
  `bench.py`, on the slice's scene written as files in the Shelf dataset's
  layout: `bench.measure` in-process and `bench --data_dir` in a child
  process, the tracklets bit-equal to `slice`'s, the JSON line's quality
  fields the slice's; a missing directory raises FileNotFoundError);
  `stream_curve` (scripts/torch_bench_streaming.py's `update_batch` curve
  over k in {1, 4, 8, 16, 32} on those files, every k bit-equal to
  `run_offline`); `scaled` (scripts/torch_bench_scaled.py's `bench_config`
  on its 10-camera rig, B1 at N 116, and its two 128-camera rigs, B3 at
  C 4, N 336 and at C 5, N 276 with dead pad views; each rig's first
  frames card against CPU).

- the last run programs: `profile_bench` (scripts/torch_profile_bench.py
  on the `bench` phase's files, 60 frames: the warm, unprofiled steady
  and device-only traced passes, the idle share of both, the traced
  outputs bit-equal to the steady ones; B1, B2), `e2e_synthetic` and
  `e2e_fullframe` (examples/torch_e2e_*.py at the JAX suite's sizes: a
  PoseNet trained on the card from rendered crops or frames, detection,
  `pipeline.run` in triangulation mode, B1; gated as the JAX suite gates
  the JAX examples), `bench_detect` (scripts/torch_bench_detect.py's
  `detect_track_e2e_fps` line at 10 frames with bench_detect.py's keys,
  B1, B2; the host syncs a frame of its staged detection loops).  The
  profile phases (`profile`, `default_profile`, `wide_profile`,
  `scaled_profile`) report through scripts/torch_profile_bench.py's
  `profile_tracker`.

- the eight research studies (`studies`, STUDY_CUTS' sizes): the
  benchmark's config bisection (B1, B2) and the fragmentation and oracle
  parity studies (B1; one scipy-oracle run between them) on the `bench`
  phase's files, the LM iteration study on the 64-camera rig (B3, B2),
  the identity study on two of its configurations (B1, B2), the
  appearance end-to-end study (B1), the crowd-detection and style
  hold-out studies (cuDNN only); each study's JSON held to its JAX
  script's keys, and each one's kernels launched.

The kernel checks also launch B1 and B3 with their X output
(`return_x=True`): X bit-equal to the plain version's, x_bin and the
iterations those of the launch without it (`als_x`, and `x_max_abs_err`,
`ms_with_x` on the two rows of the kernel table).

Kernel times (`ms`, `ms_with_x`, `plain_ms`, `library_ms`, `yardstick_ms`)
are CUDA events around back-to-back calls.  The LM solves (B2, B4, B5), whose calls
take a few tens of microseconds, also print the device time of the same
calls by torch.profiler (`device_ms`, `plain_device_ms`, ...): events
around back-to-back wrapper calls that short measure the host's dispatch
where it is the slower.  `spd_systems`, `lm_inputs`, `gj_route_systems`,
`cuda_time_ms` and `device_ms` are shared with
`scripts/torch_solve_timing.py` and `tests/test_torch_cuda.py`.

The phases run in six groups, each in a worker process of this script on
the card (`group_*`, GROUPS): `kernels` alone first, then the other five
side by side; each group prints its wall seconds when it ends, and any
group that fails, or the run's RUN_BUDGET_S passing, stops them all.

It prints one JSON line per phase with its wall seconds.  The last lines
are the card's `nvidia-smi` name and power limit, the kernel table and
`{"ok": true, "device": {...}}`.  Any failure exits non-zero without the
final line.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA's data sheet): HBM3 bytes/s, f32
# FLOP/s outside the tensor cores, dense bf16 FLOP/s on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

# the slice's scene, and the default preset's (its 10 detection slots per
# view pad the same people)
SCENE = dict(n_frames=300, n_people=4, n_views=5, seed=0)
DEFAULT_CFG = dict(n_views=5, max_frames=None)
# JAX package on the CPU, SCENE through pipeline.run with SHELF_BENCH,
# max_frames=None, use_ik=True
REFERENCE = dict(n_tracklets=13, top_lengths=[300, 299, 241, 171, 112, 22],
                 mean_reproj_px=1.899, median_reproj_px=1.558,
                 n_degenerate_poses=0)
REPROJ_TOL_PX = 0.05
# what this script fails on: a different grouping at a frame where the ALS
# does not settle splits or merges a fragment and moves the mean
# reprojection by about 0.1 px; a wrong pose or association moves it by
# whole pixels
REPROJ_GATE_PX = 0.25
# card vs CPU poses, equal decisions given.  Both devices form the math
# between the kernels in f64 and round once (utils/precision.WORK_DTYPE), so
# they hand the kernels the same f32 inputs and the poses come out equal;
# the printed error says so.  The gate is what a real fault does: the LM's
# accept/reject steps amplify one unit in the last place of the normal
# matrix to millimetres on early two-view tracks
# (scripts/torch_parity_study.py, "ik_sensitivity"), a wrong solve or a
# wrong observation moves a joint by decimetres
POSE_TOL_M = 1e-2
PARITY_FRAMES = 30
# the slice's profile window, and the frames whose host syncs `slice` counts
SLICE_PROFILE_FRAMES = 10
SYNC_FRAMES = 60

# the wide-rig scene of scripts/bench_scaled.py (64 cameras x 10 people)
WIDE_SCENE = dict(n_frames=60, n_people=10, n_views=64, seed=0, noise_px=1.0,
                  drop_prob=0.05)
# JAX package on the CPU, same scene and PipelineConfig.wide(64,
# max_frames=None) through pipeline.run with use_ik=True; per-frame ALS
# iterations (summed over the two clusters) and decision digests
# (eval.decision_digests) of its run_offline
# (scripts/torch_parity_study.py --study wide)
WIDE_REFERENCE = dict(
    n_tracklets=59, top_lengths=[59, 59, 59, 38, 35, 34, 30, 24, 22, 12],
    mean_reproj_px=15.936715358706099, median_reproj_px=1.9158019333922693,
    n_degenerate_poses=0,
    als_iters=[
        200, 200, 187, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200,
        200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200,
        200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200,
        200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200],
    decision_digests=[
        "173a21bf0f", "0e502e6d69", "1e233c3b77", "518e8adb1c", "379dbb8c06", "435d66b70a",
        "1db3a441e9", "a5977fba0f", "0a7c5ae99a", "f61e985460", "89e31c9851", "92659e90c3",
        "42b07bb541", "293261129a", "9260532990", "7eacc51df4", "6ec45e7dd6", "ade4b40ed7",
        "4ba0547805", "453e106e71", "3b5d98fa5f", "8a52d113ac", "cf48e75234", "d9c4ec476a",
        "d86dc9012c", "ca75b51315", "67d5368077", "587b61be60", "2a3d6218e7", "f352c7bb8f",
        "7d17167b0e", "612882277a", "dee8d6cf73", "f0f94046d7", "cffbd60ec4", "94c3709a4f",
        "0f62ce10bd", "2572955d23", "0334fb10e3", "9c2969c39a", "321d9a680d", "457c022d8a",
        "65428536f0", "8c211629b2", "d474b1b986", "d02c4c7564", "a885beb87f", "e54b1e02e5",
        "a99bea6d1e", "1c5310edfd", "44a899fd76", "22b8a005fb", "8b2bb9a886", "f631db586d",
        "68d9b6ce82", "f60b6f6f48", "ea92403c20", "b722c2a047", "4569ae0023", "9ede1e1cf5"],
)
WIDE_PARITY_FRAMES = 3
WIDE_PROFILE_FRAMES = 3

# the default preset on the slice's scene: JAX package on the CPU, the
# tracklets of its pipeline.run, in IK and in triangulation mode (the
# latter on the 17 COCO joints) (scripts/torch_parity_study.py --study
# default)
DEFAULT_REFERENCE = dict(n_tracklets=13, top_lengths=[300, 299, 242, 174, 112, 22],
                         mean_reproj_px=1.7905554183871784,
                         median_reproj_px=1.5558753475866767, n_degenerate_poses=0)
DEFAULT_NO_IK_REFERENCE = dict(n_tracklets=13, top_lengths=[300, 299, 241, 174, 112, 22],
                               mean_reproj_px=1.2912123099596216,
                               median_reproj_px=1.03596178080396, n_degenerate_poses=0)
# the JAX package's own bound for triangulation mode (its verify skill)
NO_IK_REPROJ_BOUND_PX = 3.0
DEFAULT_PARITY_FRAMES = 10
DEFAULT_PROFILE_FRAMES = 5
STREAM_FRAMES = 30
STREAM_CHUNK = 8

# scripts/identity_study.py's 10cam_x_10ppl_f200_appearance_extractorgrade_
# auto8 (lines 25-70, 148-150): 10 views x 10 people, 200 frames, rescue
# off, extractor-grade embeddings with the online auto gain
APPEARANCE_CFG = dict(n_views=10, max_people=10, max_tracks=16, max_frames=None,
                      als_max_iter=100, ik_warm_stages=1, ik_solver="gj", track_rescue_px=0.0,
                      appearance_dim=16, appearance_auto_target_px=8.0)
APPEARANCE_SCENE = dict(n_frames=200, n_people=10, n_views=10, seed=0, noise_px=1.0,
                        drop_prob=0.05)
APPEARANCE_EMBED = dict(dim=16, noise=0.05, shared_frac=0.83)
# JAX package on the CPU, same scene and config
# (scripts/torch_parity_study.py --study appearance)
APPEARANCE_REFERENCE = dict(
    n_tracklets=29, top_lengths=[200, 199, 199, 199, 194, 193, 167, 113, 77, 73],
    mean_reproj_px=2.0581043661681804, median_reproj_px=1.6518283784836114,
    n_degenerate_poses=0)
APPEARANCE_PARITY_FRAMES = 10
# the `identity` phase's post-passes on the appearance scene's raw tracklets:
# resolve_crossings, merge_tracklets, then the ghost filter at this length;
# the `checkpoint` phase runs the same through pipeline.run in chunks
IDENTITY_MIN_TRACK_LENGTH = 2
CHECKPOINT_EVERY = 50
# JAX package on the CPU, the same scene, raw tracklets and post-passes
# (scripts/torch_parity_study.py --study identity, "identity_reference")
IDENTITY_REFERENCE = dict(
    raw=dict(n_tracks=29, idf1=0.6774356385663807, id_switches=30),
    crossings=dict(n_tracks=39, idf1=0.6920747097425543, id_switches=35, events=7, swaps=0,
                   cuts=10),
    reid=dict(n_tracks=10, idf1=0.9843513377082281, id_switches=10),
    ghost_filter=dict(n_tracks=10, idf1=0.9843513377082281, id_switches=10))
# one mis-merged 20-frame fragment among the scene's ~2,000 person-frames
# moves IDF1 by about 0.01
IDF1_TOL = 0.01

# the detect path: scripts/appearance_e2e_study.py's scene and tracker
# (lines 83-145) from rendered frames fed as uint8, with the shipped
# PoseNet and appearance head; its tracker config with the head's 32-dim
# embeddings at the CLI's gain (__main__.py:333-347), IK on, crossings on
CHECKPOINTS = REPO / "multiview_motion_capture_tpu" / "models" / "checkpoints"
DETECT_SCENE = dict(n_frames=60, n_people=4, n_views=5, seed=1, noise_px=0.0, drop_prob=0.0,
                    min_person_distance=1.2)
DETECT_RENDER = dict(hw=(192, 256), world_scale=0.25, seed=2)
DETECT_CFG = dict(n_views=5, max_people=8, max_tracks=12, max_frames=None, als_max_iter=100,
                  ik_warm_stages=1, ik_solver="gj", track_rescue_px=0.0, appearance_dim=32,
                  appearance_gain_px=60.0)
DETECTOR = dict(max_people=8, full_hw=(192, 256), center_min_score=0.2, center_nms_window=5,
                return_appearance=True)
DETECT_MATCH_PX = 12.0
DETECT_PARITY_FRAMES = 10
CASCADE_FRAMES = 4
CASCADE_CROP_HW = (128, 96)
# what the detect phases hold: recall within 0.01 (12 of the scene's 1,200
# people seen) and mean error within 0.1 px of the JAX package's; card
# against CPU keypoints at the same center pixel, in f32 within
# DETECT_F32_KPS_TOL_PX (measured against JAX's f32: 6e-5 px), in bf16
# their 90th percentile within DETECT_BF16_KPS_P90_TOL_PX (JAX against the
# port's CPU run: 0.028-0.044 px): bf16 rounding flips the decode's
# discrete choices where two candidates lie within its noise (snap or
# regress at snap_min, the snap window's start, a center between two
# near-equal pixels), and a flip moves one keypoint by up to the snap
# window and the regression's error (27.4 px on the 60 frames: a peak of
# 0.14992 in JAX's map, 0.15037 in the port's), so the largest difference
# is printed, not gated
DETECT_RECALL_TOL = 0.01
DETECT_ERR_TOL_PX = 0.1
DETECT_F32_KPS_TOL_PX = 0.01
DETECT_BF16_KPS_P90_TOL_PX = 0.25
CASCADE_MEDIAN_TOL_PX = 0.5
# JAX package on the CPU, the detect scene through its bottom-up detector
# and pipeline.run (scripts/torch_parity_study.py --study detect,
# "detect_reference"); valid_counts: the valid detections of each (frame,
# view), frame-major
DETECT_REFERENCE = dict(
    recall=0.8866666666666667, precision=0.9568345323741008,
    mean_err_px=2.9332361221313477, n_det=1112,
    valid_counts=(
        "444444444444444444444444444444444444444444444444444444444444444444444444444"
        "444444444444444444444444444444444444444444444444444444444444444444444344444"
        "445444444444443444434444344443343433534334343343433433334333343333433334333"
        "343333433334333343333433334343343433334333343343433334434343333433434334343"),
    cos_same=0.8114898204803467, cos_diff=-0.18523991107940674,
    n_tracklets=6, top_lengths=[60, 60, 60, 51, 1, 1],
    idf1=0.9745762711864406, id_switches=0, mpjpe_m=0.06572180788690916)
# the same scene's first CASCADE_FRAMES frames through the JAX package's
# make_multi_person_detector and make_detector + crops_to_frame_batch
# (run_cascade; --study detect, "cascade_reference")
CASCADE_REFERENCE = dict(
    valid="44444444444444444444", crop_valid="44444444444444444444",
    boxes=[
        [16, 24], [132, 20], [140, 32], [36, 40], [36, 36], [80, 20], [160, 32], [0, 24],
        [144, 24], [16, 24], [60, 20], [76, 44], [0, 28], [76, 20], [132, 32], [144, 20],
        [44, 16], [160, 32], [140, 20], [28, 36], [132, 20], [140, 32], [16, 24], [40, 40],
        [160, 32], [80, 20], [36, 36], [0, 24], [60, 16], [144, 24], [16, 24], [72, 44],
        [0, 28], [144, 20], [72, 20], [136, 36], [160, 32], [44, 16], [140, 20], [28, 36],
        [144, 32], [132, 20], [16, 24], [40, 40], [0, 24], [80, 20], [160, 32], [40, 36],
        [60, 16], [144, 24], [12, 24], [68, 40], [140, 20], [72, 20], [0, 28], [136, 36],
        [160, 32], [44, 16], [140, 20], [32, 36], [132, 20], [144, 32], [16, 24], [44, 40],
        [40, 36], [0, 24], [76, 20], [160, 32], [60, 16], [144, 24], [12, 24], [64, 44],
        [140, 20], [72, 16], [0, 28], [140, 32], [48, 16], [160, 32], [140, 20], [32, 36]],
    mean_xy=[
        [66.103, 86.988], [181.745, 86.068], [181.943, 89.614], [68.658, 90.75],
        [111.825, 85.988], [128.458, 82.846], [226.802, 86.275], [45.08, 87.075],
        [191.664, 86.34], [76.916, 85.499], [101.136, 82.374], [110.237, 85.156],
        [26.298, 83.956], [123.784, 82.827], [193.244, 84.761], [191.096, 83.663],
        [90.032, 81.865], [187.162, 86.543], [192.607, 85.084], [89.743, 81.953],
        [179.081, 82.433], [180.345, 85.68], [66.358, 85.879], [68.453, 92.725],
        [225.217, 86.05], [128.093, 82.533], [104.083, 86.739], [46.671, 85.975],
        [103.853, 82.1], [191.102, 85.937], [81.017, 81.975], [109.847, 85.264],
        [28.398, 83.569], [191.857, 86.809], [122.151, 82.693], [191.326, 88.756],
        [187.964, 87.677], [90.366, 81.837], [190.25, 85.286], [90.834, 82.475],
        [180.271, 83.624], [179.828, 82.83], [66.699, 85.155], [68.346, 89.707],
        [57.03, 83.996], [127.743, 82.778], [230.024, 83.366], [121.278, 83.443],
        [98.17, 82.007], [191.449, 85.99], [63.545, 86.415], [108.52, 87.829],
        [190.451, 85.843], [121.037, 82.601], [28.057, 85.615], [190.199, 86.736],
        [192.278, 87.737], [92.382, 81.925], [192.979, 86.444], [90.806, 82.691],
        [182.101, 86.174], [182.152, 86.43], [65.273, 86.129], [69.662, 92.79],
        [112.206, 84.601], [49.598, 86.276], [125.827, 82.977], [225.681, 89.616],
        [102.451, 82.742], [190.685, 86.266], [67.532, 86.615], [108.407, 85.868],
        [188.599, 83.383], [119.551, 82.333], [30.714, 83.255], [188.457, 83.958],
        [93.666, 82.093], [192.25, 87.378], [193.776, 86.695], [93.8, 82.203]],
    crop_mean_xy=[
        [67.65, 87.549], [181.072, 82.54], [181.18, 84.315], [68.403, 92.206],
        [86.51, 93.683], [114.764, 82.819], [230.006, 86.596], [49.833, 88.914],
        [191.602, 83.668], [70.75, 85.245], [90.429, 84.704], [110.291, 85.29],
        [26.666, 83.751], [122.94, 82.518], [185.05, 90.492], [189.802, 84.15],
        [87.65, 81.41], [195.54, 88.889], [200.531, 86.481], [87.555, 86.671],
        [183.067, 82.979], [183.375, 87.814], [66.711, 87.419], [65.799, 89.949],
        [229.058, 87.051], [115.188, 82.98], [90.084, 93.875], [52.439, 87.487],
        [91.568, 84.214], [190.296, 84.088], [72.947, 85.446], [110.396, 84.37],
        [26.802, 83.207], [190.735, 82.288], [122.063, 82.357], [186.811, 91.067],
        [197.708, 89.943], [88.902, 81.588], [198.15, 86.711], [87.984, 84.569],
        [183.642, 85.574], [183.785, 82.551], [66.113, 87.34], [64.841, 90.435],
        [48.009, 83.454], [117.061, 82.9], [227.75, 86.355], [94.22, 93.053],
        [93.767, 83.328], [191.161, 85.907], [66.336, 85.18], [108.062, 86.854],
        [187.848, 86.093], [120.517, 82.235], [29.127, 83.923], [186.067, 91.225],
        [198.552, 90.129], [89.615, 81.929], [199.679, 87.303], [88.593, 87.664],
        [184.949, 82.981], [183.191, 84.528], [66.074, 85.935], [63.661, 88.834],
        [99.713, 94.316], [51.695, 83.931], [113.722, 82.694], [227.107, 86.345],
        [95.723, 82.333], [190.641, 85.566], [65.396, 85.383], [106.62, 89.401],
        [188.772, 83.228], [119.266, 81.914], [27.887, 85.116], [187.248, 88.163],
        [90.392, 81.278], [198.462, 89.138], [198.498, 87.731], [90.866, 86.731]])


# the training phases.  train_parity: the shipped PoseNet (its config is
# scripts/train_posenet.py:37-47, 192 x 256, stages (64, 128, 256), head
# 128, center and offsets) from its checkpoint's weights, TRAIN_PARITY_STEPS
# steps of detect_train.make_train_step with adamw(TRAIN_PARITY_LR) on the
# 8 samples generate_samples makes of TRAIN_PARITY_SAMPLES, in f32 and
# bf16 compute; TRAIN_REFERENCE: the JAX package's losses for the same
# steps (scripts/torch_parity_study.py --study train, "train_reference")
TRAIN_PARITY_SAMPLES = dict(seeds=[7], n_frames=2, n_views=4)
TRAIN_PARITY_STEPS = 5
TRAIN_PARITY_LR = 1e-4
TRAIN_REFERENCE = dict(
    float32=[0.007536318618804216, 0.005689698737114668, 0.004932283423841,
             0.0040243566036224365, 0.003667108016088605],
    bfloat16=[0.007532638963311911, 0.005735591985285282, 0.004957742523401976,
              0.004071131814271212, 0.003667075652629137])
# train: a fresh PoseNet (init_posenet, generator seeded 0) in bf16 for
# TRAIN_STEPS steps of batch TRAIN_BATCH with scripts/train_posenet.py's
# warmup-cosine AdamW at TRAIN_LR, on the samples of TRAIN_SEEDS (the
# script's sample layout: 6 frames x 4 views a seed)
TRAIN_SEEDS = [0, 1, 2, 3]
TRAIN_BATCH = 16
TRAIN_STEPS = 400
TRAIN_LR = 1e-3
TRAIN_PROFILE_STEPS = 10
# appearance_train: scripts/train_appearance.py's settings on fewer scenes
# (its 16 train scenes render for ~30 s), held out at seed + 100_003;
# APPEARANCE_TRAIN_REFERENCE: the JAX package's gaps for the same seeds and
# sizes (--study train, "appearance_train_reference"); the gates of
# tests/test_appearance.py:407-408
APPEARANCE_TRAIN = dict(seed=0, n_scenes=4, val_scenes=2, n_frames=6, iters=400, lr=1e-3,
                        weight_decay=1e-4, tau=0.1)
APPEARANCE_TRAIN_REFERENCE = dict(raw_gap=0.0366595983505249, gap=0.6452810764312744,
                                  best_iter=100)
APPEARANCE_GAP_MIN = 0.35
APPEARANCE_GAP_OVER_RAW = 0.2
# the head's initial weights alone move the best gap on these descriptors
# by 0.039 in JAX (0.631-0.670 over PRNGKey 0-4) and 0.047 in the port
# (0.634-0.681 over generator seeds 0-4; --study train)
APPEARANCE_GAP_TOL = 0.05
# card against the port's CPU run and against TRAIN_REFERENCE.  The
# shipped weights fit these samples: the loss is a small residual of heat
# values near 1, so the forward's f32 rounding shows amplified (the port's
# CPU run against JAX's, --study train: losses 2.1e-5 to 6.6e-5 relative,
# gradients within 0.0077 of each leaf's largest magnitude, cosines >=
# 0.999998; in bf16 losses 6.1e-4 to 6.6e-3 relative)
TRAIN_F32_LOSS_RTOL = 2e-4
TRAIN_F32_GRAD_TOL = 0.05
TRAIN_F32_GRAD_COS = 0.9999
TRAIN_BF16_LOSS_RTOL = 2e-2
# measured by this phase on an NVIDIA H100 80GB HBM3 (700 W): last-10 mean
# 0.158 against the first 10's 1.600, a ratio of 0.099
TRAIN_LOSS_GATE = 0.2


# the CLI (`python -m multiview_motion_capture_torch`) on the default
# preset's scene written out as calibration and OpenPose files, cut to
# CLI_FRAMES frames: `prepare`, then `run --bvh --reid --crossings
# --debug_dump` on the card (N = 66, rank 32); each exported BVH replayed
# by `fk_generic.animate_bvh` within BVH_MEAN_ERR_M of its tracklet's
# poses, the JAX package's own bound (tests/test_bvh.py:66-67: the file
# holds one static skeleton, the mean of the tracklet's bone lengths)
CLI_FRAMES = 40
BVH_MEAN_ERR_M = 0.02
# `detect` under the CLI (its image reading aside) on the detect scene's
# first DETECT_CLI_FRAMES rendered frames, with --appearance --crossings
DETECT_CLI_FRAMES = 10
# the association dump on the clustered rig of tests/test_debug_dump.py:76
# (8 views in 2 clusters, 2 people, seed 3), card against CPU: groups and
# x_bin on the solved elements (live tracks, valid detections) equal, sims
# within DEBUG_SIM_TOL, X on the solved elements within DEBUG_X_TOL (the
# bound tests/test_torch_debug.py holds the port's X to against JAX's).
# The replay's f64 math rounds its last bits on each device its own way,
# and a value on an f32 rounding boundary then rounds two ways (ROADMAP
# queue C), so a state field may differ by an ulp from some frame on
# (the phase prints the first) and a similarity with it; the clusters' ALS
# runs to its 100-iteration cap, where that moves X, and on the padded
# slots (zero rows no decision reads) flips x_bin too.
DEBUG_CLUSTERED_FRAMES = [0, 3, 6, 9]
DEBUG_SIM_TOL = 1e-6
DEBUG_X_TOL = 0.1

# Depths cut to make room for the benchmark programs' phases within the
# run's time limit (each check unchanged, on fewer frames): parity 60 -> 30
# frames, default_parity and appearance_parity 20 -> 10, wide_parity and
# wide_profile 10 -> 3, profile 30 -> 10, default_profile 10 -> 5, stream
# 60 -> 30, streams 30 -> 15 frames a stream, cli 60 -> 40, mesh_cameras
# 60 -> 30, the slice's host-sync count 300 -> SYNC_FRAMES; scaled's card
# against CPU check takes 2 frames, not 3 (the CPU's step at 128 views
# takes seconds a frame).  Cut again when the last run programs' phases
# came in (a full run took 1,066 s on a slow host): scaled's rigs 30 / 20
# / 20 -> 20 / 12 / 12 frames, stream_curve 96 -> 64 frames a k.  Cut
# again when the research studies' phase came in (a full run took 1,037 s
# on a slow host): scaled's rigs -> 12 / 8 / 8 frames, stream_curve -> 32
# frames a k, profile_bench 60 -> 30 frames, the studies' bisect 30 -> 20.
#
# the benchmark programs.  bench: the package's `bench` mode (bench.py's
# counterpart) on the slice's scene written as files in the Shelf dataset's
# layout (`kps_opn/`, `calibs/`), all SCENE frames; its tracklets bit-equal
# to the slice's.  scaled: scripts/torch_bench_scaled.py's bench_config on
# three of its rigs, each cut to SCALED_FRAMES frames, and the first
# SCALED_PARITY_FRAMES frames of each in IK mode card against CPU.
# stream_curve: scripts/torch_bench_streaming.py's curve on the scene files,
# cut to STREAM_CURVE_FRAMES frames per k
SCALED_FRAMES = {"10cam_x_10ppl": 12, "128cam_x_10ppl_4clusters": 8,
                 "128cam_x_10ppl_5clusters_nondiv": 8}
SCALED_PARITY_FRAMES = 2
# the 128-camera, 4-cluster rig's full-IK launches, device busy time and
# idle share a frame: a device-only profile over its first frames
SCALED_PROFILE = ("128cam_x_10ppl_4clusters", 3)
STREAM_CURVE_FRAMES = 32

# the repository's last run programs.  The config-5 examples at the JAX
# suite's own sizes, gated as its tests gate the JAX examples
# (tests/test_e2e_cnn.py:13-17, tests/test_detect_cascade.py:109-114);
# scripts/torch_bench_detect.py's line at BENCH_DETECT_FRAMES frames (its
# 100 cut for the run's time), and the host syncs of a staged detection
# loop over BENCH_DETECT_SYNC_FRAMES frames; scripts/torch_profile_bench.py
# on the `bench` phase's Shelf-layout files, cut to PROFILE_BENCH_FRAMES
# frames (its 300 cut for the run's time)
E2E_SYNTHETIC = dict(steps=150, n_frames=8, n_people=2, n_views=4, seed=0)
E2E_SYNTHETIC_GATES = dict(det_err_px=12.0, n_long=2, mpjpe_m=0.08)
E2E_FULLFRAME = dict(steps=250, n_frames=8, n_people=2, n_views=4, seed=0)
E2E_FULLFRAME_GATES = dict(recall=0.4, det_err_px=9.0, n_long=2, mpjpe_m=0.2)
BENCH_DETECT_FRAMES = 10
BENCH_DETECT_SYNC_FRAMES = 5
PROFILE_BENCH_FRAMES = 30
# the keys of scripts/bench_detect.py's line (lines 166-188)
BENCH_DETECT_EXTRA_KEYS = {
    "bottom_up_fps_staged", "bottom_up_fps_incl_upload", "bottom_up_fps_upload_overlap",
    "cascade_fps_staged", "cascade_fps_incl_upload", "cascade_e2e_fps", "track_fps",
    "n_frames", "n_views", "frame_hw", "crop_hw", "cascade_model_input",
    "bottom_up_model_input", "bottom_up_ckpt", "backend"}

# the eight research studies' ports (scripts/torch_*study*.py,
# torch_bench_quality_bisect.py, torch_detector_style_holdout.py) at cut
# sizes (their own: 300 frames, 30 on the 64-camera rig, nine identity
# rigs of 60-200 frames, 60, 8 frames and 3 seeds); bisect, fragmentation
# and oracle parity read the `bench` phase's Shelf-layout files, the last
# two sharing one oracle run (host work, ~1 s a frame).  Each study's JSON
# is held to the keys of its JAX script (STUDY_KEYS, with the lines that
# build them there) and each kernel the study puts on a path must launch.
# bisect 60 -> 30 frames after a first card run of the phase took 118 s
# (39 s of it bisect's 4 variants x 2 passes), then -> 20 with the cuts
# above
STUDY_CUTS = dict(bisect_frames=20, ik_frames=10, oracle_frames=20,
                  identity=("10cam_x_10ppl_f200",
                            "10cam_x_10ppl_f200_appearance_extractorgrade_crossings"),
                  identity_frames=30, appearance_frames=15, crowd_frames=2,
                  style_seeds=[3000])
STUDY_KEYS = {
    # scripts/bench_quality_bisect.py:40-59
    "bisect": {"current_r4", "cold_stages_2", "cold2_rescue_off", "rescue_off"},
    "bisect_row": {"fps", "mean_px", "median_px", "n_tracklets", "top_lengths"},
    # scripts/ik_iteration_study.py:75-122
    "ik_iteration": {"rig", "warm_default(stages1,ftol2e-6,b5)", "warm_loose(ftol1e-4)",
                     "warm_budget3", "warm_stages2(parity)"},
    "ik_iteration_row": {"frames", "mean", "p50", "max", "budget_hit_frac"},
    # scripts/fragmentation_study.py:196-204
    "fragmentation": {"tracker_tracklets", "oracle_tracklets", "tracker_deaths",
                      "excess_deaths", "excess_f64_would_keep", "excess_margin_lt_0.1",
                      "detail"},
    # scripts/parity_study.py:117-149
    "oracle_parity": {"n_frames", "tpu", "oracle", "matched_pairs", "matched_oracle_frames",
                      "mpjpe_cm", "frame131_zoom", "tpu_events_120_145",
                      "oracle_events_120_145", "active_count_agreement"},
    # scripts/identity_study.py:79-113
    "identity_row": {"raw", "reid", "reid+ghost_filter"},
    "identity_crossings_row": {"crossings_resolved", "crossing_events", "crossing_swaps"},
    # scripts/appearance_e2e_study.py:150-182
    "appearance_e2e": {"extractor", "extractor_cos_same", "extractor_cos_diff",
                       "geometry_only", "appearance_gain60", "appearance_gain20_default",
                       "appearance_auto_target8", "appearance_crossings",
                       "appearance_gain40", "appearance_crossings_gain40",
                       "appearance_crossings_gain60", "appearance_crossings_auto20"},
    "appearance_e2e_row": {"raw_tracks", "raw_idf1", "raw_idsw", "reid_idf1", "reid_idsw"},
    # scripts/crowd_detect_study.py:173-216
    "crowd_detect": {"p4_d1.2", "p6_d0.8", "p8_d0.5", "p10_d0.3"},
    "crowd_detect_row": {"recall", "recall_detectable", "frac_detectable", "precision",
                         "err_px", "center_recall", "oracle_center_recall",
                         "oracle_center_err_px", "centers"},
    # scripts/detector_style_holdout.py:75-104
    "style_holdout": {"styles", "calibration", "best_threshold"},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cuda_time_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_events(fn, reps: int = 20, attempts: int = 3) -> list:
    """The CUDA kernels that `reps` calls of `fn` launch, by torch.profiler,
    after a warm call.  A window in which the profiler reports no kernel is
    traced again, up to `attempts` windows in all (a machine's first window
    has come back empty)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if kernels:
            return kernels
    raise RuntimeError(f"the profiler saw no kernel on the card in {attempts} windows")


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time per call of `fn`: the summed durations of the CUDA
    kernels it launches.  Unlike CUDA events around back-to-back calls, it
    leaves out the host's dispatch between the kernels."""
    return sum(e.time_range.elapsed_us() for e in kernel_events(fn, reps)) / 1e3 / reps


def host_time_ms(fn, rounds: int = 3, warm: bool = True) -> float:
    """Median wall time of `fn` (which synchronizes on the host itself),
    after a warm call unless the caller has just made one."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def als_problem(seed: int, sizes, n_people: int):
    """A seeded multi-view matching problem with known identities (the
    generator of the JAX package's ALS tests): cross-group similarity 0.85
    for the same person, 0.08 otherwise, each +-0.06 noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    groups = []
    for s in sizes:
        groups.extend(rng.permutation(n_people)[:s].tolist())
    n = len(groups)
    cam_of = np.concatenate([[c] * s for c, s in enumerate(sizes)])
    W = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for j in range(n):
            if i == j or cam_of[i] == cam_of[j]:
                continue
            base = 0.85 if groups[i] == groups[j] else 0.08
            W[i, j] = np.clip(base + rng.uniform(-0.06, 0.06), 0, 1)
    return 0.5 * (W + W.T)


# Operation counts for the bounds: the least work of the function each
# kernel computes, not the work of the kernel's algorithm.  A symmetric
# product F F^T counts its r (r + 1) / 2 distinct entries, and a solve of an
# SPD system of side d with m right-hand sides counts a Cholesky factor
# (d^3 / 3) and two triangular solves per right-hand side (2 d^2 m), where
# the kernels run a no-pivot Gauss-Jordan (about 2 d^2 (d + m)).

def spd_solve_ops(d: int, m: int) -> float:
    return d ** 3 / 3 + 2 * d * d * m


def als_ops(n: int, r: int, iters: int) -> float:
    """f32 operations of the ALS solve at (n, rank) over `iters` iterations:
    the X step (4 per entry), the two ridge solves (the symmetric Gram
    matrix, the r x n right-hand side F X, the SPD solve with n right-hand
    sides), the A B^T product and the projection/residual pass (15 per
    entry); then the symmetrization and the binarization."""
    ridge = r * (r + 1) * n + 2 * r * n * n + spd_solve_ops(r, n)
    per_iter = 4 * n * n + 2 * ridge + 2 * n * n * r + 15 * n * n
    return float(iters * per_iter + 4 * n * n)


def gj_ops(T: int, D: int) -> float:
    """T SPD solves of side D with one right-hand side."""
    return float(T * spd_solve_ops(D, 1))


def fused_ops(T: int, R: int, D: int) -> float:
    """Per slot: the D (D + 1) / 2 distinct entries of the symmetric J^T J
    and the D entries of J^T r, each R products and R sums; the trace, the
    ridge and the diagonal shift; then the SPD solve."""
    return float(T * (2 * R * (D * (D + 1) // 2 + D) + 3 * D)) + gj_ops(T, D)


def run_phase(name: str, fn, *args):
    """Run one phase and print its wall seconds on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit({"phase": name, "wall_s": time.perf_counter() - t0})
    return out


def zero_launch_counts() -> None:
    from multiview_motion_capture_torch.ops import cuda_lib

    for k in cuda_lib.ALL_KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    from multiview_motion_capture_torch.ops import cuda_lib

    return {k.name: k.launches for k in cuda_lib.ALL_KERNELS}


def phase_env(torch):
    from multiview_motion_capture_torch.utils.precision import high_precision, precision_flags

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    high_precision()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "python": sys.version.split()[0], **precision_flags()})
    return smi.splitlines()[0]


def phase_build():
    from multiview_motion_capture_torch.ops import cuda_lib

    t0 = time.perf_counter()
    seconds = cuda_lib.build_all()
    ptxas = {lib.name: [ln for ln in lib.build_log.splitlines()
                        if "registers" in ln or "spill" in ln]
             for lib in cuda_lib.ALL_LIBRARIES}
    emit({"phase": "build", "seconds": seconds,
          "wall_s": time.perf_counter() - t0, "ptxas": ptxas})


def check_als(torch, name, W, mask, init, max_iter, stable_iters, plain_rounds=3):
    """The ALS kernel against its plain version on the same inputs: both run
    the same f32 operations in the same order, so x_bin and the iteration
    count must be equal.  With its X output (`return_x=True`, the TPU
    kernel's continuous X) the kernel's X must equal the plain version's
    bit for bit, and x_bin and the iteration count must be those of the
    launch without it."""
    import numpy as np

    from multiview_motion_capture_torch.ops import als_kernel, association

    n, rank = init.shape
    kw = dict(alpha=50.0, beta=0.1, mu0=64.0, tol=1e-4, max_iter=max_iter,
              stable_iters=stable_iters)
    k = als_kernel.match_als(W, mask, init, **kw)
    kx = als_kernel.match_als(W, mask, init, return_x=True, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = association.match_als(W, mask, init, **kw)
    torch.cuda.synchronize()
    plain_once_ms = (time.perf_counter() - t0) * 1e3
    xk, xp = k.x_bin.cpu().numpy(), p.x_bin.cpu().numpy()
    ik, ip = int(k.n_iters), int(p.n_iters)
    res = {"case": name, "n": n, "rank": rank, "iters_kernel": ik, "iters_plain": ip,
           "x_bin_mismatches": int((xk != xp).sum()),
           "max_abs_err": float(np.abs(xk.astype(np.float32) - xp.astype(np.float32)).max()),
           "x_bit_equal": torch.equal(kx.x, p.x),
           "x_max_abs_err": float((kx.x - p.x).abs().max()),
           "return_x_same_x_bin_and_iters": (torch.equal(kx.x_bin, k.x_bin)
                                             and int(kx.n_iters) == ik)}
    res["ms"] = cuda_time_ms(lambda: als_kernel.match_als(W, mask, init, **kw), reps=20)
    res["ms_with_x"] = cuda_time_ms(
        lambda: als_kernel.match_als(W, mask, init, return_x=True, **kw), reps=20)
    res.update(als_launch_fields(n, rank, 1, res["ms"], ik))
    # one round: the time of the call compared above (a plain call at N =
    # 66 takes ~1.5 s)
    res["plain_ms"] = plain_once_ms if plain_rounds == 1 else host_time_ms(
        lambda: association.match_als(W, mask, init, **kw), rounds=plain_rounds, warm=False)
    # W f32 and the mask bytes read, init_A read, x_bin bytes and iters written
    n_bytes = n * n * 4 + n * n + n * rank * 4 + n * n + 4
    res["bound_ms"], res["bound_by"] = bound_ms(n_bytes, als_ops(n, rank, ik))
    res["ok"] = (res["x_bin_mismatches"] == 0 and ik == ip and res["x_bit_equal"]
                 and res["return_x_same_x_bin_and_iters"])
    return res


def als_launch_fields(n: int, rank: int, C: int, ms: float, iters: int) -> dict:
    """How the ALS kernel launched C problems of (n, rank): blocks per
    cluster, SMs used, threads, shared memory, and the time per iteration
    of the longest problem."""
    from multiview_motion_capture_torch.ops import als_kernel

    shape = als_kernel.launch_shape(n, rank)
    return {"cluster": shape.cluster, "sms_used": C * shape.cluster,
            "threads": shape.threads, "smem_bytes": shape.smem_bytes,
            "max_active_clusters": shape.max_active_clusters,
            "ms_per_iter": ms / max(iters, 1)}


def als_seeded_case(torch, dev, name, seed, sizes, n_people, rank, max_iter=100,
                    stable_iters=10, plain_rounds=3):
    from multiview_motion_capture_torch.ops import association

    W = torch.as_tensor(als_problem(seed, sizes, n_people), device=dev)
    mask = torch.as_tensor(association.block_diag_mask(sizes), device=dev)
    init = torch.as_tensor(association.default_init_factor(W.shape[0], rank), device=dev)
    return check_als(torch, name, W, mask, init, max_iter=max_iter, stable_iters=stable_iters,
                     plain_rounds=plain_rounds)


def als_frame0_case(torch, dev, seq, cfg, name="frame0", plain_rounds=3, app=None):
    """The main path's own first ALS problem: the spatial-only similarity of
    the scene's first frame (no live track yet; with `app`, the scene's
    embeddings, its appearance term at the gain of a fresh state), whose
    ALS does not settle within the iteration cap on SHELF_BENCH, so its
    result depends on every rounding."""
    from multiview_motion_capture_torch import tracker
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses

    b = filter_bad_poses(seq.batch, cfg)
    ctx = tracker.TrackerContext.build(seq.cameras, cfg, device=dev)
    kw = {}
    if app is not None:
        kw = dict(app=torch.as_tensor(app[0], device=dev), app_gain=tracker._appearance_gain(
            cfg, tracker.TrackerState.zeros(cfg, device=dev)))
    W, _ = tracker._spatial_similarity(ctx, torch.as_tensor(b.kps[0], device=dev),
                                       torch.as_tensor(b.valid[0], device=dev), **kw)
    return check_als(torch, name, W.contiguous(), ctx.diag_mask, ctx.init_A,
                     max_iter=cfg.als_max_iter, stable_iters=cfg.als_stable_iters,
                     plain_rounds=plain_rounds)


def spd_systems(torch, dev, T: int, D: int, seed: int):
    """T seeded damped SPD systems of side D: A = M M^T / (2D) + 1e-3 I with
    M (D, 2D) standard normal, and g, both f32 from torch's CPU generator."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    M = torch.randn(T, D, 2 * D, generator=g)
    A = (M @ M.transpose(1, 2) / (2 * D) + 1e-3 * torch.eye(D)).to(dev).contiguous()
    b = torch.randn(T, D, generator=g).to(dev)
    return A, b


def lm_inputs(torch, dev, T: int, R: int, D: int, seed: int, free=None):
    """One LM iteration's seeded inputs of the fused solve, from numpy:
    J (T, R, D) standard normal with the columns where `free` (D,) is 0
    zeroed (default: a seeded draw that keeps 4 in 5), r (T, R), lam (T,) in
    [1e-3, 1); frozen = 1 - free and Jaug = [J | r] (T, R, D + 1).  Returns
    (J, r, lam, frozen, Jaug)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    if free is None:
        free = (rng.rand(D) > 0.2).astype(np.float32)
    free = torch.as_tensor(free, dtype=torch.float32, device=dev)
    J = torch.as_tensor(rng.randn(T, R, D).astype(np.float32), device=dev) * free
    r = torch.as_tensor(rng.randn(T, R).astype(np.float32), device=dev)
    lam = torch.as_tensor(rng.uniform(1e-3, 1.0, T).astype(np.float32), device=dev)
    frozen = (1.0 - free).contiguous()
    Jaug = torch.cat([J, r[:, :, None]], dim=2).contiguous()
    return J, r, lam, frozen, Jaug


def gj_route_systems(torch, J, r, lam, frozen, eye):
    """The "gj" LM route's systems for B2 from lm_inputs: J^T J + (lam +
    ridge) I + diag(frozen) and J^T r, by two einsums (eye: the D x D
    identity on the card)."""
    D = J.shape[2]
    JtJ = torch.einsum("trd,tre->tde", J, J)
    g = torch.einsum("trd,tr->td", J, r)
    ridge = 1e-6 * (torch.diagonal(JtJ, dim1=1, dim2=2).sum(-1) / D) + 1e-6
    A = JtJ + (lam + ridge)[:, None, None] * eye + torch.diag(frozen)[None]
    return A.contiguous(), g.contiguous()


def check_gj(torch, dev, T, D, seed, one_program=True):
    from multiview_motion_capture_torch.ops import solve_kernel

    A, b = spd_systems(torch, dev, T, D, seed)
    xk = solve_kernel.batched_spd_solve(A, b, one_program=one_program)
    xp = solve_kernel.gauss_jordan_plain(A, b)
    torch.cuda.synchronize()
    err = float((xk - xp).abs().max())
    res = {"T": T, "D": D, "one_program": one_program, "max_abs_err": err,
           "bit_equal": torch.equal(xk, xp), "rel_err": err / float(xp.abs().max())}
    res.update(solve_kernel.gj_launch_shape(D)._asdict())

    def kernel():
        return solve_kernel.batched_spd_solve(A, b, one_program=one_program)

    def plain():
        return solve_kernel.gauss_jordan_plain(A, b)

    def library():
        return torch.linalg.solve(A, b)

    # *ms: CUDA events around back-to-back calls; *device_ms: the same
    # calls' kernel durations by the profiler
    res["ms"] = cuda_time_ms(kernel, reps=50)
    res["device_ms"] = device_ms(kernel, reps=50)
    res["us_per_pivot_on_device"] = res["device_ms"] * 1e3 / D
    res["plain_ms"] = cuda_time_ms(plain, reps=5)
    res["plain_device_ms"] = device_ms(plain, reps=3)
    res["library_ms"] = cuda_time_ms(library, reps=50)
    res["library_device_ms"] = device_ms(library, reps=50)
    n_bytes = T * (D * D + D) * 4 + T * D * 4
    res["bound_ms"], res["bound_by"] = bound_ms(n_bytes, gj_ops(T, D))
    res["ok"] = res["bit_equal"]
    return res


def check_als_batched(torch, name, W, mask, init, max_iter, stable_iters, timing_reps=3):
    """The batched ALS kernel (B3) against its plain version (the plain solve
    of each problem) and against one single-problem kernel launch (B1) per
    problem: x_bin and every problem's iteration count must be equal."""
    import numpy as np

    from multiview_motion_capture_torch.ops import als_kernel, association

    C, n, _ = W.shape
    rank = init.shape[1]
    kw = dict(alpha=50.0, beta=0.1, mu0=64.0, tol=1e-4, max_iter=max_iter,
              stable_iters=stable_iters)

    def plain():
        return [association.match_als(W[c], mask, init, **kw) for c in range(C)]

    def solos():
        return [als_kernel.match_als(W[c], mask, init, **kw) for c in range(C)]

    k = als_kernel.match_als_batched(W, mask, init, **kw)
    kx = als_kernel.match_als_batched(W, mask, init, return_x=True, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    s1 = solos()
    torch.cuda.synchronize()
    xk = k.x_bin.cpu().numpy()
    xp = np.stack([r.x_bin.cpu().numpy() for r in p])
    xs = np.stack([r.x_bin.cpu().numpy() for r in s1])
    ik = k.n_iters.cpu().tolist()
    ip = [int(r.n_iters) for r in p]
    i1 = [int(r.n_iters) for r in s1]
    x_plain = torch.stack([r.x for r in p])
    res = {"case": name, "C": C, "n": n, "rank": rank, "iters_kernel": ik,
           "iters_plain": ip, "iters_solo_b1": i1,
           "x_bin_mismatches_plain": int((xk != xp).sum()),
           "x_bin_mismatches_solo_b1": int((xk != xs).sum()),
           "max_abs_err": float(np.abs(xk.astype(np.float32) - xp.astype(np.float32)).max()),
           "x_bit_equal": torch.equal(kx.x, x_plain),
           "x_max_abs_err": float((kx.x - x_plain).abs().max()),
           "return_x_same_x_bin_and_iters": (torch.equal(kx.x_bin, k.x_bin)
                                             and kx.n_iters.cpu().tolist() == ik)}
    res["ms"] = cuda_time_ms(lambda: als_kernel.match_als_batched(W, mask, init, **kw),
                             reps=timing_reps, rounds=3)
    res["ms_with_x"] = cuda_time_ms(
        lambda: als_kernel.match_als_batched(W, mask, init, return_x=True, **kw),
        reps=timing_reps, rounds=3)
    res.update(als_launch_fields(n, rank, C, res["ms"], max(ik)))
    # the plain solves compared above, timed once (7 s at C 4, N 336)
    res["plain_ms"] = plain_ms
    # yardstick: the C problems as C sequential single-problem launches
    res["yardstick"] = "C sequential B1 launches"
    res["yardstick_ms"] = cuda_time_ms(solos, reps=timing_reps, rounds=3)
    # each W and x_bin once, the shared mask and init once, the iterations
    n_bytes = C * (n * n * 4 + n * n + 4) + n * n + n * rank * 4
    res["bound_ms"], res["bound_by"] = bound_ms(n_bytes, sum(als_ops(n, rank, i) for i in ik))
    res["ok"] = (res["x_bin_mismatches_plain"] == 0 and res["x_bin_mismatches_solo_b1"] == 0
                 and ik == ip == i1 and res["x_bit_equal"]
                 and res["return_x_same_x_bin_and_iters"])
    return res


def wide_cluster_problems(torch, dev, n_views, clusters, seed):
    """The per-cluster ALS problems of a wide rig's first frame: the
    spatial-only similarity of each interleaved cluster (no live track
    yet), as the wide path builds them."""
    from multiview_motion_capture_torch import tracker
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    cfg = PipelineConfig.wide(n_views, assoc_clusters=clusters, max_frames=None)
    # frame 0 only: a sequence draws its frames in order, so its first frame
    # is the same at any length
    scene = dict(WIDE_SCENE, n_views=n_views, seed=seed, n_frames=1)
    seq = synthetic_sequence(cfg=cfg, **scene)
    b = filter_bad_poses(seq.batch, cfg)
    ctx = tracker.TrackerContext.build(seq.cameras, cfg, device=dev)
    kps = torch.as_tensor(b.kps[0], device=dev)
    valid = torch.as_tensor(b.valid[0], device=dev)
    W = torch.stack([tracker._spatial_similarity(ctx, kps, valid, view_idx=cl.views,
                                                 view_valid=cl.view_valid)[0]
                     for cl in ctx.clusters]).contiguous()
    return W, ctx.cluster_diag_mask, ctx.cluster_init_A, cfg


def check_fused(torch, dev, T, R, D, seed):
    """The fused normal-equation kernel (B4) against its plain version on
    one LM iteration's shapes (pose-only stage: the side-length columns
    frozen), and the gj route on the same systems as its yardstick."""
    from multiview_motion_capture_torch.ops import ik, solve_kernel

    J, r, lam, frozen, Jaug = lm_inputs(torch, dev, T, R, D, seed, free=ik._FREE_POSE)
    xk = solve_kernel.fused_normal_solve(Jaug, lam, frozen)
    xp = solve_kernel.fused_normal_plain(Jaug, lam, frozen)
    torch.cuda.synchronize()
    err = float((xk - xp).abs().max())
    eye = torch.eye(D, device=dev)

    def gj_route():
        return solve_kernel.batched_spd_solve(*gj_route_systems(torch, J, r, lam, frozen, eye))

    xg = gj_route()
    res = {"T": T, "R": R, "D": D, "max_abs_err": err, "bit_equal": torch.equal(xk, xp),
           "rel_err": err / float(xp.abs().max()),
           "gj_route_rel_diff": float((xg - xk).abs().max() / xk.abs().max())}
    shape = solve_kernel.fused_launch_shape(D)
    res.update(shape._asdict(), sms_used=T * shape.cluster)

    def kernel():
        return solve_kernel.fused_normal_solve(Jaug, lam, frozen)

    def plain():
        return solve_kernel.fused_normal_plain(Jaug, lam, frozen)

    # *ms: CUDA events around back-to-back calls; *device_ms: the same
    # calls' kernel durations by the profiler
    res["ms"] = cuda_time_ms(kernel, reps=50)
    res["device_ms"] = device_ms(kernel, reps=50)
    res["plain_ms"] = cuda_time_ms(plain, reps=2, rounds=3)
    res["plain_device_ms"] = device_ms(plain, reps=2)
    res["yardstick"] = "gj route: two torch.einsum + the B2 kernel"
    res["yardstick_ms"] = cuda_time_ms(gj_route, reps=50)
    res["yardstick_device_ms"] = device_ms(gj_route, reps=50)
    n_bytes = T * R * (D + 1) * 4 + T * 4 + D * 4 + T * D * 4
    res["bound_ms"], res["bound_by"] = bound_ms(n_bytes, fused_ops(T, R, D))
    res["ok"] = res["bit_equal"]
    return res


def timed(fn, *args, **kwargs) -> dict:
    """A kernel check's result with its wall seconds (`case_wall_s`)."""
    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    res["case_wall_s"] = time.perf_counter() - t0
    return res


def examples_scene():
    """The config-5 examples' tracking configuration and the first frame of
    the synthetic example's scene (examples/torch_e2e_synthetic.py: a
    sequence's first frame is the same at any length)."""
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    n_views = E2E_SYNTHETIC["n_views"]
    cfg = PipelineConfig(n_views=n_views, max_people=4, max_tracks=6, max_frames=None)
    seq = synthetic_sequence(n_frames=1, n_people=E2E_SYNTHETIC["n_people"], n_views=n_views,
                             cfg=cfg, noise_px=0.0, drop_prob=0.0, seed=E2E_SYNTHETIC["seed"])
    return cfg, seq


def phase_kernels(torch, dev, seq, cfg, dseq, dcfg, aseq, acfg, app):
    from multiview_motion_capture_torch.config import PipelineConfig

    detect_cfg = PipelineConfig(**DETECT_CFG)
    ecfg, eseq = examples_scene()
    # B1's plain version is timed in three rounds in the main row's case and
    # once elsewhere: one call takes up to ~1.6 s (N = 66)
    als = [
        # main path: SHELF_BENCH's [8 track slots | 5 views x 6 detections]
        timed(als_seeded_case, torch, dev, "seeded", 0, (8, 6, 6, 6, 6, 6), n_people=8,
              rank=16),
        timed(als_frame0_case, torch, dev, seq, cfg, plain_rounds=1),
        # 32 cameras x 10 people plus 16 track slots: N = 336
        timed(als_seeded_case, torch, dev, "rig32", 1, (16,) + (10,) * 32, n_people=16,
              rank=32, plain_rounds=1),
        # the default preset: [16 track slots | 5 views x 10 detections],
        # N = 66, rank 32, to its own iteration count under the 1,000 cap
        timed(als_frame0_case, torch, dev, dseq, dcfg, name="default_frame0", plain_rounds=1),
        timed(als_seeded_case, torch, dev, "default_seeded", 2, (16,) + (10,) * 5,
              n_people=16, rank=32, max_iter=dcfg.als_max_iter,
              stable_iters=dcfg.als_stable_iters, plain_rounds=1),
        # the appearance scene: [16 track slots | 10 views x 10 detections],
        # N = 116, rank 32, a cluster of 16 blocks, to its 100-iteration cap
        timed(als_frame0_case, torch, dev, aseq, acfg, name="appearance_frame0",
              plain_rounds=1, app=app),
        timed(als_seeded_case, torch, dev, "appearance_seeded", 3, (16,) + (10,) * 10,
              n_people=16, rank=32, max_iter=acfg.als_max_iter,
              stable_iters=acfg.als_stable_iters, plain_rounds=1),
        # the detect path: [12 track slots | 5 views x 8 detections], N = 52,
        # rank 24, cap 100
        timed(als_seeded_case, torch, dev, "detect_seeded", 4, (12,) + (8,) * 5,
              n_people=12, rank=detect_cfg.als_max_rank, max_iter=detect_cfg.als_max_iter,
              stable_iters=detect_cfg.als_stable_iters, plain_rounds=1),
        # the config-5 examples' tracking: [6 track slots | 4 views x 4
        # detections], N = 22, rank 12, cap 1,000; a seeded problem and the
        # first frame of the synthetic example's scene
        timed(als_seeded_case, torch, dev, "examples_seeded", 6, (6, 4, 4, 4, 4), n_people=6,
              rank=ecfg.als_max_rank, max_iter=ecfg.als_max_iter,
              stable_iters=ecfg.als_stable_iters, plain_rounds=1),
        timed(als_frame0_case, torch, dev, eseq, ecfg, name="examples_frame0", plain_rounds=1),
    ]
    # T = 8: SHELF_BENCH's slots; T = 16: the wide rig's; T = 64 off path;
    # T = 12: the detect path's
    gj = [timed(check_gj, torch, dev, T, 68, seed)
          for T, seed in ((8, 0), (16, 4), (64, 1), (12, 5))]
    als_batched = []
    # the wide rig (C 2, N 336) and the 128-camera rigs of
    # scripts/torch_bench_scaled.py (C 4, N 336; C 5, N 276 with dead pad views)
    for name, views, clusters in (("wide64_frame0", 64, 2), ("rig128_4clusters", 128, 4),
                                  ("rig128_5clusters", 128, 5)):
        t0 = time.perf_counter()
        W, mask, init, wcfg = wide_cluster_problems(torch, dev, views, clusters, seed=0)
        als_batched.append(check_als_batched(torch, name, W, mask, init,
                                             wcfg.als_max_iter, wcfg.als_stable_iters))
        als_batched[-1]["case_wall_s"] = time.perf_counter() - t0
    # the wide path's LM: 16 slots, 16 views x 32 residuals, 68 parameters
    fused = [timed(check_fused, torch, dev, 16, 16 * 32, 68, 2)]
    gj_grid = [timed(check_gj, torch, dev, 16, 68, 3, one_program=False)]
    from multiview_motion_capture_torch.ops import cuda_lib

    als_ptxas = [ln.strip() for ln in cuda_lib.ALS_LIB.build_log.splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln]
    emit({"phase": "kernels", "als": als, "gj_solve": gj, "als_batched": als_batched,
          "fused_normal_gj": fused, "gj_solve_grid": gj_grid, "als_ptxas": als_ptxas})
    # B1/B3 with their X output, case by case: X against the plain version's,
    # x_bin and iterations against the launch without X, the time of each
    emit({"phase": "als_x", "cases": [
        {k: r.get(k) for k in ("case", "C", "n", "rank", "iters_kernel", "x_bit_equal",
                               "x_max_abs_err", "return_x_same_x_bin_and_iters", "ms",
                               "ms_with_x", "cluster", "threads", "smem_bytes")}
        for r in als + als_batched], "als_ptxas": als_ptxas})
    if not all(r["ok"] for r in als + gj + als_batched + fused + gj_grid):
        raise AssertionError("a kernel disagrees with its plain version")
    return dict(als=als[0], als_default=als[3], als_appearance=als[5], als_detect=als[7],
                als_examples=als[8], als_examples_frame0=als[9],
                gj_solve=gj[0],
                als_batched=als_batched[0], als_batched_c4=als_batched[1],
                als_batched_c5=als_batched[2], fused_normal_gj=fused[0],
                gj_solve_grid=gj_grid[0])


@contextlib.contextmanager
def recording_run_offline():
    """Keep what `pipeline.run`'s passes of `run_offline` return (final
    state, per-frame outputs), so a phase reads the ALS iterations and the
    final state of the very run it timed, without a pass of its own."""
    from multiview_motion_capture_torch import pipeline

    run_offline, passes = pipeline.run_offline, []

    def recording(*args, **kwargs):
        passes.append(run_offline(*args, **kwargs))
        return passes[-1]

    pipeline.run_offline = recording
    try:
        yield passes
    finally:
        pipeline.run_offline = run_offline


# the warning CUDA's sync debug mode gives for each host sync; the mode's
# own first-use notice ("... a prototype feature and does not yet detect all
# synchronizing operations", once a process) is not one
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(fn):
    """Run `fn` with CUDA sync debugging on; returns (result, host syncs)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum(SYNC_WARNING in str(w.message) for w in caught)
    return out, n


def phase_slice(torch, dev, seq, cfg):
    import numpy as np

    from multiview_motion_capture_torch import eval as ev
    from multiview_motion_capture_torch import pipeline, tracker
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses

    zero_launch_counts()
    res = pipeline.run(seq.batch, seq.cameras, cfg, device=dev)
    launches = launch_counts()

    m = ev.reprojection_metrics(res.tracklets, seq.batch, seq.cameras)
    finite = all(np.isfinite(t.poses_3d).all() for t in res.tracklets)

    # host syncs of a steady-state pass over the sequence's first SYNC_FRAMES
    b = filter_bad_poses(seq.batch, cfg)
    ctx = tracker.TrackerContext.build(seq.cameras, cfg, device=dev)
    kps = torch.as_tensor(b.kps[:SYNC_FRAMES], device=dev)
    valid = torch.as_tensor(b.valid[:SYNC_FRAMES], device=dev)
    _, syncs = count_syncs(lambda: tracker.run_offline(ctx, kps, valid))

    quality = dict(n_tracklets=m.n_tracklets, top_lengths=m.lengths[:6],
                   mean_reproj_px=m.mean_reproj_px, median_reproj_px=m.median_reproj_px,
                   n_degenerate_poses=m.n_degenerate_poses)
    matches = (quality["n_tracklets"] == REFERENCE["n_tracklets"]
               and quality["top_lengths"] == REFERENCE["top_lengths"]
               and quality["n_degenerate_poses"] == REFERENCE["n_degenerate_poses"]
               and abs(m.mean_reproj_px - REFERENCE["mean_reproj_px"]) <= REPROJ_TOL_PX
               and abs(m.median_reproj_px - REFERENCE["median_reproj_px"]) <= REPROJ_TOL_PX)
    out = {"phase": "slice", "frames": res.n_frames, "fps": res.fps,
           "track_time_s": res.track_time_s, "timings": res.timings,
           "quality": quality, "reference": REFERENCE,
           "reproj_tol_px": REPROJ_TOL_PX, "matches_reference": matches,
           "reproj_gate_px": REPROJ_GATE_PX, "poses_finite": finite,
           "launches": launches, "host_syncs_per_frame": syncs / kps.shape[0]}
    emit(out)
    if not (finite and m.n_tracklets > 0 and launches["als"] > 0 and launches["gj_solve"] > 0):
        raise AssertionError("slice output or kernel launches missing")
    if (m.n_degenerate_poses != 0
            or abs(m.mean_reproj_px - REFERENCE["mean_reproj_px"]) > REPROJ_GATE_PX
            or abs(m.median_reproj_px - REFERENCE["median_reproj_px"]) > REPROJ_GATE_PX):
        raise AssertionError("slice quality is off the JAX reference")
    return launches, res


DECISIONS = ("track_id", "active", "updated", "spawned", "died_track_id", "matched_pose")


def phase_profile(torch, dev, seq, cfg, n_frames: int = 30, name: str = "profile",
                  n_top: int = 8, trace_host: bool = True):
    """Where a steady-state frame's time goes: torch.profiler over
    `n_frames` frames of the tracker (after one warm pass over them),
    tracing the host's operations and the device as every profile of a path
    since the first slice did, or with `trace_host=False` the device only
    (as the default preset's path was first profiled: its frames launch
    ~6,000-7,000 kernels, and tracing the host's operations beside them
    takes longer than the run it profiles).  The passes and the report are
    scripts/torch_profile_bench.py's (`profile_tracker`, without its
    unprofiled steady pass): device busy time is the sum of the CUDA
    kernels' own durations (one stream, so they do not overlap); the idle
    share is the rest of the profiled wall time.  The profiler's own
    overhead inflates the wall time, so the idle share is an upper bound,
    higher when the host is traced."""
    from multiview_motion_capture_torch import tracker
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses

    pb = script_module("torch_profile_bench")
    b = filter_bad_poses(seq.batch, cfg)
    ctx = tracker.TrackerContext.build(seq.cameras, cfg, device=dev)
    kps = torch.as_tensor(b.kps[:n_frames], device=dev)
    valid = torch.as_tensor(b.valid[:n_frames], device=dev)
    rep = pb.profile_tracker(ctx, kps, valid, n_frames, steady=False, trace_host=trace_host,
                             n_top=n_top)
    emit({"phase": name, "frames": n_frames, "host_traced": trace_host,
          "wall_ms_per_frame": rep["wall_ms_per_frame"],
          "device_busy_ms_per_frame": rep["device_busy_ms_per_frame"],
          "idle_share": rep["idle_share"],
          "kernel_launches_per_frame": rep["launches_per_frame"],
          "b_kernel_launches": rep["b_kernel_launches"],
          "top_kernels": [{"name": r["name"][:80], "ms_per_frame": r["ms"] / n_frames,
                           "launches_per_frame": r["count"] / n_frames}
                          for r in rep["rows"]]})


def phase_parity(torch, dev, seq, cfg, frames=PARITY_FRAMES, name="parity", app=None):
    """The first `frames` frames tracked on the card and on the CPU (the
    plain versions of the kernels): decisions must be equal, poses within
    POSE_TOL_M.  `app`: the scene's embeddings when appearance is on."""
    import numpy as np

    from multiview_motion_capture_torch import tracker
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses

    b = filter_bad_poses(seq.batch, cfg)
    kps, valid = b.kps[:frames], b.valid[:frames]
    outs = {}
    for d in (dev, "cpu"):
        ctx = tracker.TrackerContext.build(seq.cameras, cfg, device=d)
        _, o = tracker.run_offline(ctx, kps, valid, app=None if app is None else app[:frames])
        outs[d] = tracker.outputs_to_numpy(o)
    g, c = outs[dev], outs["cpu"]
    first_diff = {}
    for f in DECISIONS:
        bad = np.nonzero((getattr(g, f) != getattr(c, f)).reshape(frames, -1).any(1))[0]
        if len(bad):
            first_diff[f] = int(bad[0])
    upd = g.updated & c.updated
    joint_err = np.abs(g.pose3d - c.pose3d).max(-1)[upd]        # (n, 18)
    pose_err = float(joint_err.max()) if upd.any() else 0.0
    res = {"phase": name, "frames": frames,
           "decisions_equal": not first_diff, "first_diverging_frame": first_diff,
           "max_pose_err_m": pose_err, "pose_tol_m": POSE_TOL_M,
           "p99_joint_pose_err_m": float(np.percentile(joint_err, 99)) if upd.any() else 0.0,
           "als_iters_equal_frames": int((g.als_iters == c.als_iters).sum())}
    emit(res)
    if first_diff or pose_err > POSE_TOL_M:
        raise AssertionError("card and CPU runs disagree")


def run_quality(tracklets, seq, n_top=10):
    """Tracklets, top lengths, reprojection and degenerate poses of a run,
    and whether every pose is finite."""
    import numpy as np

    from multiview_motion_capture_torch import eval as ev

    m = ev.reprojection_metrics(tracklets, seq.batch, seq.cameras)
    q = dict(n_tracklets=m.n_tracklets, top_lengths=m.lengths[:n_top],
             mean_reproj_px=m.mean_reproj_px, median_reproj_px=m.median_reproj_px,
             n_degenerate_poses=m.n_degenerate_poses)
    finite = all(np.isfinite(t.poses_3d).all() for t in tracklets)
    return q, finite


def coco17(tracklets):
    """Triangulation-mode poses are COCO order plus the mid-spine;
    `reprojection_metrics` reads an 18-joint pose as BASIC_18, so they are
    measured on their 17 COCO joints (the JAX package's metric does the
    same)."""
    import numpy as np

    return [dataclasses.replace(t, poses_3d=np.asarray(t.poses_3d)[:, :17]) for t in tracklets]


def als_iteration_stats(iters, cap):
    import numpy as np

    iters = np.asarray(iters)
    return {"mean": float(iters.mean()), "median": float(np.median(iters)),
            "max": int(iters.max()), "frames_at_cap": int((iters >= cap).sum()),
            "frames": int(iters.size)}


def gate_quality(name, q, ref):
    """A path's quality against the JAX package's on the same scene: no
    degenerate pose, reprojection within REPROJ_GATE_PX (a different
    grouping on a frame whose ALS does not settle is reported, not
    gated)."""
    if (q["n_degenerate_poses"] != 0
            or abs(q["mean_reproj_px"] - ref["mean_reproj_px"]) > REPROJ_GATE_PX
            or abs(q["median_reproj_px"] - ref["median_reproj_px"]) > REPROJ_GATE_PX):
        raise AssertionError(f"{name} quality is off the JAX reference")


def phase_default(torch, dev, seq, cfg):
    """The JAX package's default preset end to end on the card (B1 at N = 66,
    the Cholesky LM: no LM kernel of the port launches), its quality
    against the JAX package's run, the timed pass's ALS iterations per
    frame and the host syncs of both passes."""
    from multiview_motion_capture_torch import pipeline, tracker

    zero_launch_counts()
    with recording_run_offline() as passes:
        res, syncs = count_syncs(lambda: pipeline.run(seq.batch, seq.cameras, cfg, device=dev))
    launches = launch_counts()
    q, finite = run_quality(res.tracklets, seq, n_top=6)
    iters = tracker.outputs_to_numpy(passes[-1][1]).als_iters
    emit({"phase": "default", "frames": res.n_frames, "fps": res.fps,
          "track_time_s": res.track_time_s, "timings": res.timings, "quality": q,
          "reference": DEFAULT_REFERENCE, "reproj_gate_px": REPROJ_GATE_PX,
          "tracklets_equal_reference": q["n_tracklets"] == DEFAULT_REFERENCE["n_tracklets"],
          "poses_finite": finite, "als_iters": als_iteration_stats(iters, cfg.als_max_iter),
          "launches": launches,
          "launches_per_frame": {k: v / (2 * res.n_frames) for k, v in launches.items()},
          "host_syncs_per_frame": syncs / (2 * res.n_frames)})
    if not (finite and q["n_tracklets"] > 0 and launches["als"] > 0):
        raise AssertionError("default output or kernel launches missing")
    if any(launches[k] for k in ("gj_solve", "gj_solve_grid", "fused_normal_gj")):
        raise AssertionError("the Cholesky LM launched a Gauss-Jordan kernel")
    gate_quality("default", q, DEFAULT_REFERENCE)
    return launches


def phase_no_ik(torch, dev, seq, cfg):
    """Triangulation mode (`use_ik=False`) on the default preset and scene:
    no LM, so only B1 launches; reprojection on the 17 COCO joints within
    the JAX skill's bound and the JAX package's run."""
    from multiview_motion_capture_torch import pipeline

    zero_launch_counts()
    res = pipeline.run(seq.batch, seq.cameras, cfg, use_ik=False, device=dev)
    launches = launch_counts()
    q, finite = run_quality(coco17(res.tracklets), seq, n_top=6)
    emit({"phase": "no_ik", "frames": res.n_frames, "fps": res.fps,
          "track_time_s": res.track_time_s, "quality": q,
          "reference": DEFAULT_NO_IK_REFERENCE, "reproj_bound_px": NO_IK_REPROJ_BOUND_PX,
          "poses_finite": finite, "launches": launches})
    if not (finite and q["n_tracklets"] > 0 and launches["als"] > 0):
        raise AssertionError("no_ik output or kernel launches missing")
    if any(launches[k] for k in ("gj_solve", "gj_solve_grid", "fused_normal_gj")):
        raise AssertionError("triangulation mode launched an LM kernel")
    if not q["mean_reproj_px"] < NO_IK_REPROJ_BOUND_PX:
        raise AssertionError("triangulation mode's reprojection is above its bound")
    gate_quality("no_ik", q, DEFAULT_NO_IK_REFERENCE)
    return launches


def phase_stream(torch, dev, seq, cfg):
    """The streaming `MvTracker` over the scene's first STREAM_FRAMES
    frames: one `update` per frame, then `update_batch` in chunks of
    STREAM_CHUNK with pad_to=STREAM_CHUNK (the tail chunk is short); each
    must equal `run_offline` on the card bit for bit, every FrameOutput
    field.  The latency of one `update` (host clock, the output on the
    host: the device is synchronised) is what an online user waits for a
    frame."""
    import numpy as np

    from multiview_motion_capture_torch import MvTracker, tracker
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses

    b = filter_bad_poses(seq.batch, cfg)
    kps, valid = b.kps[:STREAM_FRAMES], b.valid[:STREAM_FRAMES]
    ctx = tracker.TrackerContext.build(seq.cameras, cfg, device=dev)
    ref = tracker.outputs_to_numpy(tracker.run_offline(ctx, kps, valid)[1])

    zero_launch_counts()
    online = MvTracker(seq.cameras, cfg, device=dev)
    ms = []
    for f in range(STREAM_FRAMES):
        t0 = time.perf_counter()
        online.update(f, kps[f], valid[f])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    chunked = MvTracker(seq.cameras, cfg, device=dev)
    chunk_ms = []
    for s in range(0, STREAM_FRAMES, STREAM_CHUNK):
        e = min(s + STREAM_CHUNK, STREAM_FRAMES)
        t0 = time.perf_counter()
        chunked.update_batch(list(range(s, e)), kps[s:e], valid[s:e], pad_to=STREAM_CHUNK)
        chunk_ms.append((time.perf_counter() - t0) * 1e3 / (e - s))

    def differing(outs):
        return [f for f in tracker.FrameOutput._fields
                if not np.array_equal(np.stack([getattr(o, f) for o in outs]), getattr(ref, f))]

    bad_update, bad_batch = differing(online.outputs), differing(chunked.outputs)
    emit({"phase": "stream", "frames": STREAM_FRAMES, "motion_gain": cfg.motion_gain,
          "chunk": STREAM_CHUNK, "tail_chunk": STREAM_FRAMES % STREAM_CHUNK,
          "update_ms_median": statistics.median(ms),
          "update_ms_p95": float(np.percentile(ms, 95)), "update_ms_max": max(ms),
          "update_batch_ms_per_frame_median": statistics.median(chunk_ms),
          "update_bit_equal_run_offline": not bad_update,
          "update_batch_bit_equal_run_offline": not bad_batch,
          "fields_differing": {"update": bad_update, "update_batch": bad_batch},
          "tracklets": len(online.tracklets()), "launches": launches})
    if bad_update or bad_batch or launches["als"] == 0:
        raise AssertionError("the streaming tracker differs from run_offline")
    return launches


def phase_appearance(torch, dev, seq, cfg, app):
    """Appearance evidence end to end on the card (B1 as a cluster of 16 at
    N = 116, B2), its quality against the JAX package's run, and the final
    auto-gain statistics."""
    from multiview_motion_capture_torch import pipeline, tracker

    zero_launch_counts()
    with recording_run_offline() as passes:
        res = pipeline.run(seq.batch, seq.cameras, cfg, app=app, device=dev)
    launches = launch_counts()
    q, finite = run_quality(res.tracklets, seq)
    state, o = passes[-1]
    stats = state.app_stats.cpu().tolist()
    emit({"phase": "appearance", "frames": res.n_frames, "fps": res.fps,
          "track_time_s": res.track_time_s, "timings": res.timings, "quality": q,
          "reference": APPEARANCE_REFERENCE, "reproj_gate_px": REPROJ_GATE_PX,
          "tracklets_equal_reference": q["n_tracklets"] == APPEARANCE_REFERENCE["n_tracklets"],
          "poses_finite": finite,
          "app_stats": dict(zip(("cos_same", "cos_diff", "weight", "var_same"), stats)),
          "als_iters": als_iteration_stats(tracker.outputs_to_numpy(o).als_iters,
                                           cfg.als_max_iter),
          "mean_concurrent_tracks": res.mean_concurrent_tracks, "launches": launches,
          "launches_per_frame": {k: v / (2 * res.n_frames) for k, v in launches.items()}})
    if not (finite and q["n_tracklets"] > 0 and launches["als"] > 0
            and launches["gj_solve"] > 0):
        raise AssertionError("appearance output or kernel launches missing")
    if not (stats[2] > 0.5 and all(map(math.isfinite, stats))):
        raise AssertionError("the auto-gain statistics did not collect")
    gate_quality("appearance", q, APPEARANCE_REFERENCE)
    return launches, res.tracklets


def identity_scores(tracklets, seq) -> dict:
    from multiview_motion_capture_torch import eval as ev

    m = ev.identity_metrics(tracklets, seq.gt_slot_person)
    return {"n_tracks": m.n_pred_tracks, "idf1": m.idf1, "id_switches": m.id_switches,
            "fragments": m.fragments_per_identity, "gt_identities": m.n_gt_identities}


def phase_identity(seq, raw):
    """The host post-passes on the appearance run's raw tracklets (its
    config keeps every tracklet: min_track_length 1), in `pipeline.run`'s
    order: crossing repair, the re-ID merge, the ghost filter.  Identity
    scores after each stage beside the JAX package's; the final IDF1 is
    held within IDF1_TOL of the JAX package's.  No kernel runs here."""
    from multiview_motion_capture_torch import crossings, pipeline, reid

    t0 = time.perf_counter()
    crossed, log = crossings.resolve_crossings(list(raw), return_log=True)
    merged = reid.merge_tracklets(crossed)
    final = pipeline.filter_ghost_tracklets(merged, IDENTITY_MIN_TRACK_LENGTH)
    host_s = time.perf_counter() - t0
    stages = {"raw": raw, "crossings": crossed, "reid": merged, "ghost_filter": final}
    scores = {k: identity_scores(v, seq) for k, v in stages.items()}
    scores["crossings"].update(
        events=sum(1 for e in log if "t_star" in e), swaps=sum(1 for e in log if e.get("swap")),
        cuts=sum(1 for e in log if "cut_track" in e or "cut" in e))
    ref = IDENTITY_REFERENCE
    emit({"phase": "identity", "post_pass_host_s": host_s, **scores,
          "id_switches_by_stage": {k: {"port": scores[k]["id_switches"],
                                       "jax": ref[k]["id_switches"]} for k in stages},
          "idf1_by_stage": {k: {"port": scores[k]["idf1"], "jax": ref[k]["idf1"]}
                            for k in stages},
          "idf1_tol": IDF1_TOL})
    if not abs(scores["ghost_filter"]["idf1"] - ref["ghost_filter"]["idf1"]) <= IDF1_TOL:
        raise AssertionError("the final IDF1 is off the JAX package's")
    return final


def tracklets_differing(a, b) -> list:
    """Where two tracklet lists differ, field by field (empty: bit-equal)."""
    import numpy as np

    if len(a) != len(b):
        return [f"{len(a)} tracklets vs {len(b)}"]
    bad = []
    for i, (x, y) in enumerate(zip(a, b)):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            same = (u is None and v is None) if u is None or v is None else \
                np.array_equal(np.asarray(u), np.asarray(v), equal_nan=True)
            if not same:
                bad.append(f"tracklet {i}: {f.name}")
    return bad


def phase_checkpoint(torch, dev, seq, cfg, app, final):
    """`pipeline.run` in checkpointed chunks with the crossing repair (and
    so the merge) and the ghost filter at IDENTITY_MIN_TRACK_LENGTH: one
    pass of the scene in chunks of CHECKPOINT_EVERY frames, each chunk's
    state and outputs written, then a resume after chunk 1 with the state
    loaded onto the card.  Both runs' tracklets must equal the `identity`
    phase's final tracklets bit for bit: same card, same inputs, and the
    chunks and the post-passes change nothing."""
    import json
    import tempfile

    from multiview_motion_capture_torch import pipeline
    from multiview_motion_capture_torch.utils import checkpoint as ckpt

    ccfg = dataclasses.replace(cfg, min_track_length=IDENTITY_MIN_TRACK_LENGTH)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        ck = Path(tmp) / "checkpoints"

        def run():
            t0 = time.perf_counter()
            res = pipeline.run(seq.batch, seq.cameras, ccfg, app=app, crossings=True,
                               checkpoint_dir=ck, checkpoint_every=CHECKPOINT_EVERY,
                               device=dev)
            return res, time.perf_counter() - t0

        zero_launch_counts()
        res, run_s = run()
        launches = launch_counts()
        chunks = sorted(p.name for p in ck.glob("chunk_*.npz"))
        bad = tracklets_differing(res.tracklets, final)
        state = ckpt.load_state(ck, 1, device=dev)
        on_card = all(getattr(state, f.name).device.type == "cuda"
                      for f in dataclasses.fields(state))
        (ck / "meta.json").write_text(json.dumps({"last_chunk": 1,
                                                  "end_frame": 2 * CHECKPOINT_EVERY}))
        resumed, resume_s = run()
        bad_resumed = tracklets_differing(resumed.tracklets, final)
    emit({"phase": "checkpoint", "frames": res.n_frames, "every": CHECKPOINT_EVERY,
          "chunks": len(chunks), "run_s": run_s, "track_time_s": res.track_time_s,
          "resume_s": resume_s, "resumed_track_time_s": resumed.track_time_s,
          "timings": res.timings, "tracklets": len(res.tracklets),
          "bit_equal_identity": not bad, "resumed_bit_equal_identity": not bad_resumed,
          "fields_differing": {"run": bad[:10], "resumed": bad_resumed[:10]},
          "resumed_state_on_card": on_card, "launches": launches})
    if bad or bad_resumed:
        raise AssertionError("the checkpointed run differs from the identity phase's tracklets")
    if not (on_card and len(chunks) == -(-res.n_frames // CHECKPOINT_EVERY)
            and launches["als"] > 0 and launches["gj_solve"] > 0):
        raise AssertionError("checkpoint state, chunks or kernel launches missing")
    return launches


def phase_wide(torch, dev, seq, cfg):
    """PipelineConfig.wide(64) end to end on the card: quality against the
    JAX package's run of the same scene, and the first frame whose decisions
    differ from that run's (by decision digest), with both runs' ALS
    iterations there.  Only the card's quality is gated (reprojection within
    REPROJ_GATE_PX, no degenerate pose): a different grouping on a frame
    whose ALS does not settle is reported, not gated."""
    from multiview_motion_capture_torch import eval as ev
    from multiview_motion_capture_torch import pipeline, tracker
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses

    zero_launch_counts()
    res = pipeline.run(seq.batch, seq.cameras, cfg, device=dev)
    launches = launch_counts()
    q, finite = run_quality(res.tracklets, seq)

    b = filter_bad_poses(seq.batch, cfg)
    ctx = tracker.TrackerContext.build(seq.cameras, cfg, device=dev)
    with recording_associate() as xbins:
        _, o = tracker.run_offline(ctx, b.kps, b.valid)
    o = tracker.outputs_to_numpy(o)
    dig, ref = ev.decision_digests(o), WIDE_REFERENCE["decision_digests"]
    first = next((f for f in range(len(dig)) if dig[f] != ref[f]), None)
    ref_q = {k: WIDE_REFERENCE[k] for k in q}
    out = {"phase": "wide", "frames": res.n_frames, "fps": res.fps,
           "track_time_s": res.track_time_s, "timings": res.timings, "quality": q,
           "reference": ref_q, "reproj_gate_px": REPROJ_GATE_PX, "poses_finite": finite,
           "tracklets_equal_reference": q["n_tracklets"] == ref_q["n_tracklets"],
           "first_frame_decisions_differ_from_reference": first,
           "als_iters_there": (None if first is None else
                               {"card": int(o.als_iters[first]),
                                "reference": WIDE_REFERENCE["als_iters"][first]}),
           "frames_decisions_equal_reference": sum(a == r for a, r in zip(dig, ref)),
           "als_iters_at_cap_frames": int((o.als_iters >= cfg.assoc_clusters
                                           * cfg.als_max_iter).sum()),
           "mean_concurrent_tracks": res.mean_concurrent_tracks,
           "launches": launches, "launches_per_frame": {
               k: v / (2 * res.n_frames) for k, v in launches.items()}}
    emit(out)
    if not (finite and q["n_tracklets"] > 0 and launches["als_batched"] > 0
            and launches["gj_solve"] > 0):
        raise AssertionError("wide output or kernel launches missing")
    if (q["n_degenerate_poses"] != 0
            or abs(q["mean_reproj_px"] - ref_q["mean_reproj_px"]) > REPROJ_GATE_PX
            or abs(q["median_reproj_px"] - ref_q["median_reproj_px"]) > REPROJ_GATE_PX):
        raise AssertionError("wide quality is off the JAX reference")
    # its per-frame outputs and x_bins: what `mesh_wide` holds its run against
    return launches, res, (o, [x.cpu() for x in xbins])


def phase_wide_fused(torch, dev, seq, cfg, gj_res):
    """The wide run again with ik_solver="gj_fused" (kernel B4): its
    tracklets and reprojection against the "gj" pass."""
    import numpy as np

    from multiview_motion_capture_torch import pipeline

    cfg = dataclasses.replace(cfg, ik_solver="gj_fused")
    zero_launch_counts()
    res = pipeline.run(seq.batch, seq.cameras, cfg, device=dev)
    launches = launch_counts()
    q, finite = run_quality(res.tracklets, seq)
    q_gj, _ = run_quality(gj_res.tracklets, seq)

    def structure(r):
        return [(t.track_id, list(t.frame_idxs), np.asarray(t.matched_pose).tolist())
                for t in r.tracklets]

    same = structure(res) == structure(gj_res)
    pose = (max(float(np.abs(a.poses_3d - b.poses_3d).max())
                for a, b in zip(res.tracklets, gj_res.tracklets)) if same else None)
    emit({"phase": "wide_fused", "frames": res.n_frames, "fps": res.fps,
          "track_time_s": res.track_time_s, "timings": res.timings, "quality": q,
          "gj_pass_quality": q_gj, "tracklets_equal_gj_pass": same,
          "max_pose_diff_m_vs_gj_pass": pose, "poses_finite": finite,
          "launches": launches})
    if not (finite and q["n_tracklets"] > 0 and q["n_degenerate_poses"] == 0
            and launches["fused_normal_gj"] > 0 and launches["als_batched"] > 0):
        raise AssertionError("wide_fused output or kernel launches missing")
    return launches


def write_scene_files(seq, root: Path, n_frames: int, kps_dir: str = "kps", calib=None):
    """The first `n_frames` frames of a synthetic sequence as the CLI's
    inputs: `root/calibs/camNN.json` ({"K", "RT", "imgSize"}, the
    reference's calibration format) and `root/<kps_dir>/camNN/` with one
    OpenPose BODY_25 JSON file a frame (each valid detection a person, its
    COCO keypoints at their BODY_25 places, the rest zero).  The valid
    detections of a synthetic view fill its first slots, so the files load
    back into the same batch, bit for bit.  `kps_dir="kps_opn"` gives the
    Shelf dataset's layout, which the `bench` mode reads.  `calib`: the
    (K, RT) to write in place of the bank's float32 ones
    (`cameras.camera_ring_k_rt(V)[:2]` gives the float64 values a synthetic
    ring's bank was made from, with which the files load back into the same
    bank, bit for bit)."""
    import numpy as np

    from multiview_motion_capture_torch.pose_def import OPENPOSE25_TO_COCO

    cams = seq.cameras
    K, Rt, wh = (np.asarray(getattr(cams, f).cpu(), dtype=np.float64)
                 for f in ("K", "Rt", "img_wh"))
    if calib is not None:
        K, Rt = calib
    (root / "calibs").mkdir(parents=True)
    for v in range(len(K)):
        (root / "calibs" / f"cam{v:02d}.json").write_text(json.dumps(
            {"K": K[v].ravel().tolist(), "RT": Rt[v].ravel().tolist(),
             "imgSize": wh[v].tolist()}))
        d = root / kps_dir / f"cam{v:02d}"
        d.mkdir(parents=True)
        for f in range(n_frames):
            people = []
            for p in np.nonzero(seq.batch.valid[f, v])[0]:
                body25 = np.zeros((25, 3), dtype=np.float32)
                body25[OPENPOSE25_TO_COCO] = seq.batch.kps[f, v, p]
                people.append({"pose_keypoints_2d": body25.ravel().tolist()})
            (d / f"{v}_{f:012d}_keypoints.json").write_text(json.dumps({"people": people}))


def person_tints(n_people: int):
    """Distinct stable clothing colours, spread over the hue circle
    (scripts/appearance_e2e_study.py:93-100)."""
    import numpy as np

    hues = np.linspace(0, 1, n_people, endpoint=False)
    return np.stack([1.0 + 0.5 * np.stack([np.cos(2 * np.pi * h),
                                           np.cos(2 * np.pi * (h + 1 / 3)),
                                           np.cos(2 * np.pi * (h + 2 / 3))])
                     for h in hues]).astype(np.float32)


def to_uint8(frames):
    import numpy as np

    return np.round(frames * 255.0).astype(np.uint8)


def detect_scene(n_frames: int = None):
    """The detect path's scene: (sequence, tracker config, uint8 frames (F,
    V, 192, 256, 3), cameras scaled to the frames)."""
    from examples.torch_e2e_fullframe import scaled_cameras
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.detect_train import render_sequence
    from multiview_motion_capture_torch.data.render import RenderConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    cfg = PipelineConfig(**DETECT_CFG)
    scene = dict(DETECT_SCENE, n_frames=n_frames or DETECT_SCENE["n_frames"])
    seq = synthetic_sequence(cfg=cfg, **scene)
    frames = render_sequence(seq, RenderConfig(hw=DETECT_RENDER["hw"]),
                             world_scale=DETECT_RENDER["world_scale"],
                             seed=DETECT_RENDER["seed"],
                             person_tints=person_tints(scene["n_people"]))
    return seq, cfg, to_uint8(frames), scaled_cameras(seq.cameras, DETECT_RENDER["world_scale"])


def label_detections(seq, batch, app):
    """The person of each detection slot, by the nearest projected ground
    truth within 40 px (the detector's slots are not the generator's), and
    the embeddings' mean same- and different-person cosines
    (scripts/appearance_e2e_study.py:200-226)."""
    import numpy as np

    ws = DETECT_RENDER["world_scale"]
    F, V, P = batch.valid.shape
    det_slot_person = np.full((F, V, P), -1, dtype=np.int32)
    embs, labels = [], []
    for f in range(F):
        for v in range(V):
            gt = seq.batch.kps[f, v][..., :2] * ws
            slotp = seq.gt_slot_person[f, v]
            for d in range(P):
                if not batch.valid[f, v, d]:
                    continue
                errs = [np.nanmean(np.linalg.norm(batch.kps[f, v, d, :, :2] - gt[s], axis=-1))
                        if slotp[s] >= 0 else 1e9 for s in range(gt.shape[0])]
                s_best = int(np.argmin(errs))
                if errs[s_best] < 40:
                    det_slot_person[f, v, d] = int(slotp[s_best])
                    embs.append(app[f, v, d])
                    labels.append(int(slotp[s_best]))
    embs = np.stack(embs)
    labels = np.asarray(labels)
    cos = embs @ embs.T
    same = float(cos[labels[:, None] == labels[None, :]].mean())
    diff = float(cos[labels[:, None] != labels[None, :]].mean())
    return det_slot_person, (same, diff)


def detect_quality(seq, batch, app, tracklets, evaluate_detections, identity_metrics,
                   mpjpe_vs_ground_truth, joint_map) -> dict:
    """What the detect path is judged by, with either package's functions:
    detection recall / precision / mean error at DETECT_MATCH_PX against
    the rendered ground truth, the valid detections of each (frame, view)
    as a string of digits, tracklets, identity against the detections'
    labels, MPJPE against gt_3d."""
    import numpy as np

    F, V, P, K = batch.kps.shape[:4]
    ws = DETECT_RENDER["world_scale"]
    det = evaluate_detections(batch.kps.reshape(F * V, P, K, 3), batch.valid.reshape(F * V, P),
                              seq.batch.kps[..., :2].reshape(F * V, -1, K, 2) * ws,
                              seq.batch.valid.reshape(F * V, -1), match_px=DETECT_MATCH_PX)
    labels, (cos_same, cos_diff) = label_detections(seq, batch, app)
    idm = identity_metrics(tracklets, labels)
    lengths = sorted((len(t) for t in tracklets), reverse=True)
    return {"recall": det["recall"], "precision": det["precision"],
            "mean_err_px": det["mean_err_px"], "n_det": det["n_det"],
            "valid_counts": "".join(str(int(n)) for n in batch.valid.sum(-1).reshape(-1)),
            "cos_same": cos_same, "cos_diff": cos_diff,
            "n_tracklets": len(tracklets), "top_lengths": lengths[:8],
            "idf1": idm.idf1, "id_switches": idm.id_switches,
            "mpjpe_m": mpjpe_vs_ground_truth(tracklets, seq.gt_3d, joint_map=joint_map)}


def compare_detections(ref, got) -> dict:
    """Two runs of a bottom-up detector over the same frames: `ref` and
    `got` are lists over frames of numpy (kps (V, P, K, 3), centers (V, P,
    3), valid (V, P)) in frame pixels.  Counts the (frame, view) images
    whose valid masks are equal and whose center pixels are equal as sets
    (a near-tie of two people's center scores reorders the slots), names
    the first image whose centers differ, and pairs each valid detection
    with the nearest center of the other run: the largest center shift,
    and the keypoint differences of the pairs at the same center pixel
    (largest, median, 90th and 99th percentiles, largest where both scores
    exceed 0.1) and of the pairs whose centers moved (their offsets are
    gathered at another pixel)."""
    import numpy as np

    n_img = n_valid_eq = n_centers_eq = 0
    shift, same_px, moved, scored, first = 0.0, [], [0.0], [0.0], None
    for f, (r, g) in enumerate(zip(ref, got)):
        for v in range(r[2].shape[0]):
            n_img += 1
            rv, gv = r[2][v], g[2][v]
            n_valid_eq += int(np.array_equal(rv, gv))
            rc, gc = r[1][v][rv][:, :2], g[1][v][gv][:, :2]
            same = sorted(map(tuple, rc.tolist())) == sorted(map(tuple, gc.tolist()))
            n_centers_eq += int(same)
            if not same and first is None:
                first = {"frame": f, "view": v, "ref": r[1][v][rv].tolist(),
                         "got": g[1][v][gv].tolist()}
            if not len(rc) or not len(gc):
                continue
            for i, c in zip(np.nonzero(rv)[0], rc):
                d = np.linalg.norm(gc - c, axis=1)
                j = np.nonzero(gv)[0][int(np.argmin(d))]
                shift = max(shift, float(d.min()))
                a, b = r[0][v, i], g[0][v, j]
                e = np.abs(a[:, :2] - b[:, :2]).max(-1)
                if d.min() > 0:
                    moved.append(float(e.max()))
                    continue
                same_px.append(e)
                scored.append(float(e[(a[:, 2] > 0.1) & (b[:, 2] > 0.1)].max(initial=0.0)))
    same_px = np.concatenate(same_px) if same_px else np.zeros(1)
    return {"images": n_img, "valid_equal": n_valid_eq, "centers_equal": n_centers_eq,
            "max_center_shift_px": shift, "first_centers_differ": first,
            "max_kps_diff_px": float(same_px.max()),
            "median_kps_diff_px": float(np.median(same_px)),
            "p90_kps_diff_px": float(np.percentile(same_px, 90)),
            "p99_kps_diff_px": float(np.percentile(same_px, 99)),
            "max_scored_kps_diff_px": max(scored),
            "moved_centers": len(moved) - 1, "max_kps_diff_moved_px": max(moved)}


def run_cascade(detect_mod, mcfg, params, cfg, frames, host) -> dict:
    """The two other detectors with either package's `data.detect` (`params`:
    the flax tree or the port's PoseNet; `host`: its arrays to numpy): the
    propose -> crop -> top-down cascade on uint8 `frames` (F, V, H, W, 3)
    at CASCADE_CROP_HW, then the top-down `make_detector` with
    `crops_to_frame_batch` on crops cut at the cascade's boxes.  Returns
    what `compare_cascade` holds: the valid slots of each (frame, view) as
    digits, and for each valid slot in (frame, view, slot) order its box
    origin and mean keypoint (the 17 keypoints; of the top-down detector,
    whose soft-argmax decodes every channel, the first 17)."""
    import numpy as np

    ch, cw = CASCADE_CROP_HW
    cascade = detect_mod.make_multi_person_detector(mcfg, max_people=cfg.max_people,
                                                    crop_hw=CASCADE_CROP_HW)
    outs = [[host(a) for a in cascade(params, fr)] for fr in frames]
    kps, boxes, valid = (np.stack([o[i] for o in outs]) for i in range(3))
    F, V, P = valid.shape
    crops = np.zeros((F, V, P, ch, cw, 3), dtype=np.float32)
    for f, v, p in np.ndindex(F, V, P):
        x0, y0 = boxes[f, v, p, :2].astype(int)
        crops[f, v, p] = frames[f, v, y0:y0 + ch, x0:x0 + cw].astype(np.float32) / 255.0
    top_down, _ = detect_mod.make_detector(mcfg, params)
    fb = detect_mod.crops_to_frame_batch(top_down, params, crops, boxes, valid, cfg)
    K = mcfg.n_kps

    def digits(v):
        return "".join(str(int(n)) for n in v.sum(-1).reshape(-1))

    return {"valid": digits(valid), "boxes": boxes[valid][:, :2].astype(int).tolist(),
            "mean_xy": np.round(kps[valid][:, :K, :2].mean(1), 3).tolist(),
            "crop_valid": digits(fb.valid),
            "crop_mean_xy": np.round(fb.kps[fb.valid][:, :K, :2].mean(1), 3).tolist()}


def compare_cascade(got: dict, ref: dict) -> dict:
    """`run_cascade`'s outputs against the reference's: valid slots equal
    in every (frame, view); within each, slots paired by the nearest mean
    keypoint (a near-tie of two proposals' scores reorders the slots); the
    largest box-origin difference and the largest and median mean-keypoint
    differences of the pairs."""
    import numpy as np

    out = {"valid_equal": got["valid"] == ref["valid"],
           "crop_valid_equal": got["crop_valid"] == ref["crop_valid"]}
    for name, counts, key in (("cascade", "valid", "mean_xy"),
                              ("top_down", "crop_valid", "crop_mean_xy")):
        if got[counts] != ref[counts]:
            continue
        box, xy, i = 0.0, [], 0
        for n in map(int, ref[counts]):
            r = np.asarray(ref[key][i:i + n], dtype=float)
            g = np.asarray(got[key][i:i + n], dtype=float)
            pair = i + np.asarray([int(np.argmin(np.linalg.norm(g - x, axis=1))) for x in r],
                                  dtype=int)
            xy.extend(np.abs(r - g[pair - i]).max(-1).tolist())
            if name == "cascade":
                box = max(box, float(np.abs(np.asarray(ref["boxes"][i:i + n])
                                            - np.asarray(got["boxes"])[pair]).max(initial=0)))
            i += n
        out[name] = {"max_mean_xy_diff_px": max(xy, default=0.0),
                     "median_mean_xy_diff_px": float(np.median(xy)) if xy else 0.0}
        if name == "cascade":
            out[name]["max_box_diff_px"] = box
    return out


def posenet_ops(cfg, h: int, w: int) -> float:
    """Multiply-adds x 2 of one PoseNet forward on an h x w image."""
    def down(n, s):
        return -(-n // s)

    h, w = down(h, 2), down(w, 2)
    macs = h * w * 3 * cfg.stem_features * 49
    h, w, cin = down(h, 2), down(w, 2), cfg.stem_features
    for i, feats in enumerate(cfg.stage_features):
        for b in range(cfg.blocks_per_stage):
            s = 2 if i > 0 and b == 0 else 1
            h, w = down(h, s), down(w, s)
            macs += h * w * 9 * (cin * feats + feats * feats)
            if s != 1 or cin != feats:
                macs += h * w * cin * feats
            cin = feats
    for _ in range(2):      # each input pixel meets the 4 x 4 kernel
        macs += h * w * 16 * cin * cfg.head_features
        h, w, cin = 2 * h, 2 * w, cfg.head_features
    macs += h * w * cin * cfg.n_out
    return 2.0 * macs


def count_kernels(fn, reps: int = 5):
    """CUDA kernels a call of `fn` launches and their summed device ms."""
    kernels = kernel_events(fn, reps)
    return len(kernels) / reps, sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps


def phase_detect(torch, dev):
    """The detect path end to end on the card: the shipped bottom-up PoseNet
    and appearance head over the scene's uint8 frames
    (`frames_to_frame_batch`, twice: the second pass is timed), then
    `pipeline.run(use_ik=True, app=, crossings=True)` (B1, B2).  Held
    against the JAX package's run of the same scene and options
    (DETECT_REFERENCE): the valid detections of every (frame, view) equal,
    or the first that differs named; recall and mean error within
    DETECT_RECALL_TOL / DETECT_ERR_TOL_PX; the final IDF1 within IDF1_TOL.
    Also the forward's and the whole detector's kernels a frame, their
    device time, the forward's bound, and the host syncs of one detector
    call (none: the loop's one host read is `frames_to_frame_batch`'s)."""
    import numpy as np

    from multiview_motion_capture_torch import eval as ev
    from multiview_motion_capture_torch import pipeline
    from multiview_motion_capture_torch.data.detect import (
        frames_to_frame_batch,
        make_bottom_up_detector,
        resize,
    )
    from multiview_motion_capture_torch.data.detect_train import evaluate_detections
    from multiview_motion_capture_torch.models.checkpoint import (
        load_appearance_head,
        load_posenet,
    )
    from multiview_motion_capture_torch.pose_def import KpsFormat, common_kps_index

    t0 = time.perf_counter()
    seq, cfg, frames, cams = detect_scene()
    render_s = time.perf_counter() - t0
    mcfg, net = load_posenet(CHECKPOINTS / "posenet_synth.npz", device=dev)
    _, head = load_appearance_head(CHECKPOINTS / "appearance_head.npz", device=dev)
    detect = make_bottom_up_detector(mcfg, appearance_head=head, **DETECTOR)

    zero_launch_counts()
    batch, app = frames_to_frame_batch(detect, net, frames, cfg, collect_appearance=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch2, app2 = frames_to_frame_batch(detect, net, frames, cfg, collect_appearance=True)
    detect_s = time.perf_counter() - t0
    res = pipeline.run(batch, cams, cfg, use_ik=True, app=app, crossings=True, device=dev)
    launches = launch_counts()

    q = detect_quality(seq, batch, app, res.tracklets, evaluate_detections,
                       ev.identity_metrics, ev.mpjpe_vs_ground_truth,
                       common_kps_index(KpsFormat.BASIC_18, KpsFormat.COCO))
    ref = DETECT_REFERENCE
    first = next((i for i, (a, b) in enumerate(zip(q["valid_counts"], ref["valid_counts"]))
                  if a != b), None)
    V = cfg.n_views
    one = torch.as_tensor(frames[0], device=dev)
    fwd_in = resize(one.float() / 255.0, DETECTOR["full_hw"])
    fwd_launches, fwd_ms = count_kernels(lambda: net(fwd_in))
    det_launches, det_ms = count_kernels(lambda: detect(net, one))
    _, det_syncs = count_syncs(lambda: detect(net, one))
    n_params = sum(p.numel() for p in net.parameters())
    ops = V * posenet_ops(mcfg, *DETECTOR["full_hw"])
    # the frame read once (f32 after the uint8 conversion), the bf16
    # weights once, the heat written once
    fh, fw = DETECTOR["full_hw"]
    n_bytes = V * fh * fw * 3 * 4 + n_params * 2 + V * (fh // 4) * (fw // 4) * mcfg.n_out * 4
    fwd_bound_ms = max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_BF16_FLOPS) * 1e3
    emit({"phase": "detect", "frames": len(frames), "views": V, "render_s": render_s,
          "detect_fps": len(frames) / detect_s, "detect_s": detect_s,
          "second_pass_equal_first": bool((batch.kps == batch2.kps).all()
                                          and (batch.valid == batch2.valid).all()
                                          and (app == app2).all()),
          "track_fps": res.fps, "track_time_s": res.track_time_s, "timings": res.timings,
          "forward_launches_per_frame": fwd_launches, "forward_device_ms_per_frame": fwd_ms,
          "detect_launches_per_frame": det_launches, "detect_device_ms_per_frame": det_ms,
          "decode_launches_per_frame": det_launches - fwd_launches,
          "detect_host_syncs_per_frame": det_syncs,
          "forward_gflop_per_frame": ops / 1e9, "forward_bound_ms": fwd_bound_ms,
          "quality": q, "reference": ref,
          "first_view_frame_counts_differ": (None if first is None else
                                             {"frame": first // V, "view": first % V,
                                              "card": q["valid_counts"][first],
                                              "reference": ref["valid_counts"][first]}),
          "view_frames_counts_equal": sum(a == b for a, b in
                                          zip(q["valid_counts"], ref["valid_counts"])),
          "recall_tol": DETECT_RECALL_TOL, "err_tol_px": DETECT_ERR_TOL_PX, "idf1_tol": IDF1_TOL,
          "launches": launches})
    if not (launches["als"] > 0 and launches["gj_solve"] > 0 and q["n_tracklets"] > 0
            and all(np.isfinite(t.poses_3d).all() for t in res.tracklets)):
        raise AssertionError("detect output or kernel launches missing")
    if det_syncs:
        raise AssertionError("the detector synchronises with the host")
    if (abs(q["recall"] - ref["recall"]) > DETECT_RECALL_TOL
            or abs(q["mean_err_px"] - ref["mean_err_px"]) > DETECT_ERR_TOL_PX
            or abs(q["idf1"] - ref["idf1"]) > IDF1_TOL):
        raise AssertionError("detect quality is off the JAX reference")
    return launches, frames


def phase_detect_parity(torch, dev, frames):
    """The first DETECT_PARITY_FRAMES frames of the detect scene through the
    bottom-up detector with the shipped weights on the card and on the CPU
    (the port on both), in the checkpoint's bf16 compute and in f32.  f32:
    valid masks and center pixels equal, keypoints within
    DETECT_F32_KPS_TOL_PX (a layout or padding fault moves them by
    pixels).  bf16 (cuDNN and the CPU round bf16 sums at other places):
    valid masks equal, centers within one heatmap pixel, keypoints at equal
    centers with their 90th percentile within DETECT_BF16_KPS_P90_TOL_PX;
    and two card runs bit-equal.
    The heat's largest difference is printed for both."""
    import numpy as np

    from multiview_motion_capture_torch.data.detect import make_bottom_up_detector, resize
    from multiview_motion_capture_torch.models.checkpoint import (
        load_appearance_head,
        load_posenet,
    )
    from multiview_motion_capture_torch.models.pose_net import PoseNet

    frames = frames[:DETECT_PARITY_FRAMES]
    loaded = {}
    for d in (dev, "cpu"):
        mcfg, net = load_posenet(CHECKPOINTS / "posenet_synth.npz", device=d)
        loaded[d] = net, load_appearance_head(CHECKPOINTS / "appearance_head.npz", device=d)[1]
    out = {"phase": "detect_parity", "frames": len(frames),
           "bf16_kps_p90_tol_px": DETECT_BF16_KPS_P90_TOL_PX,
           "f32_kps_tol_px": DETECT_F32_KPS_TOL_PX}
    ok = True
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        cfg = dataclasses.replace(mcfg, compute_dtype=dtype)
        runs, heat = {}, {}
        for d, (net, head) in loaded.items():
            n = PoseNet(cfg).to(d).eval()
            n.load_state_dict(net.state_dict())
            det = make_bottom_up_detector(cfg, appearance_head=head, **DETECTOR)
            runs[d] = [[a.cpu().numpy() for a in det(n, fr)] for fr in frames]
            with torch.no_grad():
                heat[d] = [n(resize(torch.as_tensor(fr, device=d).float() / 255.0,
                                    DETECTOR["full_hw"])).cpu().numpy() for fr in frames]
            if name == "bf16" and d == dev:
                again = [[a.cpu().numpy() for a in det(n, fr)] for fr in frames]
                out["card_runs_bit_equal"] = all(
                    np.array_equal(a, b) for x, y in zip(runs[d], again) for a, b in zip(x, y))
        cmp = compare_detections([r[:3] for r in runs["cpu"]], [r[:3] for r in runs[dev]])
        K = mcfg.n_kps
        diff = [np.abs(a - b) for a, b in zip(heat["cpu"], heat[dev])]
        cmp["max_heat_diff_keypoint_center"] = float(max(d[..., :K + 1].max() for d in diff))
        cmp["max_heat_diff_offsets"] = float(max(d[..., K + 1:].max() for d in diff))
        # embeddings of the images whose detections came out in the same slots
        same = [(a, b) for a, b in zip(runs["cpu"], runs[dev]) if np.array_equal(a[1], b[1])]
        cmp["max_emb_diff_same_slots"] = float(max((np.abs(a[3] - b[3]).max() for a, b in same),
                                                   default=0.0))
        out[name] = cmp
        every = cmp["valid_equal"] == cmp["images"]
        if name == "f32":
            ok &= (every and cmp["centers_equal"] == cmp["images"]
                   and cmp["max_kps_diff_px"] <= DETECT_F32_KPS_TOL_PX)
        else:
            ok &= (every and cmp["max_center_shift_px"] <= 4.0
                   and cmp["p90_kps_diff_px"] <= DETECT_BF16_KPS_P90_TOL_PX)
    emit(out)
    if not (ok and out["card_runs_bit_equal"]):
        raise AssertionError("the detector on the card and on the CPU disagree")


def phase_cascade(torch, dev, frames):
    """The cascade (`make_multi_person_detector`, crop CASCADE_CROP_HW) and
    the top-down detector (`make_detector` + `crops_to_frame_batch`) on its
    boxes' crops, over the detect scene's first CASCADE_FRAMES frames on the
    card, held against the JAX package's outputs (CASCADE_REFERENCE): valid
    slots equal; box origins within one heatmap pixel of the proposal pass
    (4 px); each detection's mean keypoint within DETECT_MATCH_PX (the
    distance at which the detection scores count the same person) and the
    median within CASCADE_MEDIAN_TOL_PX.  bf16 rounding flips the
    peak-local decode's argmax between near-equal pixels, and a box moved
    by a pixel of the proposal pass crops other pixels: single detections
    move by pixels, the median by hundredths."""
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data import detect
    from multiview_motion_capture_torch.models.checkpoint import load_posenet

    mcfg, net = load_posenet(CHECKPOINTS / "posenet_synth.npz", device=dev)
    got = run_cascade(detect, mcfg, net, PipelineConfig(**DETECT_CFG),
                      frames[:CASCADE_FRAMES], lambda a: a.cpu().numpy())
    cmp = compare_cascade(got, CASCADE_REFERENCE)
    emit({"phase": "cascade", "frames": CASCADE_FRAMES, "crop_hw": CASCADE_CROP_HW,
          "detections": sum(map(int, got["valid"])), "vs_reference": cmp,
          "median_tol_px": CASCADE_MEDIAN_TOL_PX, "max_tol_px": DETECT_MATCH_PX})
    if not (cmp["valid_equal"] and cmp["crop_valid_equal"]
            and cmp["cascade"]["max_box_diff_px"] <= 4.0
            and all(cmp[k]["max_mean_xy_diff_px"] <= DETECT_MATCH_PX
                    and cmp[k]["median_mean_xy_diff_px"] <= CASCADE_MEDIAN_TOL_PX
                    for k in ("cascade", "top_down"))):
        raise AssertionError("the cascade is off the JAX reference")


# ---------------------------------------------------------------------------
# training (no TPU kernel lies on it: convolutions and their gradients are
# XLA's in JAX, cuDNN's here)
# ---------------------------------------------------------------------------

def script_module(name: str):
    """A script of `scripts/` as a module (its functions, not its main)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_parity_samples(dev):
    """The 8 samples of train_parity, targets computed on `dev`."""
    from multiview_motion_capture_torch.data.detect_train import generate_samples
    from multiview_motion_capture_torch.data.render import RenderConfig

    kw = dict(TRAIN_PARITY_SAMPLES)
    return generate_samples(kw.pop("seeds"), RenderConfig(hw=(192, 256)), device=dev, **kw)


def train_parity_run(torch, dev, dtype, ss):
    """TRAIN_PARITY_STEPS steps of the bottom-up step on `dev` in `dtype`
    compute from the shipped checkpoint's weights, adamw(TRAIN_PARITY_LR),
    on the samples `ss` -> (the losses, the first step's gradients by flax
    leaf name in flax layout)."""
    from multiview_motion_capture_torch.data.detect_train import make_train_step
    from multiview_motion_capture_torch.models import checkpoint as ckpt
    from multiview_motion_capture_torch.models.optim import AdamW
    from multiview_motion_capture_torch.models.pose_net import PoseNet

    _, shipped = ckpt.load_posenet(CHECKPOINTS / "posenet_synth.npz", device=dev)
    cfg = dataclasses.replace(shipped.cfg, compute_dtype=dtype)
    net = PoseNet(cfg).to(dev)
    net.load_state_dict(shipped.state_dict())
    step = make_train_step(cfg, net, AdamW(net.parameters(), TRAIN_PARITY_LR))
    batch = [torch.as_tensor(a, device=dev) for a in (ss.images, ss.heat_tgt, ss.off_tgt,
                                                       ss.off_mask)]
    losses, grads = [], None
    for i in range(TRAIN_PARITY_STEPS):
        losses.append(step(*batch))
        if i == 0:
            grads = {ckpt.keystr(p): ckpt._to_flax(t.grad, kind)
                     for p, t, kind in ckpt._posenet_leaves(net)}
    return [float(x) for x in losses], grads


def grad_agreement(ref: dict, got: dict) -> dict:
    """Per-leaf gradient agreement: the largest difference over the leaf's
    largest magnitude, and the cosine; the worst leaf of each."""
    import numpy as np

    rel, cos = {}, {}
    for k, a in ref.items():
        b = got[k]
        rel[k] = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
        a64, b64 = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
        cos[k] = float(a64 @ b64 / max(np.linalg.norm(a64) * np.linalg.norm(b64), 1e-30))
    kr, kc = max(rel, key=rel.get), min(cos, key=cos.get)
    return {"max_rel_err": rel[kr], "max_rel_err_leaf": kr, "min_cos": cos[kc],
            "min_cos_leaf": kc}


def rel_diffs(a, b) -> list:
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def phase_train_parity(torch, dev):
    """The bottom-up PoseNet's training step at the shipped width on the
    card: TRAIN_PARITY_STEPS steps from the shipped weights on 8 samples of
    `generate_samples` (targets on the card, held against the CPU's).  f32
    compute: the loss of every step within TRAIN_F32_LOSS_RTOL of the
    port's CPU run and of TRAIN_REFERENCE, the first step's gradient of
    every leaf within TRAIN_F32_GRAD_TOL of its largest magnitude and at a
    cosine of at least TRAIN_F32_GRAD_COS against the CPU's.  bf16 compute (the shipped one): the losses within
    TRAIN_BF16_LOSS_RTOL of TRAIN_REFERENCE.  Both run twice on the card
    under torch.use_deterministic_algorithms(True): bit-equal."""
    import numpy as np

    t0 = time.perf_counter()
    ss = train_parity_samples(dev)
    cpu_ss = train_parity_samples("cpu")
    render_s = time.perf_counter() - t0
    tgt_diff = max(float(np.abs(getattr(ss, f) - getattr(cpu_ss, f)).max())
                   for f in ("heat_tgt", "off_tgt", "off_mask"))
    out = {"phase": "train_parity", "samples": int(ss.images.shape[0]),
           "steps": TRAIN_PARITY_STEPS, "lr": TRAIN_PARITY_LR, "render_s": render_s,
           "targets_card_vs_cpu_max_diff": tgt_diff,
           "images_equal": bool(np.array_equal(ss.images, cpu_ss.images)),
           "reference": TRAIN_REFERENCE, "f32_loss_rtol": TRAIN_F32_LOSS_RTOL,
           "f32_grad_tol": TRAIN_F32_GRAD_TOL, "f32_grad_cos": TRAIN_F32_GRAD_COS,
           "bf16_loss_rtol": TRAIN_BF16_LOSS_RTOL}
    ok = out["images_equal"] and tgt_diff <= 1e-6
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            losses, grads = train_parity_run(torch, dev, dtype, ss)
            again, grads2 = train_parity_run(torch, dev, dtype, ss)
            ref = TRAIN_REFERENCE[name]
            r = {"losses": losses, "vs_reference_rel": rel_diffs(losses, ref),
                 "card_runs_bit_equal": losses == again and all(
                     np.array_equal(grads[k], grads2[k]) for k in grads)}
            tol = TRAIN_F32_LOSS_RTOL if name == "float32" else TRAIN_BF16_LOSS_RTOL
            ok &= r["card_runs_bit_equal"] and max(r["vs_reference_rel"]) <= tol
            if name == "float32":
                torch.use_deterministic_algorithms(before)
                cpu_losses, cpu_grads = train_parity_run(torch, "cpu", dtype, ss)
                torch.use_deterministic_algorithms(True)
                r["cpu_losses"] = cpu_losses
                r["vs_cpu_rel"] = rel_diffs(losses, cpu_losses)
                r["grads_vs_cpu"] = grad_agreement(cpu_grads, grads)
                ok &= (max(r["vs_cpu_rel"]) <= TRAIN_F32_LOSS_RTOL
                       and r["grads_vs_cpu"]["max_rel_err"] <= TRAIN_F32_GRAD_TOL
                       and r["grads_vs_cpu"]["min_cos"] >= TRAIN_F32_GRAD_COS)
            out[name] = r
    finally:
        torch.use_deterministic_algorithms(before)
    emit(out)
    if not ok:
        raise AssertionError("the training step on the card is off the CPU's or JAX's")


def train_step_bound(cfg, batch: int, n_params: int, sample_bytes: int):
    """The least time of one bf16 training step: 3 x the forward's FLOPs
    (forward, and the backward's two products) on the tensor cores, or the
    batch read once and the f32 parameters, gradients and both moments each
    read and written once."""
    ops = 3 * batch * posenet_ops(cfg, *cfg.img_hw)
    n_bytes = batch * sample_bytes + n_params * 4 * 2 * 4
    return max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_BF16_FLOPS) * 1e3, ops, n_bytes


def phase_train(torch, dev):
    """A fresh PoseNet at the shipped width trained on the card in bf16:
    TRAIN_STEPS steps of batch TRAIN_BATCH (indices from a generator on the
    card) with scripts/train_posenet.py's warmup-cosine AdamW, on the
    samples of TRAIN_SEEDS (targets computed on the card).  Steps/s and
    images/s by the host clock around the synchronised loop; device ms and
    launches a step, and the idle share, by torch.profiler over
    TRAIN_PROFILE_STEPS more steps; the step's bf16 bound.  Gated on the
    loss falling: the mean of the last 10 steps' losses below
    TRAIN_LOSS_GATE x the first 10 steps'."""
    from torch.profiler import ProfilerActivity, profile

    from multiview_motion_capture_torch.data.detect_train import generate_samples, make_train_step
    from multiview_motion_capture_torch.data.render import RenderConfig
    from multiview_motion_capture_torch.models.optim import AdamW, warmup_cosine_decay_schedule
    from multiview_motion_capture_torch.models.pose_net import init_posenet

    t0 = time.perf_counter()
    ss = generate_samples(TRAIN_SEEDS, RenderConfig(hw=(192, 256)), n_people_range=(1, 5),
                          device=dev)
    data_s = time.perf_counter() - t0
    cfg = script_module("torch_train_posenet").build_model_cfg()
    net = init_posenet(cfg, torch.Generator().manual_seed(0)).to(dev)
    sched = warmup_cosine_decay_schedule(0.0, TRAIN_LR, min(300, TRAIN_STEPS // 10),
                                         TRAIN_STEPS, TRAIN_LR * 0.02)
    step = make_train_step(cfg, net, AdamW(net.parameters(), sched))
    data = [torch.as_tensor(a, device=dev) for a in (ss.images, ss.heat_tgt, ss.off_tgt,
                                                      ss.off_mask)]
    gen = torch.Generator(device=dev).manual_seed(1)
    N = data[0].shape[0]

    def one():
        idx = torch.randint(0, N, (TRAIN_BATCH,), generator=gen, device=dev)
        return step(*(d[idx] for d in data))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [one() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = torch.stack(losses).cpu().tolist()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILE_STEPS):
            one()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    n_params = sum(p.numel() for p in net.parameters())
    sample_bytes = sum(d[0].numel() * d.element_size() for d in data)
    bound, ops, n_bytes = train_step_bound(cfg, TRAIN_BATCH, n_params, sample_bytes)
    first = statistics.mean(losses[:10])
    last = statistics.mean(losses[-10:])
    dev_ms = busy_ms / TRAIN_PROFILE_STEPS if kernels else None
    emit({"phase": "train", "samples": N, "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
          "lr": TRAIN_LR, "data_s": data_s, "train_s": train_s,
          "steps_per_s": TRAIN_STEPS / train_s, "images_per_s": TRAIN_STEPS * TRAIN_BATCH / train_s,
          "profile_steps": TRAIN_PROFILE_STEPS, "wall_ms_per_step": prof_wall_ms
          / TRAIN_PROFILE_STEPS,
          "device_ms_per_step": dev_ms,
          "launches_per_step": len(kernels) / TRAIN_PROFILE_STEPS if kernels else None,
          "idle_share": 1.0 - busy_ms / prof_wall_ms if kernels else None,
          "bound_ms": bound, "bound_gflop": ops / 1e9, "bound_mb": n_bytes / 1e6,
          "params": n_params, "first_loss": losses[0], "last_loss": losses[-1],
          "first10_mean": first, "last10_mean": last, "loss_gate": TRAIN_LOSS_GATE,
          "losses_every_50": losses[::50]})
    if not (kernels and all(math.isfinite(x) for x in losses) and last < TRAIN_LOSS_GATE * first):
        raise AssertionError("the training loss did not fall")


def appearance_train_run(torch, dev) -> dict:
    """scripts/train_appearance.py's training on APPEARANCE_TRAIN's scenes,
    descriptors on `dev`: the held-out raw gap, the best held-out gap of the
    trained head and its iteration."""
    from multiview_motion_capture_torch.data.appearance_train import descriptor_batch
    from multiview_motion_capture_torch.models.appearance_net import cosine_gap

    A = APPEARANCE_TRAIN
    script = script_module("torch_train_appearance")
    t0 = time.perf_counter()
    embs, labels = descriptor_batch(seed=A["seed"], n_scenes=A["n_scenes"],
                                    n_frames=A["n_frames"], device=dev)
    ve, vl = descriptor_batch(seed=A["seed"] + script.VAL_SEED_OFFSET, n_scenes=A["val_scenes"],
                              n_frames=A["n_frames"], device=dev)
    render_s = time.perf_counter() - t0
    s, d = cosine_gap(torch.as_tensor(ve), torch.as_tensor(vl))
    t0 = time.perf_counter()
    _, gap, best_it, loss = script.train_head(embs, labels, ve, vl, A["iters"], A["lr"],
                                              A["weight_decay"], A["tau"], A["seed"], dev,
                                              log=lambda m: None)
    return {"n_train": int(len(labels)), "n_val": int(len(vl)), "raw_gap": float(s - d),
            "gap": gap, "best_iter": best_it, "last_loss": loss, "render_s": render_s,
            "train_s": time.perf_counter() - t0}


def phase_appearance_train(torch, dev):
    """The appearance head trained on the card (APPEARANCE_TRAIN): the
    held-out gap above APPEARANCE_GAP_MIN and APPEARANCE_GAP_OVER_RAW above
    the raw descriptors' (tests/test_appearance.py:407-408), and within
    APPEARANCE_GAP_TOL of the JAX package's on the same data."""
    r = appearance_train_run(torch, dev)
    ref = APPEARANCE_TRAIN_REFERENCE
    emit({"phase": "appearance_train", **APPEARANCE_TRAIN, **r, "reference": ref,
          "gap_tol": APPEARANCE_GAP_TOL})
    if not (r["gap"] > APPEARANCE_GAP_MIN and r["gap"] > r["raw_gap"] + APPEARANCE_GAP_OVER_RAW
            and abs(r["gap"] - ref["gap"]) <= APPEARANCE_GAP_TOL):
        raise AssertionError("the trained appearance head misses its gates")


def cli_subprocess(args, timeout=900):
    """`python -m multiview_motion_capture_torch ARGS` in a child process
    from the root of the checkout (runpy runs the package's `__main__` as
    `-m` does), then its kernels' launch counts, printed also when the mode
    exits non-zero: (exit code, stdout lines, stderr, launches, wall
    seconds)."""
    code = ("import json, runpy, sys\n"
            "from multiview_motion_capture_torch.ops import cuda_lib\n"
            f"sys.argv = ['multiview_motion_capture_torch'] + {list(args)!r}\n"
            "try:\n"
            "    runpy.run_module('multiview_motion_capture_torch', run_name='__main__',"
            " alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    if e.code:\n"
            "        raise\n"
            "finally:\n"
            "    print('LAUNCHES ' + json.dumps({k.name: k.launches\n"
            "                                     for k in cuda_lib.ALL_KERNELS}), flush=True)\n")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = r.stdout.splitlines()
    launches = next((json.loads(ln[len("LAUNCHES "):]) for ln in lines
                     if ln.startswith("LAUNCHES ")), None)
    return r.returncode, [ln for ln in lines if not ln.startswith("LAUNCHES ")], r.stderr, \
        launches, wall


@contextlib.contextmanager
def recording_associate():
    """Keep each frame's association matrix (x_bin) of the tracker steps run
    inside the block, in call order."""
    from multiview_motion_capture_torch import tracker

    associate, calls = tracker.associate, []

    def recording(*args, **kwargs):
        a = associate(*args, **kwargs)
        calls.append(a.x_bin)
        return a

    tracker.associate = recording
    try:
        yield calls
    finally:
        tracker.associate = associate


def tracklets_equal(a, b) -> bool:
    """Two tracklet lists equal field by field, bit for bit."""
    import numpy as np

    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.track_id != y.track_id or list(x.frame_idxs) != list(y.frame_idxs):
            return False
        for f in ("roots", "eulers", "side_lens", "poses_3d", "poses_score", "matched_pose",
                  "app"):
            u, v = getattr(x, f), getattr(y, f)
            if (u is None) != (v is None) or (u is not None and not np.array_equal(u, v)):
                return False
    return True


def cli_args(**kw):
    """The CLI's common flags at their defaults, as `_config` reads them."""
    import argparse

    base = dict(max_frames=300, max_people=10, max_tracks=16, min_track_len=1,
                preset="default")
    base.update(kw)
    return argparse.Namespace(**base)


def phase_cli(torch, dev, seq):
    """The CLI as a user runs it, on the card (no --cpu): the default
    preset's scene cut to CLI_FRAMES frames, written as calibration and
    OpenPose files; `prepare` (its npz equal to `load_openpose_dir`), then
    `run --frames_npz --bvh --reid --crossings --debug_dump` (B1 at N = 66,
    rank 32; the dump's replay and its B1 solves with X).  Held: the
    tracklets pickle bit-equal to an in-process `pipeline.run(reid=True,
    crossings=True)` of the same files, each BVH replayed on the card by
    `fk_generic.animate_bvh` within BVH_MEAN_ERR_M of its tracklet, and
    the dump's x_bin at each dumped frame equal to the association matrix
    the in-process run's step used at that frame."""
    import tempfile

    import numpy as np

    from multiview_motion_capture_torch import __main__ as cli
    from multiview_motion_capture_torch import pipeline
    from multiview_motion_capture_torch.cameras import CameraBank
    from multiview_motion_capture_torch.data.ingest import load_frame_batch, load_openpose_dir
    from multiview_motion_capture_torch.ops.fk_generic import animate_bvh
    from multiview_motion_capture_torch.utils.bvh import read_bvh

    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = Path(tmp)
        write_scene_files(seq, root, CLI_FRAMES)
        t0 = time.perf_counter()
        prep = subprocess.run(
            [sys.executable, "-m", "multiview_motion_capture_torch", "prepare",
             "--kps_dir", str(root / "kps"), "--out", str(root / "frames.npz"),
             "--max_frames", str(CLI_FRAMES)],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        prepare_s = time.perf_counter() - t0
        if prep.returncode != 0:
            raise AssertionError(f"prepare failed:\n{prep.stderr[-3000:]}")
        code, lines, err, launches, run_s = cli_subprocess(
            ["run", "--frames_npz", str(root / "frames.npz"), "--calib_dir",
             str(root / "calibs"), "--out_dir", str(root / "out"), "--bvh", "--reid",
             "--crossings", "--debug_dump", str(root / "dbg"), "--max_frames",
             str(CLI_FRAMES)])
        if code != 0:
            raise AssertionError(f"run failed:\n{err[-3000:]}")
        line = json.loads(lines[-1])

        cfg = cli._config(cli_args(max_frames=CLI_FRAMES), n_views=seq.batch.n_views)
        cams = CameraBank.from_json_dir(root / "calibs")
        batch = load_openpose_dir(root / "kps", cfg, max_frames=CLI_FRAMES)
        npz = load_frame_batch(root / "frames.npz")
        prepare_equal = (np.array_equal(npz.kps, batch.kps)
                         and np.array_equal(npz.valid, batch.valid))
        with recording_associate() as steps:
            res = pipeline.run(batch, cams, cfg, reid=True, crossings=True, device=dev)
        steps = [x.cpu().numpy() for x in steps[-res.n_frames:]]   # the timed pass
        got = pipeline.load_tracklets(root / "out" / "tracklets.pkl")
        same = tracklets_equal(got, res.tracklets)

        bvh_err = {}
        for t in got:
            data = read_bvh(root / "out" / f"track_{t.track_id:03d}.bvh")
            pos = animate_bvh(data, device=dev).cpu().numpy() / 100.0   # cm -> m
            bvh_err[t.track_id] = float(np.linalg.norm(pos - t.poses_3d, axis=-1).mean())
        dumped = sorted((root / "dbg").glob("frame_*.npz"))
        dump_equal = {}
        for p in dumped:
            f = int(p.stem.split("_")[1])
            with np.load(p) as d:
                dump_equal[f] = bool(np.array_equal(d["x_bin"], steps[f]))
                has_x = "x" in d.files and "margin" in d.files
    out = {"phase": "cli", "frames": CLI_FRAMES, "cli_line": line, "prepare_s": prepare_s,
           "run_s": run_s, "prepare_equal_load_openpose_dir": prepare_equal,
           "tracklets_equal_in_process": same, "in_process_fps": res.fps,
           "bvh_mean_err_m": bvh_err, "bvh_tol_m": BVH_MEAN_ERR_M,
           "dumped_frames": sorted(dump_equal), "dump_x_bin_equal_step": dump_equal,
           "launches": launches}
    emit(out)
    if not (prepare_equal and same and line["n_tracklets"] == len(got) > 0):
        raise AssertionError("the CLI's outputs differ from the library's")
    if not (bvh_err and max(bvh_err.values()) < BVH_MEAN_ERR_M):
        raise AssertionError("an exported BVH does not replay its tracklet")
    if not (dump_equal and all(dump_equal.values()) and has_x):
        raise AssertionError("the debug dump misses the step's association")
    if not launches["als"] > 0:
        raise AssertionError("the CLI run launched no ALS kernel")
    return launches


def phase_detect_cli(torch, dev, frames):
    """`detect` under the CLI (`__main__.detect_frames`, the CLI's code
    after its cv2 image reading) on the card with --appearance --crossings,
    on the detect scene's first DETECT_CLI_FRAMES frames as the CLI reads
    them (f32 RGB in [0, 1]); its tracklets bit-equal to the library path
    the `detect` phase drives (`frames_to_frame_batch` + `pipeline.run`) on
    the same frames and the CLI's config."""
    import dataclasses as dc
    import tempfile

    import numpy as np

    from examples.torch_e2e_fullframe import scaled_cameras
    from multiview_motion_capture_torch import __main__ as cli
    from multiview_motion_capture_torch import pipeline
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.detect import (
        frames_to_frame_batch,
        make_bottom_up_detector,
    )
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
    from multiview_motion_capture_torch.models.checkpoint import (
        load_appearance_head,
        load_posenet,
    )

    seq = synthetic_sequence(cfg=PipelineConfig(**DETECT_CFG), **DETECT_SCENE)
    cams = scaled_cameras(seq.cameras, DETECT_RENDER["world_scale"])
    images = frames[:DETECT_CLI_FRAMES].astype(np.float32) / 255.0
    cfg = cli._config(cli_args(), n_views=cams.n_views)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        zero_launch_counts()
        line = cli.detect_frames(images, cams, cfg, Path(tmp), appearance=True,
                                 crossings=True, device=dev)
        launches = launch_counts()
        got = pipeline.load_tracklets(Path(tmp) / "tracklets.pkl")

    mcfg, net = load_posenet(CHECKPOINTS / "posenet_synth.npz", device=dev)
    _, head = load_appearance_head(CHECKPOINTS / "appearance_head.npz", device=dev)
    detect = make_bottom_up_detector(mcfg, max_people=cfg.max_people,
                                     center_nms_window=cfg.detect_nms_window,
                                     return_appearance=True, appearance_head=head)
    batch, app = frames_to_frame_batch(detect, net, images, cfg, collect_appearance=True)
    rcfg = dc.replace(cfg, appearance_dim=app.shape[-1], appearance_gain_px=60.0)
    ref = pipeline.run(batch, cams, rcfg, use_ik=True, app=app, crossings=True, device=dev)
    same = tracklets_equal(got, ref.tracklets)
    emit({"phase": "detect_cli", "frames": DETECT_CLI_FRAMES, "cli_line": line,
          "tracklets_equal_library": same,
          "top_lengths": sorted((len(t) for t in got), reverse=True)[:8],
          "launches": launches})
    if not (same and got and launches["als"] > 0):
        raise AssertionError("the CLI's detect differs from the library path")
    return launches


def phase_debug_clustered(torch, dev):
    """`debug.dump_association_debug` on the clustered rig of
    tests/test_debug_dump.py:76 (8 views, 2 clusters): on the card its
    replay launches B3 and its frames B1 with X, one call per cluster;
    held against the same dump with device="cpu": the files, the groups
    and x_bin on the solved elements equal, sims within DEBUG_SIM_TOL, X
    on the solved elements within DEBUG_X_TOL."""
    import tempfile

    import numpy as np

    from multiview_motion_capture_torch import tracker
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
    from multiview_motion_capture_torch.debug import dump_association_debug, replay_states

    cfg = PipelineConfig(n_views=8, max_people=4, max_tracks=6, als_max_iter=100,
                         assoc_clusters=2)
    seq = synthetic_sequence(n_frames=10, n_people=2, n_views=8, cfg=cfg, seed=3,
                             drop_prob=0.15)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        dumps = {}
        for d in (dev, "cpu"):
            ctx = tracker.TrackerContext.build(seq.cameras, cfg, device=d)
            zero_launch_counts()
            t0 = time.perf_counter()
            paths = dump_association_debug(ctx, seq.batch.kps, seq.batch.valid,
                                           Path(tmp) / d, frames=DEBUG_CLUSTERED_FRAMES)
            wall = time.perf_counter() - t0
            if d == dev:
                launches, card_s = launch_counts(), wall
            dumps[d] = [dict(np.load(p)) for p in paths]
            names = sorted(p.name for p in (Path(tmp) / d).iterdir())
            dumps[d + "_files"] = names
            dumps[d + "_states"] = replay_states(ctx, seq.batch.kps, seq.batch.valid)[0]
    # where the two replays' states part, if they do
    state_diff = {}
    for fld in dataclasses.fields(dumps[dev + "_states"]):
        a = np.asarray(getattr(dumps[dev + "_states"], fld.name), dtype=np.float64)
        b = np.asarray(getattr(dumps["cpu_states"], fld.name), dtype=np.float64)
        bad = np.nonzero((a != b).reshape(a.shape[0], -1).any(1))[0]
        if len(bad):
            state_diff[fld.name] = {"first_frame": int(bad[0]),
                                    "max_abs_diff": float(np.abs(a - b).max())}
    files_equal = dumps[dev + "_files"] == dumps["cpu_files"]
    T, P = cfg.max_tracks, cfg.max_people
    diff = {"x_bin_equal": True, "x_bin_solved_equal": True, "groups_equal": True,
            "sim_max_diff": 0.0, "x_solved_max_diff": 0.0, "x_max_diff": 0.0}
    for a, b in zip(dumps[dev], dumps["cpu"]):
        files_equal &= sorted(a) == sorted(b)
        ev = a["elem_valid"]
        solved = ev[:, None] & ev[None, :]
        diff["x_bin_equal"] &= bool(np.array_equal(a["x_bin"], b["x_bin"]))
        diff["x_bin_solved_equal"] &= bool(np.array_equal(a["x_bin"][solved],
                                                          b["x_bin"][solved]))
        diff["groups_equal"] &= all(np.array_equal(a[k], b[k])
                                    for k in ("rep", "member", "group_size", "elem_valid"))
        for c in range(cfg.assoc_clusters):
            # the cluster's solved elements: live tracks and its views' detections
            vm = np.concatenate([ev[:T]] + [ev[T + v * P:T + (v + 1) * P]
                                            for v in a[f"cluster{c}_views"]])
            dx = np.abs(a[f"cluster{c}_x"] - b[f"cluster{c}_x"])
            diff["sim_max_diff"] = max(diff["sim_max_diff"], float(
                np.abs(a[f"cluster{c}_sim"] - b[f"cluster{c}_sim"]).max()))
            diff["x_solved_max_diff"] = max(diff["x_solved_max_diff"],
                                            float(dx[vm[:, None] & vm[None, :]].max()))
            diff["x_max_diff"] = max(diff["x_max_diff"], float(dx.max()))
    emit({"phase": "debug_clustered", "frames": DEBUG_CLUSTERED_FRAMES,
          "files_equal": files_equal, **diff, "sim_tol": DEBUG_SIM_TOL, "x_tol": DEBUG_X_TOL,
          "replay_state_diff": state_diff, "card_s": card_s, "launches": launches})
    if not (files_equal and diff["x_bin_solved_equal"] and diff["groups_equal"]
            and diff["sim_max_diff"] <= DEBUG_SIM_TOL
            and diff["x_solved_max_diff"] <= DEBUG_X_TOL):
        raise AssertionError("the card's association dump differs from the CPU's")
    if not (launches["als_batched"] > 0 and launches["als"] > 0):
        raise AssertionError("the clustered dump did not launch B3 and B1")
    return launches


def phase_alt(torch, dev, seq, cfg):
    """The side solvers on the card against the CPU: `match_svt` (its SVD
    cuSOLVER's on the card, LAPACK's on the CPU) on two seeded problems,
    x_bin and iterations equal; `associate_frame` (B1) on the default
    scene's first frames, groups equal."""
    import numpy as np

    from multiview_motion_capture_torch.data.ingest import filter_bad_poses
    from multiview_motion_capture_torch.ops import association, association_alt

    svt = []
    for name, seed, sizes, people in (("shelf_layout", 0, (8, 6, 6, 6, 6, 6), 8),
                                      ("default_layout", 2, (16,) + (10,) * 5, 16)):
        W = als_problem(seed, sizes, people)
        mask = association.block_diag_mask(sizes)
        r = {}
        for d in (dev, "cpu"):
            t0 = time.perf_counter()
            xb, it = association_alt.match_svt(torch.as_tensor(W, device=d),
                                               torch.as_tensor(mask, device=d), sizes)
            r[d] = (xb.cpu().numpy(), int(it), time.perf_counter() - t0)
        svt.append({"case": name, "n": W.shape[0], "iters": [r[dev][1], r["cpu"][1]],
                    "x_bin_equal": bool(np.array_equal(r[dev][0], r["cpu"][0])),
                    "card_s": r[dev][2]})
    b = filter_bad_poses(seq.batch, cfg)
    frames = []
    for f in (0, 1, 2):
        g = {d: association.associate_frame(b.kps[f], b.valid[f], seq.cameras, cfg, device=d)
             for d in (dev, "cpu")}
        frames.append({"frame": f, "groups": len(g[dev]), "groups_equal": g[dev] == g["cpu"]})
    emit({"phase": "alt", "match_svt": svt, "associate_frame": frames})
    if not all(c["x_bin_equal"] and c["iters"][0] == c["iters"][1] for c in svt):
        raise AssertionError("match_svt differs between the card and the CPU")
    if not all(fr["groups_equal"] and fr["groups"] > 0 for fr in frames):
        raise AssertionError("associate_frame differs between the card and the CPU")


# ---------------------------------------------------------------------------
# multi-device paths (parallel/), on meshes that repeat cuda:0
# ---------------------------------------------------------------------------

MESH_WIDE_CLUSTERS = 2            # cluster mesh of the wide rig: one cluster a device
MESH_TRACKS = 4                   # track mesh: 16 slots, 4 a device
MESH_CAMERAS = 4                  # camera mesh of the 32-camera rig: 8 cameras a device
MESH_CAMERAS_FRAMES = 30
MESH_FUSED_FRAMES = 10
MESH_POSE_TOL_M = 1e-5
# 15 frames a stream (cut for the run's time): four host loops under one GIL
# run ~4x slower than one
STREAMS = dict(n_streams=4, seeds=[0, 1, 2, 3], n_frames=15)
MESH_TRAIN = dict(batch=16, steps=2, timed_steps=5, lr=1e-3, seed=0)
MESH_TRAIN_LOSS_RTOL = 1e-5
MESH_TRAIN_GRAD_TOL = 1e-5        # of each leaf's largest magnitude
MESH_TRAIN_AT_EPS_LR = 0.01       # a weight this many lr apart had a gradient near eps


def repeated(torch, dev, n):
    return [torch.device(dev)] * n


def timed_run_offline(torch, ctx, kps, valid):
    """One `run_offline` pass, synchronised, with each frame's association
    x_bin kept: (outputs on the host, x_bins, seconds)."""
    from multiview_motion_capture_torch import tracker

    with recording_associate() as xbins:
        t0 = time.perf_counter()
        _, o = tracker.run_offline(ctx, kps, valid)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return tracker.outputs_to_numpy(o), [x.cpu() for x in xbins], secs


def compare_runs(torch, plain, sharded) -> dict:
    """Two runs' per-frame outputs and x_bins: decisions, x_bin and poses."""
    import numpy as np

    (po, px, _), (so, sx, _) = plain, sharded
    first_diff = {}
    for f in DECISIONS:
        bad = np.nonzero((getattr(po, f) != getattr(so, f)).reshape(len(px), -1).any(1))[0]
        if len(bad):
            first_diff[f] = int(bad[0])
    xbin_frames = [i for i, (a, b) in enumerate(zip(px, sx)) if not torch.equal(a, b)]
    upd = po.updated & so.updated
    pose = float(np.abs(po.pose3d - so.pose3d).max(-1)[upd].max()) if upd.any() else 0.0
    return {"decisions_equal": not first_diff, "first_diverging_frame": first_diff,
            "x_bin_equal": not xbin_frames, "x_bin_differing_frames": xbin_frames[:10],
            "max_pose_diff_m": pose,
            "outputs_bit_equal": all(np.array_equal(a, b) for a, b in zip(po, so))}


def structure(tracklets):
    import numpy as np

    return [(t.track_id, list(t.frame_idxs), np.asarray(t.matched_pose).tolist())
            for t in tracklets]


def phase_mesh_wide(torch, dev, seq, cfg, wide_res, wide_run):
    """The wide rig with its two cluster ALS problems on a cluster mesh of
    MESH_WIDE_CLUSTERS entries (one B3 launch a device) and its 16 LM slots
    on a track mesh of MESH_TRACKS (B2 on each), every entry cuda:0:
    x_bin, decisions and tracklets bit-equal to the `wide` phase's
    unsharded run (its per-frame outputs and x_bins, its tracklets), poses
    within MESH_POSE_TOL_M; frames/s beside the `wide` phase's.  Then MESH_FUSED_FRAMES frames under "gj_fused" (B4
    on each track-mesh entry) against the unsharded "gj_fused" run."""
    from multiview_motion_capture_torch import pipeline, tracker
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses
    from multiview_motion_capture_torch.parallel.sharded_solvers import (
        make_cluster_mesh,
        make_track_mesh,
    )

    meshes = dict(cluster_mesh=make_cluster_mesh(MESH_WIDE_CLUSTERS,
                                                 devices=repeated(torch, dev, MESH_WIDE_CLUSTERS)),
                  ik_mesh=make_track_mesh(MESH_TRACKS, devices=repeated(torch, dev, MESH_TRACKS)))
    b = filter_bad_poses(seq.batch, cfg)
    kps, valid = torch.as_tensor(b.kps, device=dev), torch.as_tensor(b.valid, device=dev)
    plain = (*wide_run, None)
    ctx = tracker.TrackerContext.build(seq.cameras, cfg, device=dev, **meshes)
    zero_launch_counts()
    sharded = timed_run_offline(torch, ctx, kps, valid)
    launches = launch_counts()
    cmp = compare_runs(torch, plain, sharded)
    tl = pipeline.filter_ghost_tracklets(tracker.assemble_tracklets(sharded[0]),
                                         cfg.min_track_length)
    same_tracklets = structure(tl) == structure(wide_res.tracklets)
    n = kps.shape[0]

    fcfg = dataclasses.replace(cfg, ik_solver="gj_fused")
    fk, fv = kps[:MESH_FUSED_FRAMES], valid[:MESH_FUSED_FRAMES]
    fplain = timed_run_offline(torch, tracker.TrackerContext.build(seq.cameras, fcfg,
                                                                   device=dev), fk, fv)
    fctx = tracker.TrackerContext.build(seq.cameras, fcfg, device=dev, **meshes)
    zero_launch_counts()
    fsharded = timed_run_offline(torch, fctx, fk, fv)
    fused_launches = launch_counts()
    fcmp = compare_runs(torch, fplain, fsharded)
    emit({"phase": "mesh_wide", "frames": n, "cluster_mesh": MESH_WIDE_CLUSTERS,
          "track_mesh": MESH_TRACKS, "devices": str(dev),
          "fps": n / sharded[2], "unsharded_fps_wide_phase": wide_res.fps, **cmp,
          "pose_tol_m": MESH_POSE_TOL_M, "tracklets_equal_wide_phase": same_tracklets,
          "launches": launches, "launches_per_frame": {k: v / n for k, v in launches.items()},
          "gj_fused": {"frames": MESH_FUSED_FRAMES, **fcmp, "launches": fused_launches,
                       "fps": MESH_FUSED_FRAMES / fsharded[2],
                       "unsharded_fps": MESH_FUSED_FRAMES / fplain[2]}})
    if not (cmp["decisions_equal"] and cmp["x_bin_equal"] and same_tracklets
            and cmp["max_pose_diff_m"] <= MESH_POSE_TOL_M):
        raise AssertionError("the cluster- and track-sharded wide run differs from the unsharded")
    if launches["als_batched"] != MESH_WIDE_CLUSTERS * n or launches["gj_solve"] == 0:
        raise AssertionError("B3 must launch once a frame on each cluster-mesh entry, B2 run")
    if not (fcmp["decisions_equal"] and fcmp["x_bin_equal"]
            and fcmp["max_pose_diff_m"] <= MESH_POSE_TOL_M and fused_launches["fused_normal_gj"]):
        raise AssertionError("the track-sharded gj_fused run differs or launched no B4")
    return launches, fused_launches


def phase_mesh_cameras(torch, dev):
    """PipelineConfig.wide(32) (one cluster: B1 at N 336) on the wide scene
    at 32 cameras, the similarity blocks camera-sharded over MESH_CAMERAS
    entries and the LM over MESH_TRACKS, every entry cuda:0, against the
    unsharded run on the card: x_bin, decisions and the similarity blocks
    of frame 0 bit-equal; frames/s of both."""
    from multiview_motion_capture_torch import tracker
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
    from multiview_motion_capture_torch.parallel.sharded_solvers import (
        make_axis_mesh,
        make_track_mesh,
    )

    cfg = PipelineConfig.wide(32, max_frames=None)
    seq = synthetic_sequence(cfg=cfg, **dict(WIDE_SCENE, n_views=32,
                                             n_frames=MESH_CAMERAS_FRAMES))
    b = filter_bad_poses(seq.batch, cfg)
    kps, valid = torch.as_tensor(b.kps, device=dev), torch.as_tensor(b.valid, device=dev)
    pctx = tracker.TrackerContext.build(seq.cameras, cfg, device=dev)
    ctx = tracker.TrackerContext.build(
        seq.cameras, cfg, device=dev,
        mesh=make_axis_mesh(MESH_CAMERAS, "dp", devices=repeated(torch, dev, MESH_CAMERAS)),
        ik_mesh=make_track_mesh(MESH_TRACKS, devices=repeated(torch, dev, MESH_TRACKS)))
    state0 = tracker.TrackerState.zeros(cfg, device=dev)
    blocks = {}
    for name, fn in (("spatial", lambda c: tracker._spatial_similarity(c, kps[0], valid[0])[0]),
                     ("spatial_time", lambda c: tracker._spatial_time_similarity(
                         c, state0, kps[0], valid[0])[0])):
        blocks[name] = torch.equal(fn(pctx), fn(ctx))
    plain = timed_run_offline(torch, pctx, kps, valid)
    zero_launch_counts()
    sharded = timed_run_offline(torch, ctx, kps, valid)
    launches = launch_counts()
    cmp = compare_runs(torch, plain, sharded)
    n = kps.shape[0]
    emit({"phase": "mesh_cameras", "frames": n, "n_views": 32, "n_matrix": cfg.n_matrix,
          "camera_mesh": MESH_CAMERAS, "track_mesh": MESH_TRACKS, "devices": str(dev),
          "fps": n / sharded[2], "unsharded_fps": n / plain[2],
          "frame0_similarity_bit_equal": blocks, **cmp, "pose_tol_m": MESH_POSE_TOL_M,
          "als_iters_at_cap_frames": int((sharded[0].als_iters >= cfg.als_max_iter).sum()),
          "launches": launches, "b1_launches_at_n336": launches["als"]})
    if not (all(blocks.values()) and cmp["decisions_equal"] and cmp["x_bin_equal"]
            and cmp["max_pose_diff_m"] <= MESH_POSE_TOL_M):
        raise AssertionError("the camera-sharded run differs from the unsharded")
    if cfg.n_matrix != 336 or launches["als"] != n or launches["gj_solve"] == 0:
        raise AssertionError("B1 must launch once a frame at N 336, B2 run")
    return launches


def phase_mesh_spec(torch, dev, seq, cfg, slice_res):
    """`pipeline.run(mesh_spec=...)` through the visible-device route on the
    SHELF_BENCH scene: a camera mesh and a track mesh of one card each, its
    tracklets bit-equal to the `slice` phase's.  A cluster mesh needs
    camera clusters, which SHELF_BENCH has not (JAX's error); a spec wider
    than the visible cards raises JAX's "only N devices visible"."""
    from multiview_motion_capture_torch import pipeline

    spec = "cameras=1,tracks=1"
    zero_launch_counts()
    res = pipeline.run(seq.batch, seq.cameras, cfg, mesh_spec=spec, device=dev)
    launches = launch_counts()
    equal = tracklets_equal(res.tracklets, slice_res.tracklets)
    want = {"cameras=1,clusters=1,tracks=1": "cluster_mesh needs assoc_clusters > 1"}
    if torch.cuda.device_count() == 1:
        want["tracks=2"] = "MeshSpec.tracks=2 but only 1 devices visible"
    errors = {}
    for bad in want:
        try:
            pipeline.run(seq.batch, seq.cameras, cfg, mesh_spec=bad, device=dev)
        except ValueError as e:
            errors[bad] = str(e)
    emit({"phase": "mesh_spec", "spec": spec, "frames": res.n_frames, "fps": res.fps,
          "tracklets_bit_equal_slice": equal, "errors": errors, "launches": launches})
    if not equal:
        raise AssertionError("pipeline.run(mesh_spec=) differs from the slice run")
    if errors != want:
        raise AssertionError(f"mesh spec errors differ from the JAX package's: {errors}")
    if launches["als"] == 0 or launches["gj_solve"] == 0:
        raise AssertionError("mesh_spec launched no B1 or B2")
    return launches


def phase_streams(torch, dev):
    """STREAMS SHELF_BENCH streams (the SCENE's rig at seeds 0-3) over a
    streams mesh of as many cuda:0 entries, one worker thread and CUDA
    stream each: each stream bit-equal to `run_offline` on it alone; the
    aggregate frames/s beside one stream's (host-bound under the GIL on one
    card: no gain is expected)."""
    import numpy as np

    from multiview_motion_capture_torch import tracker
    from multiview_motion_capture_torch.config import SHELF_BENCH
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
    from multiview_motion_capture_torch.parallel.streams import (
        assemble_stream_tracklets,
        make_streams_mesh,
        run_offline_streams,
    )

    cfg = dataclasses.replace(SHELF_BENCH, max_frames=None)
    seqs = [synthetic_sequence(cfg=cfg, **dict(SCENE, n_frames=STREAMS["n_frames"], seed=s))
            for s in STREAMS["seeds"]]
    bs = [filter_bad_poses(s.batch, cfg) for s in seqs]
    kps = np.stack([b.kps for b in bs])
    valid = np.stack([b.valid for b in bs])
    ctx = tracker.TrackerContext.build(seqs[0].cameras, cfg, device=dev)
    refs, one_s = [], []
    for b in bs:
        t0 = time.perf_counter()
        _, o = tracker.run_offline(ctx, b.kps, b.valid)
        torch.cuda.synchronize()
        one_s.append(time.perf_counter() - t0)
        refs.append(tracker.outputs_to_numpy(o))
    mesh = make_streams_mesh(STREAMS["n_streams"],
                             devices=repeated(torch, dev, STREAMS["n_streams"]))
    zero_launch_counts()
    t0 = time.perf_counter()
    _, out = run_offline_streams(ctx, kps, valid, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    out_np = tracker.outputs_to_numpy(out)
    equal = [all(np.array_equal(getattr(out_np, f)[i], getattr(r, f))
                 for f in tracker.FrameOutput._fields) for i, r in enumerate(refs)]
    per_stream = assemble_stream_tracklets(out)
    F = STREAMS["n_frames"]
    emit({"phase": "streams", "streams": len(seqs), "frames_each": F, "devices": str(dev),
          "aggregate_fps": len(seqs) * F / wall, "one_stream_fps": F / statistics.median(one_s),
          "streams_bit_equal_run_offline": equal,
          "tracklets_per_stream": [len(t) for t in per_stream], "launches": launches})
    if not all(equal):
        raise AssertionError("a stream differs from run_offline on it alone")
    if launches["als"] != len(seqs) * F or launches["gj_solve"] == 0:
        raise AssertionError("the streams launched B1 other than once a frame, or no B2")
    return launches


def mesh_train_run(torch, dev, mesh, cfg, images, kps, mask, net0, steps):
    """`steps` sharded steps from `net0`'s weights: (losses, per-step
    gradients and the final parameters, gathered, on the host)."""
    from multiview_motion_capture_torch.parallel.train import sharded_train_step

    step, params, opt, data = sharded_train_step(mesh, cfg, lr=MESH_TRAIN["lr"])
    params.load_module(net0)
    losses, grads = [], []
    for _ in range(steps):
        _, _, loss = step(params, opt, images, kps, mask)
        losses.append(float(loss))
        grads.append({k: v.cpu() for k, v in params.gather(grads=True).items()})
    return losses, grads, {k: v.cpu() for k, v in params.gather().items()}, (step, params, opt)


def phase_mesh_train(torch, dev):
    """`parallel.sharded_train_step` on PoseNetConfig() in f32 compute,
    batch 16, at (dp, tp) = (2, 2) over four cuda:0 entries and at (1, 1),
    against the port's unsharded `train_step` from the same weights over
    MESH_TRAIN steps: losses within MESH_TRAIN_LOSS_RTOL relative, each
    step's gradients within MESH_TRAIN_GRAD_TOL of each leaf's largest
    magnitude at the first step (from the same parameters; later steps'
    gradients are printed: they are taken at parameters Adam has already
    moved apart where a gradient sat at eps), parameters within 1 lr a step
    (the entries more than MESH_TRAIN_AT_EPS_LR lr apart are counted);
    (1, 1) bit-equal to the unsharded step; two (2, 2)
    runs bit-equal; steps/s of each in the default bf16 compute."""
    from multiview_motion_capture_torch.models.optim import AdamW
    from multiview_motion_capture_torch.models.pose_net import (
        PoseNetConfig,
        gaussian_heatmaps,
        init_posenet,
        train_step,
    )
    from multiview_motion_capture_torch.parallel.mesh import Mesh

    B, steps, lr = MESH_TRAIN["batch"], MESH_TRAIN["steps"], MESH_TRAIN["lr"]
    cfg = dataclasses.replace(PoseNetConfig(), compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(MESH_TRAIN["seed"])
    H, W = cfg.img_hw
    Hh, Wh = cfg.heatmap_hw
    images = torch.rand(B, H, W, 3, generator=g).to(dev)
    kps = (torch.rand(B, 17, 2, generator=g) * torch.tensor([Wh, Hh])).to(dev)
    mask = (torch.rand(B, 17, generator=g) > 0.2).float().to(dev)
    net0 = init_posenet(cfg, torch.Generator().manual_seed(1))

    net = init_posenet(cfg, torch.Generator().manual_seed(1)).to(dev)
    opt = AdamW(net.parameters(), lr)
    target = gaussian_heatmaps(kps, cfg.heatmap_hw)
    ref_losses, ref_grads = [], []
    for _ in range(steps):
        ref_losses.append(float(train_step(net, opt, images, target, mask)))
        ref_grads.append({k: p.grad.cpu() for k, p in net.named_parameters()})
    ref_params = {k: p.detach().cpu() for k, p in net.named_parameters()}

    out, runs = {}, {}
    d = torch.device(dev)
    meshes = {"2x2": Mesh([[d, d], [d, d]], ("dp", "tp")), "1x1": Mesh([[d]], ("dp", "tp"))}
    for name, mesh in meshes.items():
        losses, grads, params, _ = runs[name] = mesh_train_run(torch, dev, mesh, cfg, images,
                                                               kps, mask, net0, steps)
        loss_rel = max(abs(a / b - 1.0) for a, b in zip(losses, ref_losses))
        grad_rel = [max(float((gs[k] - gr[k]).abs().max()
                              / gr[k].abs().max().clamp(min=1e-30)) for k in gr)
                    for gs, gr in zip(grads, ref_grads)]
        p_lr = {k: (params[k] - ref_params[k]).abs() / lr for k in ref_params}
        out[name] = {
            "mesh": dict(mesh.shape), "losses": losses, "max_loss_rel_diff": loss_rel,
            "max_grad_diff_of_leaf_max_by_step": grad_rel,
            "max_param_diff_lr": max(float(v.max()) for v in p_lr.values()),
            "entries_over_at_eps_lr": int(sum(int((v > MESH_TRAIN_AT_EPS_LR).sum())
                                              for v in p_lr.values())),
            "bit_equal_unsharded": (losses == ref_losses and all(
                torch.equal(params[k], ref_params[k]) for k in ref_params))}
    again = mesh_train_run(torch, dev, meshes["2x2"], cfg, images, kps, mask, net0, steps)
    first = runs["2x2"]
    out["2x2"]["two_runs_bit_equal"] = (again[0] == first[0] and all(
        torch.equal(again[2][k], v) for k, v in first[2].items()))

    # steps/s in the default bf16 compute, the host clock around a
    # synchronised loop of MESH_TRAIN["timed_steps"] steps after one warm step
    bcfg = PoseNetConfig()
    rates = {}
    for name, mesh in meshes.items():
        _, _, _, (step, params, opt) = mesh_train_run(torch, dev, mesh, bcfg, images, kps,
                                                      mask, init_posenet(bcfg, torch.Generator()
                                                                         .manual_seed(1)), 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_TRAIN["timed_steps"]):
            step(params, opt, images, kps, mask)
        torch.cuda.synchronize()
        rates[name] = MESH_TRAIN["timed_steps"] / (time.perf_counter() - t0)
    bnet = init_posenet(bcfg, torch.Generator().manual_seed(1)).to(dev)
    bopt = AdamW(bnet.parameters(), lr)
    train_step(bnet, bopt, images, target, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_TRAIN["timed_steps"]):
        train_step(bnet, bopt, images, target, mask)
    torch.cuda.synchronize()
    rates["unsharded"] = MESH_TRAIN["timed_steps"] / (time.perf_counter() - t0)
    emit({"phase": "mesh_train", "batch": B, "steps": steps, "lr": lr,
          "unsharded_losses": ref_losses, **out, "steps_per_s_bf16": rates,
          "loss_rtol": MESH_TRAIN_LOSS_RTOL, "grad_tol_of_leaf_max": MESH_TRAIN_GRAD_TOL})
    s = out["2x2"]
    if not (s["max_loss_rel_diff"] <= MESH_TRAIN_LOSS_RTOL
            and s["max_grad_diff_of_leaf_max_by_step"][0] <= MESH_TRAIN_GRAD_TOL
            and s["max_param_diff_lr"] <= steps and s["two_runs_bit_equal"]
            and out["1x1"]["bit_equal_unsharded"]):
        raise AssertionError("the dp x tp step is off the unsharded step")


def write_bench_files(seq, root: Path) -> None:
    """The slice's scene, all SCENE frames, as files in the Shelf dataset's
    layout (`kps_opn/`, `calibs/` with the ring's float64 values)."""
    from multiview_motion_capture_torch.cameras import camera_ring_k_rt

    write_scene_files(seq, root, SCENE["n_frames"], kps_dir="kps_opn",
                      calib=camera_ring_k_rt(SCENE["n_views"])[:2])


def phase_bench(torch, dev, seq, slice_res, root: Path):
    """The CLI's `bench` mode on the slice's scene: its SCENE frames written
    under `root` in the Shelf dataset's layout, `bench.measure` on them
    in-process (SHELF_BENCH, IK on; its gate is printed, not applied: the
    bands are Shelf's; the calibration files hold the ring's float64
    values, so they load into the scene's bank bit for bit), then `bench
    --data_dir` under the CLI in a child process on the card.  Held: the
    tracklets bit-equal to the `slice` phase's run of the same scene (the
    file round trip is exact), the quality fields of both equal to the slice's, the child's JSON line
    with bench.py's keys and the in-process gate (the child exits as
    bench.py does when the gate fails), and a missing `--data_dir`
    raising FileNotFoundError."""
    from multiview_motion_capture_torch import __main__ as cli
    from multiview_motion_capture_torch import bench

    from multiview_motion_capture_torch.cameras import CameraBank

    n = SCENE["n_frames"]
    write_bench_files(seq, root)
    cams = CameraBank.from_json_dir(root / "calibs")
    cams_equal = all(torch.equal(getattr(cams, f), getattr(seq.cameras, f))
                     for f in ("K", "Rt", "P", "Kr_inv", "cam_loc", "img_wh"))
    zero_launch_counts()
    out = bench.measure(root, max_frames=n, device=dev)
    launches = launch_counts()
    res, m = out["result"], out["metrics"]
    q_slice, _ = run_quality(slice_res.tracklets, seq, n_top=6)
    q = dict(n_tracklets=m.n_tracklets, top_lengths=m.lengths[:6],
             mean_reproj_px=m.mean_reproj_px, median_reproj_px=m.median_reproj_px,
             n_degenerate_poses=m.n_degenerate_poses)
    same = tracklets_equal(res.tracklets, slice_res.tracklets)

    code, lines, err, child_launches, child_s = cli_subprocess(
        ["bench", "--data_dir", str(root)])
    line = json.loads(next(ln for ln in reversed(lines) if ln.startswith("{")))
    ex = line["extra"]
    line_matches = (
        set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
        and line["metric"] == "shelf_e2e_fps_5cam_ik" and ex["n_frames"] == n
        and ex["n_tracklets"] == q_slice["n_tracklets"]
        and ex["top_track_lengths"] == q_slice["top_lengths"][:5]
        and ex["reproj_px_mean"] == round(q_slice["mean_reproj_px"], 2)
        and ex["reproj_px_median"] == round(q_slice["median_reproj_px"], 2)
        and ex["n_degenerate_poses"] == q_slice["n_degenerate_poses"]
        and ex["quality_ok"] == out["quality_ok"]
        and ex.get("quality_gate", out["gate"]) == out["gate"])
    exit_as_bench = (code == 0 if out["quality_ok"]
                     else code != 0 and "bench quality gate FAILED" in err)
    missing = root.parent / (root.name + "_missing")
    try:
        cli.main(["bench", "--data_dir", str(missing)])
        missing_raises = False
    except FileNotFoundError as e:
        missing_raises = str(missing) in str(e)
    emit({"phase": "bench", "frames": res.n_frames, "fps": res.fps,
          "slice_fps": slice_res.fps, "compile_s": out["compile_s"], "quality": q,
          "slice_quality": q_slice, "cameras_bit_equal_scene": cams_equal,
          "tracklets_bit_equal_slice": same,
          "quality_equal_slice": q == q_slice, "gate": out["gate"],
          "quality_ok": out["quality_ok"], "launches": launches, "cli_line": line,
          "cli_exit_code": code, "cli_exit_as_bench_py": exit_as_bench,
          "cli_line_matches": line_matches, "cli_s": child_s, "cli_launches": child_launches,
          "missing_data_dir_raises": missing_raises})
    if not (cams_equal and same and q == q_slice):
        raise AssertionError("bench's cameras or tracklets differ from the slice's")
    if not (line_matches and exit_as_bench and child_launches and child_launches["als"] > 0):
        raise AssertionError("the CLI's bench line differs from bench.measure")
    if not (launches["als"] > 0 and launches["gj_solve"] > 0 and missing_raises):
        raise AssertionError("bench launched no kernel, or a missing directory passed")
    return launches


def phase_scaled(torch, dev):
    """scripts/torch_bench_scaled.py's `bench_config` on the card for
    SCALED_FRAMES' rigs (10 cameras: B1 at N 116; 128 cameras in 4 clusters:
    B3 at C 4, N 336; in 5: B3 at C 5, N 276 with dead pad views), both
    modes, then each rig's first SCALED_PARITY_FRAMES frames in IK mode on
    the card and on the CPU: x_bin and decisions equal, poses within
    POSE_TOL_M; the card's short run equal to the first frames of
    `bench_config`'s (the step is causal); a device-only profile of
    SCALED_PROFILE's first frames.  Returns the launches of each rig's
    `bench_config` run by path name."""
    import numpy as np

    from multiview_motion_capture_torch import tracker

    bs = script_module("torch_bench_scaled")
    rigs = bs.configs(cam128=True)
    by_path, rows = {}, {}
    for name, n_frames in SCALED_FRAMES.items():
        kw = dict(rigs[name], n_frames=n_frames)
        outs = {}
        t0 = time.perf_counter()
        zero_launch_counts()
        r = bs.bench_config(device=dev, outputs=outs, **kw)
        launches = launch_counts()
        run_s = time.perf_counter() - t0
        cfg_kw = {k: v for k, v in kw.items() if k not in ("n_views", "n_people", "n_frames")}
        cfg = bs.scaled_config(kw["n_views"], kw["n_people"], **cfg_kw)
        seq = bs.scaled_scene(cfg, kw["n_people"], n_frames)
        F = SCALED_PARITY_FRAMES
        kps, valid = seq.batch.kps[:F], seq.batch.valid[:F]
        t0 = time.perf_counter()
        card = timed_run_offline(torch, tracker.TrackerContext.build(seq.cameras, cfg,
                                                                     device=dev), kps, valid)
        cpu = timed_run_offline(torch, tracker.TrackerContext.build(seq.cameras, cfg,
                                                                    device="cpu"), kps, valid)
        parity = compare_runs(torch, card, cpu)
        parity["cpu_s"] = cpu[2]
        parity["card_equals_bench_run"] = all(
            np.array_equal(a, b[:F]) for a, b in zip(card[0], outs["full_ik"]))
        parity["wall_s"] = time.perf_counter() - t0
        path = "scaled_" + name.replace("_x_10ppl", "")
        by_path[path] = launches
        clusters = cfg.assoc_clusters
        rows[name] = dict(
            frames=n_frames, clusters=clusters, n_matrix=cfg.n_matrix,
            n_cluster=cfg.max_tracks + -(-cfg.n_views // clusters) * cfg.max_people,
            run_s=run_s, **{m: r[m] for m in ("assoc_tri", "full_ik")},
            launches=launches, launches_per_frame={
                k: v / (4 * n_frames) for k, v in launches.items()},
            parity_frames=F, parity=parity)
        emit({"phase": "scaled", "config": name, **rows[name]})
        if name == SCALED_PROFILE[0]:
            profiled = seq, cfg
        batched = clusters > 1
        if not (launches["als_batched" if batched else "als"] > 0
                and launches["als" if batched else "als_batched"] == 0
                and launches["gj_solve"] > 0):
            raise AssertionError(f"{name}: the ALS or LM kernels did not launch as expected")
        if not all(r[m]["n_tracklets"] > 0 for m in ("assoc_tri", "full_ik")):
            raise AssertionError(f"{name}: no tracklets")
        if not (parity["decisions_equal"] and parity["x_bin_equal"]
                and parity["max_pose_diff_m"] <= POSE_TOL_M
                and parity["card_equals_bench_run"]):
            raise AssertionError(f"{name}: card and CPU runs disagree")
    # after the rigs: a process runs its host code slower once it has traced
    phase_profile(torch, dev, *profiled, SCALED_PROFILE[1], "scaled_profile", 12, False)
    emit({"phase": "scaled", "summary": {
        n: {"fps_assoc_tri": v["assoc_tri"]["fps"], "fps_full_ik": v["full_ik"]["fps"],
            "n_tracklets": v["full_ik"]["n_tracklets"], "n_long": v["full_ik"]["n_long"],
            "mpjpe_m": v["assoc_tri"]["mpjpe_m"],
            "b1_b3_b2_launches": [v["launches"][k] for k in ("als", "als_batched",
                                                              "gj_solve")]}
        for n, v in rows.items()}})
    return by_path


def phase_stream_curve(torch, dev, root: Path):
    """scripts/torch_bench_streaming.py's curve on the `bench` phase's scene
    files, cut to STREAM_CURVE_FRAMES frames: for each k, `update_batch`
    in chunks of k after a warm chunk and the state reset in place; every
    k's outputs (the short tail chunk included) bit-equal to `run_offline`
    on those frames; frames/s and the p50 / p99 ms of a chunk per k."""
    import numpy as np

    from multiview_motion_capture_torch import tracker

    st = script_module("torch_bench_streaming")
    cfg, batch, cams = st.load(root, SCENE["n_frames"])
    F = STREAM_CURVE_FRAMES
    kps, valid = batch.kps[:F], batch.valid[:F]
    trackers = {}
    zero_launch_counts()
    res = st.stream_curve(cams, cfg, kps, valid, device=dev, trackers=trackers)
    launches = launch_counts()
    ctx = tracker.TrackerContext.build(cams, cfg, device=dev)
    ref = tracker.outputs_to_numpy(tracker.run_offline(ctx, kps, valid)[1])
    equal = {k: trk.frame_idxs == list(range(F)) and all(
        np.array_equal(np.stack([getattr(o, f) for o in trk.outputs]), getattr(ref, f))
        for f in tracker.FrameOutput._fields) for k, trk in trackers.items()}
    emit({"phase": "stream_curve", "frames": F, "curve": res,
          "tail_chunks": {k: F % k for k in trackers},
          "bit_equal_run_offline": equal, "launches": launches})
    if not all(equal.values()):
        raise AssertionError("a chunk size's stream differs from run_offline")
    if launches["als"] == 0 or launches["gj_solve"] == 0:
        raise AssertionError("the streaming curve launched no kernel")
    return launches


def phase_e2e_synthetic(torch, dev):
    """examples/torch_e2e_synthetic.py on the card at E2E_SYNTHETIC: crops
    rendered, the top-down PoseNet trained, detected, tracked in
    triangulation mode (B1); gated as tests/test_e2e_cnn.py gates the JAX
    example."""
    import examples.torch_e2e_synthetic as ex

    zero_launch_counts()
    det_err, n_long, mpjpe = ex.main(device=dev, **E2E_SYNTHETIC)
    launches = launch_counts()
    g = E2E_SYNTHETIC_GATES
    ok = det_err < g["det_err_px"] and n_long == g["n_long"] and mpjpe < g["mpjpe_m"]
    emit({"phase": "e2e_synthetic", **E2E_SYNTHETIC, "det_err_px": float(det_err),
          "n_long": n_long, "mpjpe_m": mpjpe, "gates": g, "gates_met": ok,
          "launches": launches})
    if not ok:
        raise AssertionError("e2e_synthetic misses the JAX test's gates")
    if launches["als"] == 0:
        raise AssertionError("e2e_synthetic launched no ALS kernel")
    return launches


def phase_e2e_fullframe(torch, dev):
    """examples/torch_e2e_fullframe.py on the card at E2E_FULLFRAME: frames
    rendered, the PoseNet trained on full frames and crops, the cascade
    detector, tracking in triangulation mode (B1); gated as
    tests/test_detect_cascade.py gates the JAX example."""
    import examples.torch_e2e_fullframe as ex

    zero_launch_counts()
    recall, det_err, n_long, mpjpe = ex.main(device=dev, **E2E_FULLFRAME)
    launches = launch_counts()
    g = E2E_FULLFRAME_GATES
    ok = (recall > g["recall"] and det_err < g["det_err_px"] and n_long == g["n_long"]
          and mpjpe < g["mpjpe_m"])
    emit({"phase": "e2e_fullframe", **E2E_FULLFRAME, "recall": recall,
          "det_err_px": det_err, "n_long": n_long, "mpjpe_m": mpjpe, "gates": g,
          "gates_met": ok, "launches": launches})
    if not ok:
        raise AssertionError("e2e_fullframe misses the JAX test's gates")
    if launches["als"] == 0:
        raise AssertionError("e2e_fullframe launched no ALS kernel")
    return launches


def phase_bench_detect(torch, dev):
    """scripts/torch_bench_detect.py's line at BENCH_DETECT_FRAMES frames
    (the five detection timings, then pipeline.run with IK: B1, B2), with
    bench_detect.py's keys; then the host syncs of its staged loops over
    BENCH_DETECT_SYNC_FRAMES frames (CUDA's sync debug mode: a host read
    inside a detector would serialise every frame)."""
    import numpy as np

    bd = script_module("torch_bench_detect")
    zero_launch_counts()
    line = bd.main(n_frames=BENCH_DETECT_FRAMES, device=dev)
    launches = launch_counts()
    keys_ok = (set(line) == {"metric", "value", "unit", "extra"}
               and line["metric"] == "detect_track_e2e_fps"
               and BENCH_DETECT_EXTRA_KEYS <= set(line["extra"])
               and line["extra"]["backend"] == "cuda")
    cfg, _, _, _, images = bd.make_frames(BENCH_DETECT_SYNC_FRAMES, 3, 5)
    d = bd.detectors(cfg, torch.device(dev))
    staged = torch.as_tensor((images * 255).astype(np.uint8), device=dev)
    syncs = {}
    for name, det, net in (("cascade", d["detect"], d["net"]),
                           ("bottom_up", d["detect_bu"], d["bu_net"])):
        det(net, staged[0])
        torch.cuda.synchronize()
        _, n = count_syncs(lambda: [det(net, staged[f]) for f in range(len(staged))])
        syncs[name] = n / len(staged)
    emit({"phase": "bench_detect", "line": line, "keys_match_bench_detect_py": keys_ok,
          "staged_loop_host_syncs_per_frame": syncs, "launches": launches})
    if not keys_ok:
        raise AssertionError("torch_bench_detect's line lacks bench_detect.py's keys")
    if any(syncs.values()):
        raise AssertionError("a staged detection loop synchronises with the host")
    if launches["als"] == 0 or launches["gj_solve"] == 0:
        raise AssertionError("bench_detect's tracking launched no ALS or LM kernel")
    return launches


def phase_profile_bench(torch, dev, root: Path):
    """scripts/torch_profile_bench.py on the `bench` phase's Shelf-layout
    files, cut to PROFILE_BENCH_FRAMES frames (SHELF_BENCH, IK: B1, B2): the
    warm, steady (unprofiled) and device-only traced passes, the report's
    rows, launches and the idle share of both passes; the traced pass's
    outputs bit-equal to the steady pass's."""
    import numpy as np

    from multiview_motion_capture_torch import tracker

    pb = script_module("torch_profile_bench")
    zero_launch_counts()
    rep = pb.main(["--data_dir", str(root), "--max_frames", str(PROFILE_BENCH_FRAMES)])
    launches = launch_counts()
    steady, traced = rep["outputs"]
    equal = all(np.array_equal(getattr(steady, f), getattr(traced, f))
                for f in tracker.FrameOutput._fields)
    labels = [r["name"] for r in rep["rows"]]
    emit({"phase": "profile_bench", "report": {k: v for k, v in rep.items()
                                               if k not in ("rows", "outputs")},
          "top_kernels": rep["rows"][:12], "traced_equals_steady": equal,
          "launches": launches})
    if not (equal and pb.B_KERNELS["als_kernel"] in labels
            and pb.B_KERNELS["gj_solve_kernel"] in labels):
        raise AssertionError("profile_bench: traced pass differs, or a B-kernel is missing")
    if not (launches["als"] > 0 and launches["gj_solve"] > 0
            and 0.0 <= rep["idle_share_unprofiled"] < 1.0):
        raise AssertionError("profile_bench launched no kernel, or its idle share is off")
    return launches


def study_call(fn, *args, **kwargs):
    """One study's run with the launch counters set to 0 just before it
    and read just after: (its JSON, launches, wall s).  What the study
    prints goes to stderr (the phase prints the JSON on its own line)."""
    zero_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        out = fn(*args, **kwargs)
    return out, launch_counts(), time.perf_counter() - t0


def phase_studies(torch, dev, root: Path):
    """The eight research studies' ports on the card at STUDY_CUTS' sizes:
    bench_quality_bisect (B1, B2), ik_iteration (the 64-camera rig: B3, B2;
    every count within its budget), fragmentation and oracle_parity (the
    bench phase's files, one oracle run: B1; their tracklets bit-equal to
    `replay_states` / `pipeline.run` on the same files), identity (B1 at N
    116, B2), appearance_e2e (B1), crowd_detect and style_holdout (no TPU
    kernel: cuDNN).  Each study's JSON holds its JAX script's keys.  Returns
    each study's launches by path name `study_<name>`."""
    import numpy as np

    from multiview_motion_capture_torch import pipeline, tracker
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses, load_openpose_dir

    cuts, keys = STUDY_CUTS, STUDY_KEYS
    cache = root / "oracle_cache"
    by_path, failed = {}, []

    def report(name, line, launches, wall_s, checks, expect):
        missing = [k for k, ok in checks.items() if not ok]
        no_launch = [k for k in expect if launches[k] == 0]
        emit({"phase": "studies", "study": name, "wall_s": wall_s, "json": line,
              "launches": launches, "checks": checks})
        by_path["study_" + name] = launches
        if missing or no_launch:
            failed.append((name, missing, no_launch))

    # 1. the benchmark's config bisection on the scene files
    bq = script_module("torch_bench_quality_bisect")
    out, launches, wall = study_call(bq.main,
                                     ["--data_dir", str(root), "--max_frames",
                                      str(cuts["bisect_frames"])])
    report("bench_quality_bisect", out, launches, wall, {
        "keys": set(out) == keys["bisect"]
        and all(set(r) == keys["bisect_row"] for r in out.values()),
        "tracklets": all(r["n_tracklets"] > 0 for r in out.values())},
        ("als", "gj_solve"))

    # 2. the LM's executed iterations on the 64-camera rig
    ik = script_module("torch_ik_iteration_study")
    per_frame = {}
    line, launches, wall = study_call(ik.main, [], n_frames=cuts["ik_frames"],
                                      outputs=per_frame)
    ex = line["extra"]
    within = {label: ex[label]["max"] <= v[3] * v[0] for label, v in ik.VARIANTS.items()}
    report("ik_iteration", line, launches, wall, {
        "keys": set(ex) == keys["ik_iteration"]
        and all(set(ex[k]) == keys["ik_iteration_row"] for k in ik.VARIANTS),
        "counts_within_budget": all(within.values()),
        "frames": all(ex[k]["frames"] > 0 for k in ik.VARIANTS)},
        ("als_batched", "gj_solve"))

    # 3-4. fragmentation and the oracle's parity on the scene files, one
    # oracle run between them; each study's tracklets against the tracker
    # run on its own on the same files
    n = cuts["oracle_frames"]
    fs = script_module("torch_fragmentation_study")
    got = {}
    out, launches, wall = study_call(fs.main, [
        "--data_dir", str(root), "--max_frames", str(n), "--oracle_cache", str(cache)],
        outputs=got)
    cfg = PipelineConfig(max_frames=n, track_rescue_px=0.0)
    batch, cams = fs.load_shelf(cfg, root, n)
    ctx = tracker.TrackerContext.build(cams, cfg, device=dev)
    ref = tracker.outputs_to_numpy(tracker.run_offline(ctx, batch.kps[:n], batch.valid[:n])[1])
    report("fragmentation", out, launches, wall, {
        "keys": set(out) == keys["fragmentation"],
        "outputs_equal_run_offline": all(
            np.array_equal(getattr(got["outs"], f), getattr(ref, f))
            for f in tracker.FrameOutput._fields),
        "tracklets": out["tracker_tracklets"] == len(got["tracklets"]) > 0},
        ("als",))

    ps = script_module("torch_oracle_parity_study")
    got = {}
    out, launches, wall = study_call(ps.main, [
        "--data_dir", str(root), "--max_frames", str(n), "--oracle_cache", str(cache),
        "--out", str(root / "oracle_parity.json")], outputs=got)
    pcfg = PipelineConfig.parity(max_frames=n)
    pbatch = filter_bad_poses(load_openpose_dir(root / "kps_opn", pcfg), pcfg)
    pres = pipeline.run(pbatch, cams, pcfg, use_ik=True, device=dev)
    report("oracle_parity", out, launches, wall, {
        "keys": keys["oracle_parity"] <= set(out),
        "tracklets_equal_pipeline_run": tracklets_equal(got["result"].tracklets,
                                                        pres.tracklets),
        "oracle_from_cache": out["oracle"]["runtime_s"] < 5.0,
        "written": json.loads((root / "oracle_parity.json").read_text())["n_frames"] == n},
        ("als",))

    # 5. identity on two of its configurations
    ids = script_module("torch_identity_study")
    line, launches, wall = study_call(ids.main, [], names=cuts["identity"],
                                      n_frames=cuts["identity_frames"])
    ex = line["extra"]
    report("identity", line, launches, wall, {
        "keys": set(ex) == set(cuts["identity"]) | {"backend"}
        and all(keys["identity_row"] <= set(ex[k]) for k in cuts["identity"])
        and keys["identity_crossings_row"] <= set(ex[cuts["identity"][1]]),
        "backend": ex["backend"].startswith("cuda")},
        ("als", "gj_solve"))

    # 6. the shipped detector with appearance, then tracking
    ae = script_module("torch_appearance_e2e_study")
    line, launches, wall = study_call(ae.main,
                                      ["--frames", str(cuts["appearance_frames"])])
    ex = line["extra"]
    report("appearance_e2e", line, launches, wall, {
        "keys": set(ex) == keys["appearance_e2e"]
        and all(set(ex[k]) == keys["appearance_e2e_row"]
                for k in ex if isinstance(ex[k], dict)),
        "tracks": ex["geometry_only"]["raw_tracks"] > 0},
        ("als",))

    # 7-8. the detector studies (no TPU kernel on their path)
    cd = script_module("torch_crowd_detect_study")
    line, launches, wall = study_call(cd.main,
                                      ["--frames", str(cuts["crowd_frames"])])
    ex = line["extra"]
    report("crowd_detect", line, launches, wall, {
        "keys": set(ex) == keys["crowd_detect"]
        and all(set(r) == keys["crowd_detect_row"] for r in ex.values()),
        "sparse_recall": ex["p4_d1.2"]["recall"] > 0.5}, ())
    sh = script_module("torch_detector_style_holdout")
    line, launches, wall = study_call(sh.main,
                                      ["--seeds", *map(str, cuts["style_seeds"])])
    ex = line["extra"]
    report("style_holdout", line, launches, wall, {
        "keys": set(ex) == keys["style_holdout"]
        and set(ex["styles"]) == set(sh.STYLES)
        and set(ex["calibration"]) == {str(t) for t in sh.THRESHOLDS}}, ())
    if failed:
        raise AssertionError(f"studies failed their checks or launched no kernel: {failed}")
    return by_path


def slice_scene():
    import dataclasses as dc

    from multiview_motion_capture_torch.config import SHELF_BENCH
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    cfg = dc.replace(SHELF_BENCH, max_frames=None)
    return synthetic_sequence(cfg=cfg, **SCENE), cfg


def default_scene():
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    dcfg = PipelineConfig(**DEFAULT_CFG)
    return synthetic_sequence(cfg=dcfg, **SCENE), dcfg


def appearance_scene():
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.synthetic import (
        synthetic_appearance,
        synthetic_sequence,
    )

    acfg = PipelineConfig(**APPEARANCE_CFG)
    aseq = synthetic_sequence(cfg=acfg, **APPEARANCE_SCENE)
    return aseq, acfg, synthetic_appearance(aseq, **APPEARANCE_EMBED)


# The phases run in groups, each group in a worker process of this script
# (`--group NAME DIR`) on the card: `kernels` alone first, so that the
# kernel table's times are the card's alone, then the other groups side by
# side (each path is host-bound: one core drives it and the card idles
# most of the time).  A group keeps the phases that share a scene or a
# result.  The phases that trace with torch.profiler come last in their
# group: a process that has traced runs its host code slower after.  Each
# group returns its paths' launch counts (and `kernels` its checks) through
# DIR/NAME.json.
def group_kernels(torch, dev, tmp: Path) -> dict:
    seq, cfg = slice_scene()
    dseq, dcfg = default_scene()
    aseq, acfg, app = appearance_scene()
    checks = run_phase("kernels", phase_kernels, torch, dev, seq, cfg, dseq, dcfg,
                       aseq, acfg, app)
    return {"checks": checks, "paths": {}}


def group_slice(torch, dev, tmp: Path) -> dict:
    """SHELF_BENCH on the slice's scene: the slice, its card-vs-CPU check,
    the mesh-spec route and the benchmark programs on its files."""
    seq, cfg = slice_scene()
    paths = {}
    paths["slice"], slice_res = run_phase("slice", phase_slice, torch, dev, seq, cfg)
    run_phase("parity", phase_parity, torch, dev, seq, cfg)
    paths["mesh_spec"] = run_phase("mesh_spec", phase_mesh_spec, torch, dev, seq, cfg,
                                   slice_res)
    root = tmp / "slice_files"
    paths["bench"] = run_phase("bench", phase_bench, torch, dev, seq, slice_res, root)
    paths["stream_curve"] = run_phase("stream_curve", phase_stream_curve, torch, dev, root)
    paths["profile_bench"] = run_phase("profile_bench", phase_profile_bench, torch, dev, root)
    run_phase("profile", phase_profile, torch, dev, seq, cfg, SLICE_PROFILE_FRAMES)
    return {"paths": paths}


def group_default(torch, dev, tmp: Path) -> dict:
    """The default preset on the slice's scene (IK, triangulation, the
    streaming tracker, the CLI, the alternative matchers), then the
    detector's training phases."""
    dseq, dcfg = default_scene()
    paths = {}
    paths["default"] = run_phase("default", phase_default, torch, dev, dseq, dcfg)
    run_phase("default_parity", phase_parity, torch, dev, dseq, dcfg,
              DEFAULT_PARITY_FRAMES, "default_parity")
    paths["no_ik"] = run_phase("no_ik", phase_no_ik, torch, dev, dseq, dcfg)
    paths["stream"] = run_phase("stream", phase_stream, torch, dev, dseq,
                                dataclasses.replace(dcfg, motion_gain=1.0))
    paths["cli"] = run_phase("cli", phase_cli, torch, dev, dseq)
    run_phase("alt", phase_alt, torch, dev, dseq, dcfg)
    run_phase("train_parity", phase_train_parity, torch, dev)
    run_phase("appearance_train", phase_appearance_train, torch, dev)
    run_phase("train", phase_train, torch, dev)
    run_phase("default_profile", phase_profile, torch, dev, dseq, dcfg,
              DEFAULT_PROFILE_FRAMES, "default_profile", 12, False)
    return {"paths": paths}


def group_appearance(torch, dev, tmp: Path) -> dict:
    """Appearance, identity and checkpoints on the identity study's scene,
    the config-5 examples and bench_detect, then the detect path."""
    aseq, acfg, app = appearance_scene()
    paths = {}
    paths["appearance"], app_tracklets = run_phase("appearance", phase_appearance, torch,
                                                   dev, aseq, acfg, app)
    run_phase("appearance_parity", phase_parity, torch, dev, aseq, acfg,
              APPEARANCE_PARITY_FRAMES, "appearance_parity", app)
    final = run_phase("identity", phase_identity, aseq, app_tracklets)
    paths["checkpoint"] = run_phase("checkpoint", phase_checkpoint, torch, dev, aseq, acfg,
                                    app, final)
    paths["e2e_synthetic"] = run_phase("e2e_synthetic", phase_e2e_synthetic, torch, dev)
    paths["e2e_fullframe"] = run_phase("e2e_fullframe", phase_e2e_fullframe, torch, dev)
    paths["bench_detect"] = run_phase("bench_detect", phase_bench_detect, torch, dev)
    paths["detect"], frames = run_phase("detect", phase_detect, torch, dev)
    run_phase("detect_parity", phase_detect_parity, torch, dev, frames)
    run_phase("cascade", phase_cascade, torch, dev, frames)
    paths["detect_cli"] = run_phase("detect_cli", phase_detect_cli, torch, dev, frames)
    return {"paths": paths}


def group_wide(torch, dev, tmp: Path) -> dict:
    """The 64-camera rig (B3, B2, B4), the multi-device paths and the
    clustered association dump."""
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    wcfg = PipelineConfig.wide(WIDE_SCENE["n_views"], max_frames=None)
    wseq = synthetic_sequence(cfg=wcfg, **WIDE_SCENE)
    paths = {}
    paths["wide"], wide_res, wide_run = run_phase("wide", phase_wide, torch, dev, wseq, wcfg)
    paths["wide_fused"] = run_phase("wide_fused", phase_wide_fused, torch, dev, wseq, wcfg,
                                    wide_res)
    run_phase("wide_parity", phase_parity, torch, dev, wseq, wcfg, WIDE_PARITY_FRAMES,
              "wide_parity")
    paths["mesh_wide"], paths["mesh_wide_fused"] = run_phase(
        "mesh_wide", phase_mesh_wide, torch, dev, wseq, wcfg, wide_res, wide_run)
    paths["mesh_cameras"] = run_phase("mesh_cameras", phase_mesh_cameras, torch, dev)
    paths["streams"] = run_phase("streams", phase_streams, torch, dev)
    run_phase("mesh_train", phase_mesh_train, torch, dev)
    paths["debug_clustered"] = run_phase("debug_clustered", phase_debug_clustered, torch, dev)
    run_phase("wide_profile", phase_profile, torch, dev, wseq, wcfg, WIDE_PROFILE_FRAMES,
              "wide_profile")
    return {"paths": paths}


def group_studies(torch, dev, tmp: Path) -> dict:
    """The research studies on the slice's scene files, then the scaled
    benchmark's rigs."""
    seq, _ = slice_scene()
    root = tmp / "study_files"
    write_bench_files(seq, root)
    paths = dict(run_phase("studies", phase_studies, torch, dev, root))
    paths.update(run_phase("scaled", phase_scaled, torch, dev))
    return {"paths": paths}


GROUPS = {"kernels": group_kernels, "slice": group_slice, "default": group_default,
          "appearance": group_appearance, "wide": group_wide, "studies": group_studies}
# the groups that run side by side once `kernels` has run alone
SIDE_BY_SIDE = ("slice", "default", "appearance", "wide", "studies")
# the whole run's wall-clock budget: the workers still running then are
# stopped and the run fails
RUN_BUDGET_S = 1140.0


def worker(name: str, tmp: Path) -> int:
    """Run one group of phases on the card; its result goes to tmp/name.json."""
    import torch

    from multiview_motion_capture_torch.utils.precision import high_precision

    high_precision()
    out = GROUPS[name](torch, "cuda", tmp)
    (tmp / f"{name}.json").write_text(json.dumps(out))
    return 0


def run_groups(names, tmp: Path, deadline: float) -> dict:
    """Start one worker process per group, relay their output lines as they
    come, and wait for all of them.  A worker that fails, or the run's
    deadline passing, stops every worker (and what each started) and
    fails."""
    import os
    import signal
    import threading

    lock = threading.Lock()

    def relay(src, dst):
        for line in src:
            with lock:
                dst.write(line)
                dst.flush()

    procs, relays, started = {}, [], {}
    try:
        for name in names:
            p = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--group", name, str(tmp)],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                start_new_session=True)
            procs[name], started[name] = p, time.perf_counter()
            for src, dst in ((p.stdout, sys.stdout), (p.stderr, sys.stderr)):
                t = threading.Thread(target=relay, args=(src, dst), daemon=True)
                t.start()
                relays.append(t)
        pending = dict(procs)
        while pending:
            for name, p in list(pending.items()):
                code = p.poll()
                if code is None:
                    continue
                del pending[name]
                with lock:
                    emit({"phase": "group", "group": name, "exit_code": code,
                          "wall_s": time.perf_counter() - started[name]})
                if code != 0:
                    raise RuntimeError(f"group {name} failed with exit code {code}")
            if pending and time.perf_counter() > deadline:
                raise TimeoutError(f"groups {sorted(pending)} still running at the "
                                   f"run's {RUN_BUDGET_S:.0f} s budget")
            time.sleep(0.5)
        for t in relays:
            t.join(timeout=10)
    finally:
        for p in procs.values():
            if p.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return {name: json.loads((tmp / f"{name}.json").read_text()) for name in names}


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (REPO / "multiview_motion_capture_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--group"]:
        return worker(sys.argv[2], Path(sys.argv[3]))
    from multiview_motion_capture_torch.ops import cuda_lib

    smi_line = phase_env(torch)
    run_phase("build", phase_build)
    deadline = t_start + RUN_BUDGET_S
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        results = run_groups(["kernels"], Path(tmp), deadline)
        results.update(run_groups(SIDE_BY_SIDE, Path(tmp), deadline))
    checks = results["kernels"]["checks"]
    paths = {}
    for name in SIDE_BY_SIDE:
        paths.update(results[name]["paths"])

    def row(kernel, replaces, r, library_ms):
        by_path = {p: c[kernel.name] for p, c in paths.items() if c[kernel.name]}
        out = {"name": kernel.name, "route": "cuda",
               "source": str(kernel.source_path.relative_to(REPO)),
               "replaces": replaces, "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": library_ms}
        if "yardstick_ms" in r:
            out["yardstick"], out["yardstick_ms"] = r["yardstick"], r["yardstick_ms"]
        # the device times of the LM solves, the launch shape, and the ALS
        # kernels' X output (its agreement with the plain X, its time)
        out.update({k: r[k] for k in ("device_ms", "plain_device_ms", "library_device_ms",
                                      "yardstick_device_ms", "cluster", "threads",
                                      "smem_bytes", "registers", "local_bytes",
                                      "x_max_abs_err", "ms_with_x") if k in r})
        return out

    tpu = "multiview_motion_capture_tpu/ops/"
    als_row = row(cuda_lib.ALS, tpu + "als_pallas.py:130", checks["als"], None)
    # B1 at the default preset's shape (N = 66, rank 32), the appearance
    # scene's (N = 116, rank 32, a cluster of 16), the detect path's (N =
    # 52, rank 24) and the examples' (N = 22, rank 12), the same fields
    for key, case in (("at_default_preset", "als_default"), ("at_appearance", "als_appearance"),
                      ("at_detect", "als_detect"), ("at_examples", "als_examples"),
                      ("at_examples_frame0", "als_examples_frame0")):
        als_row[key] = {k: checks[case][k] for k in (
            "case", "n", "rank", "iters_kernel", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "cluster", "ms_per_iter", "x_max_abs_err", "ms_with_x")}
    # B3 at the 128-camera rigs' shapes (C 4, N 336; C 5, N 276), the same
    # fields and the C sequential B1 launches beside them
    b3_row = row(cuda_lib.ALS_BATCHED, tpu + "als_pallas.py:282", checks["als_batched"], None)
    for key, case in (("at_rig128_4clusters", "als_batched_c4"),
                      ("at_rig128_5clusters", "als_batched_c5")):
        b3_row[key] = {k: checks[case][k] for k in (
            "case", "C", "n", "rank", "iters_kernel", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "yardstick_ms", "cluster", "ms_per_iter",
            "x_max_abs_err", "ms_with_x")}
    table = {"kernels": [
        als_row,
        row(cuda_lib.GJ_SOLVE, tpu + "solve_pallas.py:55", checks["gj_solve"],
            checks["gj_solve"]["library_ms"]),
        b3_row,
        row(cuda_lib.FUSED_NORMAL_GJ, tpu + "solve_pallas.py:111", checks["fused_normal_gj"],
            None),
        row(cuda_lib.GJ_SOLVE_GRID, tpu + "solve_pallas.py:29", checks["gj_solve_grid"],
            checks["gj_solve_grid"]["library_ms"]),
    ]}
    emit({"phase": "total", "wall_s": time.perf_counter() - t_start})
    print(smi_line, flush=True)
    emit(table)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
