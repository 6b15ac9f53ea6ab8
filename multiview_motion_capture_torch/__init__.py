"""PyTorch/CUDA port of the multi-view motion-capture framework.

Runs the JAX package's tracker (`pipeline.run`: detection filter ->
per-frame tracker step with epipolar similarity, optional appearance and
motion evidence, ALS association, track rescue/lifecycle, triangulation and
batched LM inverse kinematics -> tracklets; offline, chunked with
checkpoints, or streaming) on an NVIDIA GPU, its host post-passes on the
tracklets (crossing repair, the re-ID merge, identity metrics), and the
detection path from camera frames: the keypoint CNN and its decoders
(`models.pose_net`), the appearance head (`models.appearance_net`), the
detectors and `frames_to_frame_batch` (`data.detect`), with the shipped
checkpoints read by `models.checkpoint`.  The TPU kernels are CUDA C++
kernels for Hopper under `csrc/`, each beside a plain torch version that
serves CPU tensors.

Entry points (`pipeline.run`, `MvTracker`, `tracker.TrackerContext.build`,
`tracker.run_offline`, `utils.checkpoint.load_state`,
`models.checkpoint.load_posenet` / `load_appearance_head`) run on
`device="cuda"` unless the caller passes `device="cpu"`; without a GPU the
default raises; a detector runs on the device of the network it is
given.  This package imports torch and numpy only, never JAX or the JAX
package.
"""

__version__ = "0.1.0"

from multiview_motion_capture_torch.config import PipelineConfig  # noqa: F401
from multiview_motion_capture_torch.crossings import CrossingConfig, resolve_crossings  # noqa: F401
from multiview_motion_capture_torch.data.ingest import (  # noqa: F401
    FrameBatch,
    filter_bad_poses,
    load_openpose_dir,
)
from multiview_motion_capture_torch.eval import identity_metrics  # noqa: F401
from multiview_motion_capture_torch.reid import ReidConfig, merge_tracklets  # noqa: F401
from multiview_motion_capture_torch.tracker import MvTracker  # noqa: F401
