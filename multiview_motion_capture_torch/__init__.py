"""PyTorch/CUDA port of the multi-view motion-capture framework.

Runs the JAX package's tracker (`pipeline.run`: detection filter ->
per-frame tracker step with epipolar similarity, optional appearance and
motion evidence, ALS association, track rescue/lifecycle, triangulation and
batched LM inverse kinematics -> tracklets; offline, chunked with
checkpoints, or streaming) on an NVIDIA GPU, and its host post-passes on
the tracklets (crossing repair, the re-ID merge, identity metrics).  The
TPU kernels are CUDA C++ kernels for Hopper under `csrc/`, each beside a
plain torch version that serves CPU tensors.

Entry points (`pipeline.run`, `MvTracker`, `tracker.TrackerContext.build`,
`tracker.run_offline`, `utils.checkpoint.load_state`) run on
`device="cuda"` unless the caller passes `device="cpu"`; without a GPU the
default raises.  This package imports torch and numpy only, never JAX or
the JAX package.
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
