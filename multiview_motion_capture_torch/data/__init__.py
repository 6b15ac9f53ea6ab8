from multiview_motion_capture_torch.data.ingest import (  # noqa: F401
    FrameBatch,
    filter_bad_poses,
    load_frame_batch,
    load_openpose_dir,
    save_frame_batch,
)
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence  # noqa: F401
