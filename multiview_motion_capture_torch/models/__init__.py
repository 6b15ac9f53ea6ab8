from multiview_motion_capture_torch.models.pose_net import (  # noqa: F401
    PoseNet,
    PoseNetConfig,
    decode_heatmaps,
)
