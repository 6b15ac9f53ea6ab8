from multiview_motion_capture_torch.utils.profiling import StageTimer  # noqa: F401
