"""Float32 precision and device selection for the port.

The counterpart of `multiview_motion_capture_tpu/utils/precision.py`: on
the TPU, f32 matmuls default to bf16 passes; on Hopper the matching hazard
is TF32.  Pixel-scale geometry (coordinates ~1e3) and the LM normal
equations (J^T J at ik.py) lose about three decimal digits under TF32, which
drifts poses and flips near-threshold association decisions, so every
context pins full f32.

`WORK_DTYPE` is the precision of the tracker's plain tensor math between
the kernels (similarities, triangulation, the cold-start init, forward
kinematics and the LM residuals, jacobians and normal equations).  It runs
in f64 and rounds once to f32 wherever the JAX package holds an f32 value:
the state, the ALS input W and the LM's [A | g] or [J | r].  CPU and card
then differ only in the last f64 bits of a sum or a sine, which round to
the same f32 (except for one value in ~1e8), so both devices hand the
kernels the same inputs.  That matters because the ALS at
the wide rig's N = 336 does not settle within its cap, and there one unit
in the last place of W changes the grouping.
"""
from __future__ import annotations

import torch

WORK_DTYPE = torch.float64


def high_precision() -> None:
    """Pin full-f32 matmuls and convolutions (no TF32) process-wide, and
    cuDNN to one deterministic algorithm a convolution (no autotuning), so
    two runs of the detector on the card give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


def precision_flags() -> dict:
    """The settings `high_precision` pins, as they stand now."""
    return {
        "cuda_matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "cudnn_benchmark": bool(torch.backends.cudnn.benchmark),
        "cudnn_deterministic": bool(torch.backends.cudnn.deterministic),
    }


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  "cuda" (the default everywhere)
    needs a GPU and raises without one: nothing falls back to the CPU unless
    the caller asks for it with device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain torch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
