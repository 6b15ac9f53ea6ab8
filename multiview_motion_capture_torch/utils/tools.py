"""Small host-side tools mirroring the reference's one-off scripts
(SURVEY.md §2 row 20).  A copy of `multiview_motion_capture_tpu/utils/
tools.py`: `imageio`, `yaml` and `ffmpeg` are used inside the functions
that need them."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Optional


def images_to_video(img_dir: Path, out_path: Path, fps: int = 24,
                    pattern: str = "*.jpg") -> Path:
    """jpg directory -> mp4 (ref:src/imgs_to_video.py:5-16)."""
    import imageio.v2 as imageio

    paths = sorted(Path(img_dir).glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no {pattern} in {img_dir}")
    with imageio.get_writer(str(out_path), fps=fps) as w:
        for p in paths:
            w.append_data(imageio.imread(p))
    return Path(out_path)


def video_to_images(video_path: Path, img_dir: Path, ext: str = "jpg") -> list:
    """mp4 -> numbered frames via ffmpeg (ref:src/motion_capture.py:1132-1139)."""
    import subprocess

    img_dir = Path(img_dir)
    img_dir.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-y", "-i", str(video_path), "-hide_banner",
         f"{img_dir}/%012d.{ext}"],
        check=True, capture_output=True,
    )
    return sorted(img_dir.glob(f"*.{ext}"))


def convert_calib_json_to_yaml(json_path: Path, out_path: Optional[Path] = None) -> Path:
    """Calib JSON {K, RT, imgSize} -> YAML (ref:src/convert_shelf_calib.py:6-15)."""
    import yaml

    with open(json_path) as f:
        data = json.load(f)
    out_path = Path(out_path or Path(json_path).with_suffix(".yml"))
    with open(out_path, "w") as f:
        yaml.safe_dump(
            {"K": list(map(float, data["K"])),
             "RT": list(map(float, data["RT"])),
             "imgSize": list(map(float, data["imgSize"]))},
            f,
        )
    return out_path
