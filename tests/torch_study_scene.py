"""What the port's study tests share (tests/test_torch_bisect_study.py,
tests/test_torch_fragmentation_study.py, tests/test_torch_oracle_parity_
study.py): a small scene written in the Shelf dataset's layout, as
tests/test_torch_bench.py writes one, and the pieces that hand it to the
JAX package's study scripts, which read Shelf from a fixed path."""
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import torch
from threadpoolctl import threadpool_limits

from multiview_motion_capture_torch.config import SHELF_BENCH
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
from multiview_motion_capture_tpu.cameras import CameraBank as JCameraBank

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import chip_smoke  # noqa: E402  (the scene writer the card's phases use)

# tests/test_torch_bench.py's scene (3 people, 5 views, seed 2); a
# detection is dropped with probability 0.05 there, and with 0.2 in the
# scene of the fragmentation and parity studies, so tracks die and respawn
N_FRAMES = 12
SCENE = dict(n_frames=N_FRAMES, n_people=3, n_views=5, seed=2)
DEATHS_DROP_PROB = 0.2


def write_scene(root: Path, drop_prob: float = 0.05) -> Path:
    seq = synthetic_sequence(cfg=dataclasses.replace(SHELF_BENCH, max_frames=None),
                             drop_prob=drop_prob, **SCENE)
    chip_smoke.write_scene_files(seq, root, SCENE["n_frames"], kps_dir="kps_opn")
    return root


class JaxCameras:
    """A JAX script's `CameraBank`, reading the scene's calibration."""

    def __init__(self, root: Path):
        self.root = root

    def from_json_dir(self, _path):
        return JCameraBank.from_json_dir(self.root / "calibs")


@contextlib.contextmanager
def one_thread():
    """One thread for torch and for the BLAS and OpenMP pools (the oracle's
    scipy solves, numpy): the test suite runs several workers at once, and
    each pool's own threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(n)


def json_of(text: str):
    """The one JSON object a script printed (after any other lines)."""
    return json.loads(text[text.index("{"):])
