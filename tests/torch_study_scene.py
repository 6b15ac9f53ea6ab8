"""What the port's study tests share (tests/test_torch_bisect_study.py,
tests/test_torch_fragmentation_study.py, tests/test_torch_oracle_parity_
study.py): a small scene written in the Shelf dataset's layout, as
tests/test_torch_bench.py writes one, and the pieces that hand it to the
JAX package's study scripts, which read Shelf from a fixed path, with
the oracle's run on it shared between the study tests; and what
keeps the suite's workers from slowing each other (`one_thread`) and from
tracing one JAX tracker program twice (`shared_jax_contexts`)."""
import contextlib
import dataclasses
import fcntl
import json
import os
import resource
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from multiview_motion_capture_torch.config import SHELF_BENCH
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
from multiview_motion_capture_tpu import tracker as JT
from multiview_motion_capture_tpu.cameras import CameraBank as JCameraBank

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import chip_smoke  # noqa: E402  (the scene writer the card's phases use)
from torch_oracle_cache import run_oracle_cached  # noqa: E402

# tests/test_torch_bench.py's scene (3 people, 5 views, seed 2); a
# detection is dropped with probability 0.05 there, and with 0.2 in the
# scene of the fragmentation and parity studies, so tracks die and respawn
N_FRAMES = 12
SCENE = dict(n_frames=N_FRAMES, n_people=3, n_views=5, seed=2)
DEATHS_DROP_PROB = 0.2
# the port's tests' CPU priority while they run (`one_thread`)
PORT_NICE = 10


def write_scene(root: Path, drop_prob: float = 0.05) -> Path:
    seq = synthetic_sequence(cfg=dataclasses.replace(SHELF_BENCH, max_frames=None),
                             drop_prob=drop_prob, **SCENE)
    chip_smoke.write_scene_files(seq, root, SCENE["n_frames"], kps_dir="kps_opn")
    return root


@contextlib.contextmanager
def _locked(path: Path):
    """An exclusive lock on `path` across the run's worker processes."""
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def shared_deaths_scene(tmp_path_factory) -> Path:
    """The scene at DEATHS_DROP_PROB, written once for the whole test run
    in a directory the run's workers share (the fragmentation and oracle
    parity study tests read it, so they can share one oracle run)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / "deaths_scene"
    with _locked(base / "deaths_scene.lock"):
        if not root.exists():
            tmp = base / "deaths_scene.tmp"
            write_scene(tmp, DEATHS_DROP_PROB)
            tmp.rename(root)
    return root


def shared_oracle(kps, valid, cams, n_frames, root: Path, use_ik: bool = True):
    """The port's copy of the scipy oracle on `shared_deaths_scene`'s
    scene, solved once a run (cached under `root / "oracle_cache"`, solved
    under the scene's lock while another worker may be waiting for it)."""
    with _locked(root.parent / "deaths_scene.lock"):
        return run_oracle_cached(kps, valid, cams, n_frames, root, root / "oracle_cache", use_ik)


class JaxCameras:
    """A JAX script's `CameraBank`, reading the scene's calibration."""

    def __init__(self, root: Path):
        self.root = root

    def from_json_dir(self, _path):
        return JCameraBank.from_json_dir(self.root / "calibs")


def _can_lower_priority() -> bool:
    """Whether this process may raise its threads' priority back after
    lowering it (root, or an RLIMIT_NICE that reaches nice 0)."""
    limit = resource.getrlimit(resource.RLIMIT_NICE)[0]
    return os.geteuid() == 0 or limit == resource.RLIM_INFINITY or limit >= 20


def _set_nice(value: int) -> None:
    """Every thread of this process to nice `value` (on Linux a priority
    is a thread's, and the pools' threads already exist)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.setpriority(os.PRIO_PROCESS, int(tid), value)
        except ProcessLookupError:     # the thread ended meanwhile
            pass


@contextlib.contextmanager
def one_thread():
    """One thread for torch and for the BLAS and OpenMP pools (the oracle's
    scipy solves, numpy), and this process's threads at nice PORT_NICE:
    the test suite runs several workers at once, and each pool's own
    threads would oversubscribe the cores.  The JAX package's tests run
    multi-threaded XLA programs that slow down many times over when their
    threads lose the cores to other workers (tests/test_appearance.py's
    crowd-identity test: 77 s alone, ~900 s in the six-worker run on an
    8-core CPU), so the port's tests, one thread each, yield to them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    nice = os.getpriority(os.PRIO_PROCESS, 0)
    lower = nice < PORT_NICE and _can_lower_priority()
    if lower:
        _set_nice(PORT_NICE)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(n)
        if lower:
            _set_nice(nice)


def json_of(text: str):
    """The one JSON object a script printed (after any other lines)."""
    return json.loads(text[text.index("{"):])


@contextlib.contextmanager
def shared_jax_contexts():
    """The JAX package's `TrackerContext.build` answered from a memo while
    the block runs: a build from equal cameras, config and `use_ik` (and no
    mesh) returns the context built first.  The JAX tracker caches its
    traced and compiled scan per context object, so runs of one program on
    equal inputs (the same rig, config and frame count) trace and compile
    it once.  The context is a pure function of those inputs."""
    real = JT.TrackerContext.build.__func__
    built = {}

    def build(cls, cams, cfg, use_ik=True, **kw):
        if any(v is not None for k, v in kw.items() if not k.endswith("_axis")):
            return real(cls, cams, cfg, use_ik, **kw)
        key = (cfg, use_ik, tuple(sorted(kw.items())),
               tuple(np.asarray(getattr(cams, f)).tobytes() for f in
                     ("K", "Rt", "P", "Kr_inv", "cam_loc", "img_wh")))
        if key not in built:
            built[key] = real(cls, cams, cfg, use_ik, **kw)
        return built[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT.TrackerContext, "build", classmethod(build))
        yield
