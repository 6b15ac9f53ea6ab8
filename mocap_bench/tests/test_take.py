"""A take is the same for a seed and differs across seeds."""
import torch

import bench_support  # noqa: F401  (the checkout's root on the path)
from mocap_bench import scene
from mocap_bench.spec import load_cell


def _take(seed, frames=6):
    cell = load_cell("rig32-tri-online")
    rig = dict(cell.config["rig"], views=6)
    cal = scene.camera_ring(rig)
    return scene.make_take(cal, cell.traffic["scene"], 10, frames, seed, "cpu")


def test_same_seed_same_take():
    a, b = _take(2**31 + 5), _take(2**31 + 5)
    assert torch.equal(a.kps, b.kps) and torch.equal(a.valid, b.valid)


def test_other_seed_other_take():
    a, b = _take(3), _take(4)
    assert not torch.equal(a.kps, b.kps)


def test_take_is_packed():
    t = _take(11, frames=20)
    # each view's detections fill its first slots; dropped ones are ~5%
    v = t.valid
    assert not (v[..., 1:] & ~v[..., :-1]).any()
    assert 0.85 < v.float().mean() < 1.0
    uv = t.kps[..., :2][v].reshape(-1, 2)
    # people walk within 2.2 m of the centre of a 4 m ring: most of each
    # skeleton is in the 1032 x 776 image
    inside = (uv[:, 0] > 0) & (uv[:, 0] < 1032) & (uv[:, 1] > 0) & (uv[:, 1] < 776)
    assert uv.isfinite().all() and inside.float().mean() > 0.9
    s = t.kps[..., 2][v]
    assert (s >= 0.55).all() and (s <= 0.95).all()
