"""The end-to-end metrics are taken over all of the window: frames/s is all
frames over all time, the latency percentiles are over every frame, so a
stalled stretch moves them."""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bench_support  # noqa: F401  (the checkout's root on the path)
from mocap_bench import drivers
from mocap_bench.scene import Take
from multiview_motion_capture_torch import tracker


def _offline(monkeypatch, stall_chunk):
    calls = []

    def fake_run_offline(ctx, kps, valid, state=None):
        time.sleep(0.004 * kps.shape[0] + (0.3 if len(calls) == stall_chunk else 0.0))
        calls.append(kps.shape[0])
        return state, None

    monkeypatch.setattr(tracker, "run_offline", fake_run_offline)
    d = drivers.Offline.__new__(drivers.Offline)
    d.dev, d.ctx, d.chunk, d.state, d.next, d.chunks = torch.device("cpu"), None, 4, None, 0, []
    d.take = Take(kps=torch.zeros(4000, 1, 1, 17, 3), valid=torch.zeros(4000, 1, 1, dtype=bool))
    t0 = time.perf_counter()
    res = d.window(0.6)
    return res, sum(calls), time.perf_counter() - t0


@pytest.mark.parametrize("stall", [False, True])
def test_offline_rate_is_all_frames_over_all_time(monkeypatch, stall):
    res, frames, wall = _offline(monkeypatch, 3 if stall else -1)
    fps = res["metrics"]["frames_per_s"]
    assert fps == pytest.approx(frames / res["window_s"], rel=1e-12)
    assert res["window_s"] <= wall
    # a chunk of 4 frames takes 16 ms: 250 frames/s unstalled; the 0.3 s
    # stall inside a ~0.6 s window takes about half of it
    assert (fps < 0.7 * 250) if stall else (fps > 0.7 * 250)


def _online(monkeypatch, stalls):
    lat = []

    class FakeTracker:
        def update(self, f, kps, valid):
            dt = 0.1 if len(lat) in stalls else 0.004
            t0 = time.perf_counter()
            time.sleep(dt)
            lat.append(time.perf_counter() - t0)
            return SimpleNamespace(_fields=())

    d = drivers.Online.__new__(drivers.Online)
    d.dev, d.trk, d.next, d.ids, d.outs = torch.device("cpu"), FakeTracker(), 0, [], []
    d.kps, d.valid = np.zeros((4000, 1, 1, 17, 3)), np.zeros((4000, 1, 1), bool)
    res = d.window(0.5)
    return res, np.asarray(lat) * 1e3


def test_online_percentiles_are_over_every_frame(monkeypatch):
    res, lat = _online(monkeypatch, stalls=())
    quiet = res["metrics"]
    assert quiet["frame_latency_p50_ms"] < 20 and quiet["frame_latency_p95_ms"] < 20
    # four stalls of 100 ms among ~60 frames lie beyond the 95th percentile
    res, lat = _online(monkeypatch, stalls=(3, 10, 20, 30))
    m = res["metrics"]
    assert m["frame_latency_p95_ms"] > 50
    assert m["frame_latency_p50_ms"] < 20
    assert m["frame_latency_p95_ms"] == pytest.approx(np.percentile(lat, 95), rel=0.2)
