"""The two ways a cell's traffic drives the tracker, chosen by the traffic
file's `mode`:

- `offline`: a lab tracks a recorded take.  `tracker.run_offline` runs it
  in chunks of `chunk_frames`, each from the last one's state.  The window
  ends with the chunk during which `--seconds` passed, the device
  synchronised; `frames_per_s` is all its frames over all its time.
- `online`: an operator watches a live rig.  `MvTracker.update` takes one
  frame at a time from the host, and the next frame is sent once the last
  one's output is on the host (a closed loop).  Each frame's latency is
  the host clock around the call; `frame_latency_p95_ms` and
  `frame_latency_p50_ms` are over every frame of the window.

Warm-up tracks the take's first frames through the same path.  Should a
window reach the take's end, the take starts over from the empty state,
as a lab goes on to its next take (`take_starts` counts it).
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_frames(stacked) -> List[dict]:
    """A stacked numpy `FrameOutput` as one dict a frame."""
    n = stacked.track_id.shape[0]
    return [{k: getattr(stacked, k)[i] for k in stacked._fields} for i in range(n)]


class Offline:
    def __init__(self, cams, cfg, traffic: dict, take, dev: torch.device):
        from multiview_motion_capture_torch.tracker import TrackerContext

        self.dev, self.take = dev, take
        self.chunk = int(traffic["chunk_frames"])
        self.ctx = TrackerContext.build(cams, cfg, use_ik=bool(traffic["use_ik"]), device=dev)
        self.state = None
        self.next = 0
        self.chunks: List[Tuple[int, object]] = []   # (first take frame, stacked outputs)

    def _run(self, n: int) -> int:
        from multiview_motion_capture_torch.tracker import run_offline

        restart = self.next + n > self.take.kps.shape[0]
        if restart:
            self.state, self.next = None, 0          # the next take
        f = self.next
        self.state, out = run_offline(self.ctx, self.take.kps[f:f + n], self.take.valid[f:f + n],
                                      state=self.state)
        self.chunks.append((f, out))
        self.next = f + n
        return int(restart)

    def warm_up(self, n: int) -> None:
        self._run(n)
        _sync(self.dev)

    def window(self, seconds: float, tracer=None) -> Dict:
        frames = starts = 0
        if tracer is not None:
            tracer.start()
        t0 = time.perf_counter()
        while True:
            starts += self._run(self.chunk)
            frames += self.chunk
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.dev)
        dt = time.perf_counter() - t0
        if tracer is not None:
            tracer.stop()
        return {"window_s": dt, "take_starts": starts,
                "metrics": {"frames_per_s": frames / dt}}

    def outputs(self):
        from multiview_motion_capture_torch.tracker import outputs_to_numpy

        outs, ids = [], []
        for f, o in self.chunks:
            host = _host_frames(outputs_to_numpy(o))
            outs.extend(host)
            ids.extend(range(f, f + len(host)))
        return outs, ids

    def close(self) -> None:
        self.ctx = self.state = self.chunks = None


class Online:
    def __init__(self, cams, cfg, traffic: dict, take, dev: torch.device):
        from multiview_motion_capture_torch.tracker import MvTracker

        self.dev = dev
        # a live rig's detections reach the tracker from the host
        self.kps = take.kps.cpu().numpy()
        self.valid = take.valid.cpu().numpy()
        self.cfg = cfg
        self.trk = MvTracker(cams, cfg, use_ik=bool(traffic["use_ik"]), device=dev)
        self.next = 0
        self.ids: List[int] = []
        self.outs: List[object] = []

    def _frame(self) -> Tuple[float, int]:
        from multiview_motion_capture_torch.tracker import TrackerState

        start = 0
        if self.next >= self.kps.shape[0]:
            self.trk.state = TrackerState.zeros(self.cfg, device=self.trk.ctx.device)
            self.next, start = 0, 1
        f = self.next
        t0 = time.perf_counter()
        out = self.trk.update(f, self.kps[f], self.valid[f])
        dt = time.perf_counter() - t0
        self.outs.append(out)
        self.ids.append(f)
        self.next = f + 1
        return dt, start

    def warm_up(self, n: int) -> None:
        for _ in range(n):
            self._frame()

    def window(self, seconds: float, tracer=None) -> Dict:
        lat, starts = [], 0
        if tracer is not None:
            tracer.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            dt, s = self._frame()
            lat.append(dt)
            starts += s
        _sync(self.dev)
        window_s = time.perf_counter() - t0
        if tracer is not None:
            tracer.stop()
        ms = np.asarray(lat) * 1e3
        return {"window_s": window_s, "take_starts": starts,
                "metrics": {"frame_latency_p95_ms": float(np.percentile(ms, 95)),
                            "frame_latency_p50_ms": float(np.percentile(ms, 50))}}

    def outputs(self):
        outs = [{k: getattr(o, k) for k in o._fields} for o in self.outs]
        return outs, list(self.ids)

    def close(self) -> None:
        self.trk = None


DRIVERS = {"offline": Offline, "online": Online}
