"""Sequences-to-devices serving: B independent camera streams, the devices
of a mesh tracking their share concurrently.

Port of `multiview_motion_capture_tpu/parallel/streams.py`.  The B streams
are split into contiguous blocks over the mesh's entries; each entry runs
`tracker.run_offline` on its streams one after another, with its own copy
of the context on its device, in a worker thread of its own and on a CUDA
stream of its own (one per entry), so that distinct GPUs overlap their
host-bound step loops.  No tensor crosses between streams: each stream's
output equals `run_offline` on that stream alone, bit for bit.

What the workers share is made safe for threads: the kernels' lazy build
and launch counts (`ops/cuda_lib`, under locks), the per-device constant
cache (`ops/consts`, locked), the launch-shape caches (keyed by device);
`utils/precision.high_precision` runs once here, before the threads start.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import torch

from multiview_motion_capture_torch.parallel.mesh import Mesh
from multiview_motion_capture_torch.parallel.sharded_solvers import make_axis_mesh
from multiview_motion_capture_torch.tracker import (
    FrameOutput,
    Tracklet,
    TrackerContext,
    TrackerState,
    assemble_tracklets,
    run_offline,
)
from multiview_motion_capture_torch.utils.precision import high_precision


def make_streams_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-axis mesh named 'streams' over (the first) n_devices devices."""
    return make_axis_mesh(n_devices, "streams", devices)


def run_offline_streams(ctx: TrackerContext, kps, valid, mesh: Mesh,
                        axis: str = "streams"):
    """Track B sequences concurrently, sharded over `mesh[axis]`.

    kps: (B, F, V, P, K, 3); valid: (B, F, V, P); B divisible by the axis
    size.  Every stream shares the rig (same calibration: the serving case
    of many replays or feeds of one installation).  Returns (final states,
    a `TrackerState` with a leading (B,) axis; the stacked `FrameOutput`
    with leading (B, F) axes), both on the context's device."""
    if ctx.mesh is not None:
        raise ValueError(
            "stream serving shards the *stream* axis; build the "
            "TrackerContext without a camera-sharding mesh (ctx.mesh=None)"
        )
    B = kps.shape[0]
    devices = mesh.axis_devices(axis)
    n_shard = len(devices)
    if B % n_shard != 0:
        raise ValueError(f"B={B} streams not divisible by mesh axis "
                         f"{axis}={n_shard}")
    high_precision()
    per = B // n_shard
    # intra-op threads are set per OS thread: the workers keep the caller's
    n_threads = torch.get_num_threads()
    # each worker's stream first waits for the caller's work on its device
    # (the context's constants may still be in flight there)
    caller_streams = {d: torch.cuda.current_stream(dev)
                      for d, dev in enumerate(devices) if dev.type == "cuda"}
    results: List[Optional[list]] = [None] * n_shard
    errors: List[BaseException] = []

    def track(d: int, dev: torch.device) -> list:
        ctx_d = ctx.to(dev)
        return [run_offline(ctx_d, kps[b], valid[b]) for b in range(d * per, (d + 1) * per)]

    def worker(d: int, dev: torch.device) -> None:
        try:
            torch.set_num_threads(n_threads)
            if dev.type == "cuda":
                stream = torch.cuda.Stream(dev)
                stream.wait_stream(caller_streams[d])
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    results[d] = track(d, dev)
                stream.synchronize()
            else:
                results[d] = track(d, dev)
        except BaseException as e:   # re-raised in the calling thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(d, dev), name=f"stream-{d}")
               for d, dev in enumerate(devices)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    pairs = [p for outs in results for p in outs]
    home = ctx.device
    states = TrackerState(**{f: torch.stack([getattr(s, f).to(home) for s, _ in pairs])
                             for f in TrackerState.__dataclass_fields__})
    out = FrameOutput(*[torch.stack([getattr(o, f).to(home) for _, o in pairs])
                        for f in FrameOutput._fields])
    return states, out


def assemble_stream_tracklets(out: FrameOutput) -> List[List[Tracklet]]:
    """Split the stacked (B, F, ...) emissions into per-stream tracklets."""
    B = out.track_id.shape[0]
    return [assemble_tracklets(FrameOutput(*[getattr(out, f)[b] for f in FrameOutput._fields]))
            for b in range(B)]
