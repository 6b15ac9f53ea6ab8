"""The port's spans (`utils/profiling`: `span`, `recording`) and the span
report's attribution (`scripts/torch_span_report.py`), on the CPU at the
benchmark's small sizes (`mocap_bench/tests/bench_support.py`).

- Off, `span` is one shared no-op and nothing is recorded.
- `run_offline` on a 2-cluster rig and `MvTracker.update` on a
  single-matrix rig give bit-equal outputs with spans on and off, and
  record one `step` a frame with the layers' spans under it, whose self
  times add up to the step's duration.
- A span brackets the profiler's record of the region inside it (one
  clock); two threads' spans never nest into each other;
  `TrackerContext.build` is one `setup.context`; a `StageTimer` stage is a
  span.
- The report puts kernels, synchronising calls and idle gaps down to the
  spans of hand-made records, and reads the self-time metrics.
"""
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from multiview_motion_capture_torch.cameras import CameraBank
from multiview_motion_capture_torch.config import PipelineConfig
from multiview_motion_capture_torch.tracker import (
    MvTracker,
    TrackerContext,
    run_offline,
)
from multiview_motion_capture_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "mocap_bench" / "tests"))
import torch_span_report as report  # noqa: E402
from tests.torch_study_scene import one_thread  # noqa: E402

FRAMES = 4
SEED = 2**31 + 11
CELLS = {"offline": "dome128-tri-offline", "online": "rig32-tri-online"}
# the spans under one frame's step, by path
CHILDREN = {
    "offline": {"step": ["step.similarity", "step.als", "step.merge", "step.update"],
                "step.update": ["step.groups", "step.pose"]},
    "online": {"step": ["step.similarity", "step.als", "step.update"],
               "step.update": ["step.groups", "step.pose"]},
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _small(path: str):
    """The cell's pipeline config, cameras and a CPU take of FRAMES frames
    at bench_support's small size."""
    import bench_support
    from mocap_bench import scene, spec

    cell = bench_support.small_cell(CELLS[path])
    pipeline, rig, _, scn = spec.merged(cell, bench_support.SMALL[cell.name])
    cal = scene.camera_ring(rig)
    cfg = PipelineConfig(**pipeline)
    take = scene.make_take(cal, scn, cfg.max_people, FRAMES, SEED, "cpu")
    return cfg, CameraBank.from_k_rt(cal.K, cal.Rt, cal.wh), take


def _track(path: str, cfg, cams, take):
    """Each frame's output fields as numpy arrays."""
    if path == "offline":
        ctx = TrackerContext.build(cams, cfg, use_ik=False, device="cpu")
        _, out = run_offline(ctx, take.kps, take.valid)
        return [[np.asarray(f[i]) for f in out] for i in range(FRAMES)]
    trk = MvTracker(cams, cfg, use_ik=False, device="cpu")
    kps, valid = take.kps.numpy(), take.valid.numpy()
    return [list(trk.update(f, kps[f], valid[f])) for f in range(FRAMES)]


@pytest.fixture(scope="module")
def runs():
    """Per path: outputs with spans off, outputs and records with spans on."""
    out = {}
    for path in CELLS:
        cfg, cams, take = _small(path)
        off = _track(path, cfg, cams, take)
        with profiling.recording() as rec:
            on = _track(path, cfg, cams, take)
        out[path] = (off, on, rec.closed())
    return out


def test_span_is_a_shared_noop_when_off():
    assert profiling._RECORDER is None
    assert profiling.span("step") is profiling.span("step.als", frame=True) is profiling._NOOP
    with profiling.recording() as rec:
        with profiling.span("a"):
            pass
    with profiling.span("b"):
        pass
    assert profiling.span("c") is profiling._NOOP
    assert [r.name for r in rec.records] == ["a"]
    with profiling.recording():
        with pytest.raises(RuntimeError, match="already"):
            with profiling.recording():
                pass


@pytest.mark.parametrize("path", sorted(CELLS))
def test_outputs_bit_equal_with_spans_on_and_off(runs, path):
    off, on, _ = runs[path]
    assert len(off) == len(on) == FRAMES
    for a, b in zip(off, on):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True)


@pytest.mark.parametrize("path", sorted(CELLS))
def test_one_step_a_frame_with_its_layers(runs, path):
    _, _, records = runs[path]
    steps = [r for r in records if r.name == "step"]
    assert len(steps) == FRAMES
    assert sorted(r.frame for r in steps) == list(range(FRAMES))
    entry = "offline.chunk" if path == "offline" else "online.frame"
    assert {r.parent.name for r in steps} == {entry}
    if path == "online":
        for frame in {r.parent for r in steps}:
            assert [r.name for r in records if r.parent is frame] == [
                "online.input", "step", "online.output"]
    by_parent = {}
    for r in records:
        by_parent.setdefault(id(r.parent), []).append(r)
    for step in steps:
        under, todo = [], [step]
        while todo:
            r = todo.pop()
            kids = by_parent.get(id(r), [])
            if r.name in CHILDREN[path]:
                assert [k.name for k in kids] == CHILDREN[path][r.name], r.name
            else:
                assert kids == [], r.name
            under.extend(kids)
            todo.extend(kids)
        assert all(r.frame == step.frame and r.thread == step.thread for r in under)
        assert step.self_ns + sum(r.self_ns for r in under) == step.duration_ns
        assert all(r.self_ns >= 0 for r in under + [step])
    assert not any(r.name == "setup.kernels" for r in records)   # plain kernels here


def test_span_brackets_the_profilers_record_of_its_region():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profiling.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with record_function("region"):
                torch.ones(64).cumsum(0)
    (outer,) = rec.records
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "region"]
    assert outer.start_ns <= ev.start_ns() <= ev.end_ns() <= outer.end_ns
    # the same clock, not merely an ordering: the span is tight around it
    assert outer.duration_ns < 1e9


def test_spans_of_two_threads_do_not_nest():
    barrier = threading.Barrier(2, timeout=30)

    def work():
        with profiling.span("outer"):
            barrier.wait()
            with profiling.span("inner"):
                barrier.wait()
            barrier.wait()

    with profiling.recording() as rec:
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    outer = [r for r in rec.records if r.name == "outer"]
    inner = [r for r in rec.records if r.name == "inner"]
    assert len(outer) == len(inner) == 2 and len({r.thread for r in outer}) == 2
    assert all(r.parent is None for r in outer)
    assert all(r.parent.name == "outer" and r.parent.thread == r.thread for r in inner)
    # both threads were inside "outer" together, so a shared stack would
    # have nested one thread's outer span into the other's
    assert max(r.start_ns for r in outer) < min(r.end_ns for r in outer)


def test_context_build_is_one_setup_span():
    cfg, cams, _ = _small("online")
    with profiling.recording() as rec:
        TrackerContext.build(cams, cfg, use_ik=False, device="cpu")
    (r,) = rec.records
    assert (r.name, r.parent, r.frame) == ("setup.context", None, None)
    assert rec.summary()["setup.context"]["count"] == 1


def test_stage_timer_stage_is_a_span():
    timer = profiling.StageTimer(device="cpu")
    with profiling.recording() as rec:
        with timer.stage("track"):
            with profiling.span("step", frame=True):
                pass
    assert [(r.name, r.parent and r.parent.name) for r in rec.records] == [
        ("track", None), ("step", "track")]
    assert timer.counts() == {"track": 1}


def _rec(name, start, end, parent=None, frame=None):
    r = profiling.SpanRecord(name, start, parent, 1, frame)
    r.end_ns = end
    if parent is not None:
        parent.child_ns += end - start
    return r


def test_report_attributes_kernels_syncs_and_idle_to_spans():
    chunk = _rec("offline.chunk", 0, 950)
    s0 = _rec("step", 100, 400, chunk, 0)
    sim = _rec("step.similarity", 120, 200, s0, 0)
    upd = _rec("step.update", 250, 380, s0, 0)
    pose = _rec("step.pose", 300, 350, upd, 0)
    s1 = _rec("step", 500, 800, chunk, 1)
    records = [chunk, s0, sim, upd, pose, s1]
    assert (chunk.self_ns, s0.self_ns, upd.self_ns, pose.self_ns) == (350, 90, 80, 50)

    launches = {1: 150, 2: 310, 3: 320, 4: 450, 5: 600, 6: 900}
    # kernel 4 is launched between steps; 7 has no launch call in the
    # trace; 8 starts before the window
    kernels = [(1, 160, 40), (2, 330, 20), (3, 355, 5), (4, 460, 30), (5, 610, 90),
               (6, 905, 10), (7, 930, 10), (8, -50, 40)]
    syncs = [260, 340, 960, 2000]
    from mocap_bench.trace import _union

    busy = _union([(s, s + d) for _, s, d in kernels])
    w0, w1 = 0, 1000
    a = report.attribute(records, w0, w1, kernels, launches, syncs, busy)
    rows = a["rows"]
    assert rows["step.similarity"]["kernels"] == 1 and rows["step.pose"]["kernels"] == 2
    assert rows["offline.chunk"]["kernels"] == 2 and rows["step"]["kernels"] == 1
    assert a["unmatched"] == 1 and a["kernels_checked"] == 4 and a["kernels_early"] == 0
    assert a["before_launch"] == 0 and a["early_max_ns"] == 0
    assert rows["step.update"]["syncs"] == 1 and rows["step.pose"]["syncs"] == 1
    assert rows[report.NONE]["syncs"] == 1   # 960: after the chunk, inside the window
    # idle: [0,160) [200,330) [350,355) [360,460) [490,610) [700,905) [915,930) [940,1000]
    gaps = report.idle_gaps(busy, w0, w1)
    assert gaps == [(0, 160), (200, 330), (350, 355), (360, 460), (490, 610), (700, 905),
                    (915, 930), (940, 1000)]
    # midpoints 80 chunk, 265 update, 352 update (pose ended at 350), 410
    # chunk, 550 step 1, 802 chunk, 922 chunk, 970 none
    assert rows["offline.chunk"]["idle_ns"] == 160 + 100 + 205 + 15
    assert rows["step.update"]["idle_ns"] == 130 + 5 and rows["step.pose"]["idle_ns"] == 0
    assert rows["step"]["idle_ns"] == 120 and rows[report.NONE]["idle_ns"] == 60
    assert a["idle_ns"] == sum(b - a_ for a_, b in gaps) == 795
    assert a["idle_outside_step_ns"] == 160 + 100 + 205 + 15 + 60
    assert rows["step"]["entries"] == 2 and rows["step"]["self_ns"] == 90 + 300

    r = report.readings(rows, 2, a["idle_ns"], a["idle_outside_step_ns"])
    assert r["similarity_host_ms_per_frame"] == pytest.approx(80 / 1e6 / 2)
    assert r["update_host_ms_per_frame"] == pytest.approx(80 / 1e6 / 2)
    assert r["pose_host_ms_per_frame"] == pytest.approx(50 / 1e6 / 2)
    assert r["idle_outside_step_pct"] == pytest.approx(100 * 540 / 795)
    assert "groups_host_ms_per_frame" not in r and "host_io_ms_per_frame" not in r


def test_report_flags_a_kernel_before_its_step():
    s0 = _rec("step", 100, 400, None, 0)
    # kernel 1 is launched in the step at 150 and read to start at 90: the
    # device clock behind the host's by 60 ns at least
    a = report.attribute([s0], 0, 500, [(1, 90, 5), (2, 200, 5)], {1: 150, 2: 160}, [],
                         [(90, 95), (200, 205)])
    assert a["kernels_checked"] == 2 and a["kernels_early"] == 1 and a["early_max_ns"] == 10
    assert a["before_launch"] == 1 and a["before_launch_max_ns"] == 60


@pytest.mark.parametrize("path", sorted(CELLS))
def test_report_reads_each_layer_on_the_cpu(path):
    import bench_support

    cell = bench_support.small_cell(CELLS[path])
    out = report.run(cell, SEED, 0.2, "spans", device="cpu", t_start=time.perf_counter(),
                     overrides=bench_support.SMALL[cell.name])
    assert out["steps"] == out["frames"] > 0
    want = {"similarity_host_ms_per_frame", "groups_host_ms_per_frame",
            "update_host_ms_per_frame", "pose_host_ms_per_frame"}
    if path == "online":
        want.add("host_io_ms_per_frame")
    assert set(out["readings"]) == want and all(v > 0 for v in out["readings"].values())
    assert out["setup"]["setup.context"] > 0 and out["setup"]["setup.kernels"] is None
