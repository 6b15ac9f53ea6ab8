"""Faults planted under the timed path, to see the judge say `correct` is
false: each wraps the tracker's per-frame step (`tracker.make_step`, which
`run_offline` and `MvTracker` both build).  The cells run on one chip, so
there is no exchange between chips to leave out."""
from __future__ import annotations

import contextlib


def state_unchanged(step):
    """The step returns the state it was given."""
    def s(state, kps, valid, app=None):
        _, out = step(state, kps, valid, app)
        return state, out
    return s


def half_the_views(step):
    """Half of the batch left out: every other view's detections dropped."""
    def s(state, kps, valid, app=None):
        valid = valid.clone()
        valid[::2] = False
        return step(state, kps, valid, app)
    return s


def pose_altered(step):
    """An answer altered where it is produced: 1 mm on one coordinate of
    each updated track's pose."""
    def s(state, kps, valid, app=None):
        new, out = step(state, kps, valid, app)
        bump = out.pose3d.new_zeros(out.pose3d.shape)
        bump[:, 0, 0] = 1e-3 * out.updated.to(bump.dtype)
        return new, out._replace(pose3d=out.pose3d + bump)
    return s


def match_altered(step):
    """An answer altered where it is produced: each updated track's match in
    the first view dropped from the output."""
    def s(state, kps, valid, app=None):
        new, out = step(state, kps, valid, app)
        m = out.matched_pose.clone()
        m[:, 0] = m[:, 0].where(~out.updated, m.new_full((), -1))
        return new, out._replace(matched_pose=m)
    return s


FAULTS = {"state_unchanged": state_unchanged, "half_the_views": half_the_views,
          "pose_altered": pose_altered, "match_altered": match_altered}


@contextlib.contextmanager
def planted(name: str):
    """The tracker's step broken by fault `name` while the block runs."""
    from multiview_motion_capture_torch import tracker

    make_step = tracker.make_step
    tracker.make_step = lambda ctx: FAULTS[name](make_step(ctx))
    try:
        yield
    finally:
        tracker.make_step = make_step
