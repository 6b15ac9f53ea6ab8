"""Whether what the timed path produced is correct: the program's frames
judged against the plain reference (`reference.py`).

The tracker's decisions near an ALS tie depend on every rounding, so a
whole take run twice in two programs parts for good after the first tie.
The judge therefore follows the program frame by frame: the state before
frame t is the one the program's own outputs up to frame t - 1 carry
(slots, ids, poses, scores, roots as output; hits, frames since the last
update and the next id counted from the outputs' update and spawn flags),
and the reference steps frame t from it.  The take's first frame is judged
from the empty state, as the program starts.  Numbers compared over the
judged frames:

- `decisions_differ`: the share of judged (frame, slot) pairs whose
  decisions differ: matched detections, track id, state, updated,
  spawned, died id;
- `pose_err_ulp_mean`: over the slots updated or spawned with the same
  decisions, the mean error of a pose coordinate against the reference's
  unrounded value, in units of float32's spacing there (the program
  computes in float64 and rounds once: at most 0.5 a value, about 0.25 on
  average).  Joints whose triangulation's condition number passes
  COND_MAX (rays near parallel) are left out, by that rule on the
  reference's own solve: there the last bits of any float64 order of
  operations reach the float32 value.  A mean, not the largest, so that a
  rare value just under the rule does not decide alone;
- `score_err_ulp_max`: the largest error of a joint score in the same
  units (a mean of the views' scores, well conditioned: at most 0.5);
- `frames_judged`: at least the limit.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from mocap_bench import reference as ref

# coordinates (m) and scores nearer zero are measured in float32 units at this
ULP_FLOOR = 0.01
# past this condition number of a triangulation's normal matrix, two float64
# orders of operations can part by a fiftieth of a float32 unit (2^-53 * 1e7
# against 2^-24) and more
COND_MAX = 1e7
DECISIONS = ("matched_pose", "track_id", "active", "updated", "spawned", "died_track_id")


def carry(st: ref.RefState, out: dict) -> ref.RefState:
    """The state after a frame, from the state before it and the program's
    outputs of that frame."""
    upd, spawned = np.asarray(out["updated"], bool), np.asarray(out["spawned"], bool)
    tsu = st.tsu + (st.active > 0)
    hits = np.where(spawned, 1, np.where(upd & ~spawned, st.hits + 1, st.hits))
    return ref.RefState(
        active=np.asarray(out["active"], np.int64), track_id=np.asarray(out["track_id"], np.int64),
        hits=hits, tsu=np.where(upd, 0, tsu),
        pose3d=np.asarray(out["pose3d"], np.float32),
        score=np.asarray(out["pose3d_score"], np.float32),
        root=np.asarray(out["root"], np.float32),
        next_id=int(st.next_id + spawned.sum()))


def ulp_errors(exact: np.ndarray, got: np.ndarray) -> np.ndarray:
    """|got - exact| in units of float32's spacing at |exact| (at least at
    ULP_FLOOR), one a value: a result computed in float64 and rounded once
    to float32 reads at most 0.5, about 0.25 on average."""
    exact = np.asarray(exact, np.float64).ravel()
    unit = np.spacing(np.maximum(np.abs(exact), ULP_FLOOR).astype(np.float32)).astype(np.float64)
    err = np.abs(np.asarray(got, np.float64).ravel() - exact) / unit
    return np.nan_to_num(err, nan=np.inf)


def compare(mine: dict, theirs: dict) -> Dict[str, float]:
    """One frame: slots whose decisions differ, slots compared, and over
    the updated slots that agree, the errors of the pose coordinates and
    the joint scores in float32 units against the reference's unrounded
    values (their sums, counts and largest)."""
    T = len(theirs["active"])
    differ = np.zeros(T, bool)
    for k in DECISIONS:
        a, b = np.asarray(mine[k]).reshape(T, -1), np.asarray(theirs[k]).reshape(T, -1)
        differ |= (a != b).any(1)
    both = ~differ & np.asarray(theirs["updated"], bool)
    # joints whose triangulation is too ill-conditioned for float64 to fix
    # their float32 value are left out of the pose's numbers, and counted
    sound = both[:, None] & (np.asarray(mine["pose_cond"]) <= COND_MAX)
    ill = both[:, None] & ~sound
    ill_err = ulp_errors(np.asarray(mine["pose3d_exact"])[ill], np.asarray(theirs["pose3d"])[ill])
    out = {"differ": int(differ.sum()), "slots": T, "ill": int(ill.sum()),
           "ill_max": float(ill_err.max()) if ill_err.size else 0.0}
    for name, e, g, m in (("pose", "pose3d_exact", "pose3d", sound),
                          ("score", "score_exact", "pose3d_score", both)):
        err = ulp_errors(np.asarray(mine[e])[m], np.asarray(theirs[g])[m])
        out[name] = (float(err.sum()), err.size, float(err.max()) if err.size else 0.0)
    return out


def judge(rc: ref.RefContext, kps: np.ndarray, valid: np.ndarray, frame_ids: Sequence[int],
          outputs: List[dict], judged: Sequence[int]) -> Dict[str, float]:
    """Judge the program's output frames `judged` (indices into `outputs`).
    `outputs[i]` is the program's output of take frame `frame_ids[i]`; a
    frame id of 0 starts the take from the empty state.  Returns the numbers
    compared, the ALS iterations of both sides over the judged frames, and
    each frame whose decisions differ: [output index, take frame, slots,
    the program's ALS iterations, the reference's]."""
    want = set(int(i) for i in judged)
    st = ref.RefState.zeros(rc.T)
    differ = slots = ill = 0
    ill_max = 0.0
    err = {"pose": [0.0, 0, 0.0], "score": [0.0, 0, 0.0]}
    iters_prog = iters_ref = 0
    differing = []
    for i, (f, out) in enumerate(zip(frame_ids, outputs)):
        if f == 0:
            st = ref.RefState.zeros(rc.T)
        if i in want:
            _, mine = ref.step(rc, st, kps[f], valid[f])
            c = compare(mine, out)
            differ += c["differ"]
            slots += c["slots"]
            ill += c["ill"]
            ill_max = max(ill_max, c["ill_max"])
            for k in err:
                total, n, top = c[k]
                err[k] = [err[k][0] + total, err[k][1] + n, max(err[k][2], top)]
            if c["differ"]:
                differing.append([i, f, c["differ"], int(out["als_iters"]), int(mine["als_iters"])])
            iters_prog += int(out["als_iters"])
            iters_ref += int(mine["als_iters"])
        st = carry(st, out)
    return {"decisions_differ": differ / max(slots, 1),
            "pose_err_ulp_mean": err["pose"][0] / max(err["pose"][1], 1),
            "score_err_ulp_max": err["score"][2],
            "frames_judged": len(want),
            "pose_err_ulp_max": err["pose"][2],
            "score_err_ulp_mean": err["score"][0] / max(err["score"][1], 1),
            "values_compared": err["pose"][1] + err["score"][1],
            "pose_values_ill_conditioned": ill, "pose_err_ulp_max_ill_conditioned": ill_max,
            "als_iters_program": iters_prog, "als_iters_reference": iters_ref,
            "frames_differing": differing}


def sample(window: Sequence[int], n: int, seed: int) -> List[int]:
    """The take's first frame (where it is in the outputs) and `n` window
    frames drawn from the seed."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pick = rng.choice(np.asarray(window), size=min(n, len(window)), replace=False)
    return sorted(set(int(i) for i in pick))


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]) -> bool:
    """Every number within its limit: `max` for a gap or a share, `min`
    for a count."""
    ok = True
    for name, lim in limits.items():
        v = numbers[name]
        if "max" in lim:
            ok &= bool(np.isfinite(v) and v <= lim["max"])
        if "min" in lim:
            ok &= bool(v >= lim["min"])
    return ok
