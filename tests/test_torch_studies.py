"""The LM iteration study of the port against the JAX package on the CPU
(the LM's count itself: tests/test_torch_lm_return_iters.py; the other
studies: tests/test_torch_{bisect,fragmentation,oracle_parity,identity,
appearance_e2e}_study.py and tests/test_torch_detector_studies.py).

- `scripts/torch_ik_iteration_study.py` against `scripts/
  ik_iteration_study.py` on an 8-view, 3-person, 2-cluster rig with
  `ik_max_views=4` over 6 frames (the JAX script's constants and config
  set by monkeypatch): the replays' decisions equal, and every warm solve
  the JAX script makes given to the port's `warm_iters` on the same
  inputs (JAX's pre-states, matches and view cap).
- Their iteration counts part where the JAX package's float32 cost
  cannot resolve the convergence test: near its minimum a slot's cost
  falls by about ftol (2e-6) of itself, at float32's rounding of a sum of
  a few hundred squares, so JAX's step may read as a rise ("not better")
  and the slot runs on, while the port's float64 cost
  (utils/precision.WORK_DTYPE) reads the small fall and freezes it.  JAX's
  own count moves with its rounding: its loop body compiled alone
  (`jax_lm_trace`) stops some of these calls an iteration before its
  `while_loop` does.  So the test holds: the port's count never above
  JAX's; where they part, the body alone stops between the two counts,
  and from the port's last iteration on every slot JAX kept active
  changed its cost by at most GAIN_TOL_FTOL ftol (the margins, printed
  per call: 13 of 20 calls part here, at most 5.9 ftol).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch.ops import fk as TF
from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
from multiview_motion_capture_tpu.ops import ik as JK
from multiview_motion_capture_tpu.ops.solve_pallas import batched_spd_solve as j_solve

from tests.torch_study_scene import one_thread

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import ik_iteration_study as j_ik_study  # noqa: E402
import torch_ik_iteration_study as t_ik_study  # noqa: E402

# the JAX scripts set the compilation cache at import; keep the suite's
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")

DECISIONS = ("track_id", "active", "updated", "spawned", "died_track_id", "matched_pose")
GAIN_TOL_FTOL = 10.0     # |cost change| / (ftol * cost) of a slot JAX ran on
IK_RIG = dict(n_views=8, n_people=3, n_frames=6, ik_max_views=4)


def t(a):
    return torch.as_tensor(np.array(a))


def _jax_lm_body(x, r, lam, active, skel, obs, view_w, P, free, ftol, xtol):
    """The JAX package's batched LM body (ops/ik.py:397-433 there), compiled
    alone, also returning each slot's gain / (ftol * cost), where gain is
    the cost's fall that step."""
    p_ax = 0 if P.ndim == 4 else None
    rj = jax.vmap(JK._residual_and_jacobian, in_axes=(0, None, 0, 0, p_ax, None))
    rb = jax.vmap(JK._residual, in_axes=(0, None, 0, 0, p_ax, None))
    n = x.shape[1]
    _, J = rj(x, skel, obs, view_w, P, 1e-5)
    J = J * free[None, None, :]
    JtJ = jnp.einsum("trd,tre->tde", J, J)
    g = jnp.einsum("trd,tr->td", J, r)
    ridge = 1e-6 * (jnp.trace(JtJ, axis1=1, axis2=2) / n) + 1e-6
    A = JtJ + (lam + ridge)[:, None, None] * jnp.eye(n, dtype=x.dtype) + jnp.diag(1.0 - free)[None]
    dx = -j_solve(A, g, interpret=True) * free[None, :]
    x_new = x + dx
    r_new = rb(x_new, skel, obs, view_w, P, 1e-5)
    c_old, c_new = jnp.sum(r * r, axis=1), jnp.sum(r_new * r_new, axis=1)
    better = (c_new < c_old) & jnp.isfinite(c_new) & active
    x = jnp.where(better[:, None], x_new, x)
    r = jnp.where(better[:, None], r_new, r)
    lam = jnp.where(active, jnp.where(better, jnp.maximum(lam * 0.33, 1e-6),
                                      jnp.minimum(lam * 10.0, 1e6)), lam)
    small_gain = (c_old - c_new) <= ftol * (c_old + 1e-20)
    small_step = jnp.max(jnp.abs(dx), axis=1) <= xtol * (1.0 + jnp.max(jnp.abs(x), axis=1))
    gain = (c_old - c_new) / (ftol * c_old)
    return x, r, lam, active & ~(better & (small_gain | small_step)), gain


def jax_lm_trace(x0, skel, obs, view_w, P, free, n_iters, ftol, xtol):
    """The JAX package's LM loop one compiled body at a time: each executed
    iteration's (active, gain / (ftol * cost)) per slot, and the end x."""
    rb = jax.vmap(JK._residual, in_axes=(0, None, 0, 0, 0 if P.ndim == 4 else None, None))
    body = jax.jit(_jax_lm_body, static_argnames=("ftol", "xtol"))
    obs = JK.add_mid_spine(obs)
    x, r = x0, rb(x0, skel, obs, view_w, P, 1e-5)
    lam = jnp.full((x0.shape[0],), 1e-3, x0.dtype)
    active = jnp.sum(view_w, axis=1) > 0
    trace = []
    for _ in range(n_iters):
        if not bool(jnp.any(active)):
            break
        was = np.asarray(active)
        x, r, lam, active, gain = body(x, r, lam, active, skel, obs, view_w, P, free,
                                       ftol=ftol, xtol=xtol)
        trace.append((was, np.asarray(gain)))
    return trace, x


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def ik_study():
    """Both scripts on IK_RIG: the JAX script's replays and warm solves
    (inputs and counts), the port's line and outputs."""
    rig = IK_RIG
    replays, calls = [], []
    real_replay, real_warm = j_ik_study.replay_states, j_ik_study._warm_iters

    def replay(*a):
        out = real_replay(*a)
        replays.append(out)
        return out

    def warm(*a):
        out = real_warm(*a)
        calls.append((a, out))
        return out

    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ik_study, "N_VIEWS", rig["n_views"])
        mp.setattr(j_ik_study, "N_PEOPLE", rig["n_people"])
        mp.setattr(j_ik_study, "N_FRAMES", rig["n_frames"])
        mp.setattr(j_ik_study, "PipelineConfig",
                   lambda **kw: JConfig(**{**kw, "ik_max_views": rig["ik_max_views"]}))
        mp.setattr(j_ik_study, "replay_states", replay)
        mp.setattr(j_ik_study, "_warm_iters", warm)
        j_ik_study.main()
        line = t_ik_study.main(["--cpu"], ik_max_views=rig["ik_max_views"], outputs=outs,
                               **{k: rig[k] for k in ("n_views", "n_people", "n_frames")})
    return dict(replays=replays, calls=calls, outs=outs, line=line)


def _label(stages, ftol, xtol, budget):
    return next(k for k, v in t_ik_study.VARIANTS.items() if v == (stages, ftol, xtol, budget))


def test_ik_study_replays_and_calls_match_jax(ik_study):
    (_, j_outs), = ik_study["replays"]
    for name in DECISIONS:
        np.testing.assert_array_equal(getattr(ik_study["outs"]["outs"], name),
                                      np.asarray(getattr(j_outs, name)), err_msg=name)
    n_update = int(sum((np.asarray(j_outs.updated) & ~np.asarray(j_outs.spawned)).any(1)))
    assert len(ik_study["calls"]) == n_update * len(t_ik_study.VARIANTS) > 0
    assert set(ik_study["line"]["extra"]) == {"rig"} | set(t_ik_study.VARIANTS)


@pytest.mark.parametrize("variant", list(t_ik_study.VARIANTS))
def test_ik_iteration_study_matches_jax(ik_study, variant):
    """Every warm solve of the JAX script under `variant`, given to the
    port on its inputs; the port's own study counts what those count."""
    skel = TF.Skeleton.default()
    counts, parted = [], []
    for (x0, jskel, obs, w, P, budget, stages, ftol, xtol), (jit1, jit2) in \
            ik_study["calls"]:
        if _label(stages, ftol, xtol, budget) != variant:
            continue
        it1, it2 = t_ik_study.warm_iters(t(x0), skel, t(obs), t(w), t(P), budget, stages,
                                         ftol, xtol)
        j_counts, t_counts = (int(jit1), int(jit2)), (int(it1), int(it2))
        counts.append(sum(t_counts))
        assert sum(t_counts) <= sum(j_counts), (variant, j_counts, t_counts)
        for s, (jc, tc) in enumerate(zip(j_counts, t_counts)):
            if jc == tc:
                continue
            # the stage where the counts part: JAX's slots past the port's
            # stop changed their cost by no more than GAIN_TOL_FTOL ftol
            free = jnp.asarray(JK._FREE_ALL if stages == 1 or s == 1 else JK._FREE_POSE)
            start = x0 if s == 0 else JK._lm_solve_batched(
                x0, jskel, JK.add_mid_spine(obs), w, P, jnp.asarray(JK._FREE_POSE),
                n_iters=budget, eps=1e-5, lam0=1e-3, lam_up=10.0, lam_down=0.33,
                interpret=True, ftol=ftol, xtol=xtol)
            trace, _ = jax_lm_trace(start, jskel, obs, w, P, free, budget, ftol, xtol)
            # JAX's own count moves with its rounding: the body compiled
            # alone stops between the port's count and the while's
            assert tc <= len(trace) <= jc, (variant, s, j_counts, t_counts, len(trace))
            margins = [float(np.abs(gain[active]).max())
                       for active, gain in trace[tc - 1:]]
            assert max(margins) <= GAIN_TOL_FTOL, (variant, s, j_counts, t_counts, margins)
            parted.append((s, jc, tc, len(trace), max(margins)))
    assert counts
    print(f"{variant}: calls whose counts part (stage, JAX, port, JAX body alone, "
          "largest |gain| / (ftol cost) from the port's last iteration):", parted)
    # the port's own study counts what the port's warm solves count
    assert [c for _, c in ik_study["outs"][variant]] == counts, variant
