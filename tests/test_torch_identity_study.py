"""`scripts/torch_identity_study.py` against `scripts/identity_study.py` on
the CPU: `study_config` at 6 views, 4 people, 20 frames, every score dict
(raw, after the crossing repair, after the re-ID merge, after the ghost
filter, the trajectory-only merge) equal to the JAX script's.

Two configurations cover the four the studies' keywords switch on: the
shared-skeleton gate comparison (`compare_bone_gate=True`, whose first
three score dicts are the plain configuration's: the keyword only adds
the trajectory-only ones), and appearance embeddings with the crossing
repair (`appearance_dim=16, crossings=True`).  Each JAX configuration
compiles a tracker program (~10-20 s on this CPU), so the two keep the
file under a minute alone (51 s here).
"""
import sys
from pathlib import Path

import jax
import pytest
import torch

from tests.torch_study_scene import one_thread

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import identity_study as j_identity  # noqa: E402
import torch_identity_study as t_identity  # noqa: E402

# keep the suite's compilation cache (the JAX script sets one in __main__)
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")

RIG = dict(n_views=6, n_people=4, n_frames=20)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


@pytest.mark.parametrize("options", [dict(compare_bone_gate=True),
                                     dict(appearance_dim=16, crossings=True)],
                         ids=["bone_gate", "appearance_crossings"])
def test_study_config_matches_jax(options):
    ref = j_identity.study_config(**RIG, **options)
    got = t_identity.study_config(**RIG, **options, device="cpu")
    assert list(got) == list(ref)
    assert got == ref
    assert got["raw"]["gt_identities"] == RIG["n_people"]
    assert got["raw"]["n_tracks"] >= RIG["n_people"]


def test_configs_are_the_jax_scripts():
    """CONFIGS holds the JAX `main`'s nine configurations by name, each with
    the keywords it passes (read from its source)."""
    import ast

    src = (ROOT / "scripts" / "identity_study.py").read_text()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    results = next(n.value for n in ast.walk(main)
                   if isinstance(n, ast.Assign) and n.targets[0].id == "results")
    ref = {}
    for k, call in zip(results.keys, results.values):
        names = ("n_views", "n_people", "n_frames")
        kw = {n: ast.literal_eval(a) for n, a in zip(names, call.args)}
        kw.update({a.arg: ast.literal_eval(a.value) for a in call.keywords})
        ref[ast.literal_eval(k)] = kw
    assert t_identity.CONFIGS == ref
