"""What keeps the PyTorch port a package of its own: it imports no JAX and
nothing of the JAX package, its entry points run on the card unless the
caller asks for the CPU, and its CUDA sources are where the build helper
looks for them.  Nothing here needs JAX or a GPU."""
import ast
import dataclasses
import importlib
import re
from pathlib import Path

import pytest
import torch

import multiview_motion_capture_torch as port
from multiview_motion_capture_torch import pipeline, tracker
from multiview_motion_capture_torch.config import SHELF_BENCH, PipelineConfig
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
from multiview_motion_capture_torch.models import checkpoint as model_checkpoint
from multiview_motion_capture_torch.ops import cuda_lib
from multiview_motion_capture_torch.utils import precision

PKG = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multiview_motion_capture_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(f.name, m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_benchmark_programs_import_no_jax_and_need_the_card(tmp_path, monkeypatch):
    """The port's run programs (benchmarks, profilers, examples, the eight
    studies and the oracle copy they use) import no JAX either; like the package's `bench` mode they run on the card unless
    asked for the CPU, and raise without a GPU once their data is found."""
    root = PKG.parent
    programs = [root / "scripts" / f"{n}.py" for n in (
        "torch_bench_scaled", "torch_bench_streaming", "torch_bench_detect",
        "torch_profile_bench", "torch_profile_cam128")] + [
        root / "examples" / f"{n}.py" for n in ("torch_e2e_fullframe", "torch_e2e_synthetic")]
    for path in programs:
        bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN + ("examples",)
               and not m.startswith("examples.torch_")]
        assert not bad, (path.name, bad)
    monkeypatch.syspath_prepend(str(root / "scripts"))
    monkeypatch.syspath_prepend(str(root))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import torch_bench_detect
    import torch_bench_scaled
    import torch_bench_streaming
    import torch_profile_bench
    import torch_profile_cam128

    import examples.torch_e2e_fullframe as fullframe
    import examples.torch_e2e_synthetic as synthetic
    from multiview_motion_capture_torch import bench

    (tmp_path / "kps_opn").mkdir()
    with pytest.raises(RuntimeError, match="device='cuda'"):
        bench.measure(tmp_path)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        torch_bench_scaled.main([])
    with pytest.raises(RuntimeError, match="device='cuda'"):
        torch_bench_scaled.bench_config(4, 2, n_frames=2)
    monkeypatch.setattr(torch_bench_streaming, "load", lambda *a: (None, None, None))
    with pytest.raises(RuntimeError, match="device='cuda'"):
        torch_bench_streaming.main(["--data_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cuda'"):
        torch_bench_detect.main(n_frames=1)
    monkeypatch.setattr(torch_profile_bench, "load", lambda *a: (None, None, None))
    with pytest.raises(RuntimeError, match="device='cuda'"):
        torch_profile_bench.main(["--data_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cuda'"):
        torch_profile_cam128.main(["--assoc-only"])
    with pytest.raises(RuntimeError, match="device='cuda'"):
        fullframe.main(steps=1, n_frames=1)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        synthetic.main(steps=1, n_frames=1)
    _check_studies(tmp_path, monkeypatch)
    # with `--cpu` the profilers ask for the CPU
    asked = []

    class Asked(Exception):
        pass

    def record(device="cuda"):
        asked.append(str(device))
        raise Asked

    monkeypatch.setattr(precision, "resolve_device", record)
    with pytest.raises(Asked):
        torch_profile_bench.main(["--data_dir", str(tmp_path), "--cpu"])
    with pytest.raises(Asked):
        torch_profile_cam128.main(["--cpu"])
    assert asked == ["cpu", "cpu"]


# the research studies' ports, each with the arguments that reach its
# device (the Shelf-layout studies read `--data_dir`, an existing directory)
STUDIES = {
    "torch_bench_quality_bisect": ["--data_dir", "{data}"],
    "torch_ik_iteration_study": [],
    "torch_fragmentation_study": ["--data_dir", "{data}"],
    "torch_oracle_parity_study": ["--data_dir", "{data}", "--out", "{data}/out.json"],
    "torch_identity_study": [],
    "torch_appearance_e2e_study": [],
    "torch_crowd_detect_study": [],
    "torch_detector_style_holdout": [],
}


def _check_studies(tmp_path, monkeypatch):
    """The eight studies, the oracle copy they use, its cache and the
    runner of the studies at their own sizes import no JAX, nothing of the JAX package, no JAX example and not the JAX
    package's oracle (`tests.oracle_pipeline`); each study raises without a
    GPU, and `--cpu` asks for the CPU."""
    root = PKG.parent
    files = [root / "scripts" / f"{n}.py" for n in STUDIES] + [
        root / "scripts" / "torch_oracle_cache.py", root / "scripts" / "torch_studies_uncut.py",
        root / "tests" / "torch_oracle_pipeline.py"]
    for path in files:
        bad = [m for m in _imported_modules(path)
               if m.split(".")[0] in FORBIDDEN + ("examples",)
               and not m.startswith("examples.torch_") or m == "tests.oracle_pipeline"]
        assert not bad, (path.name, bad)
    monkeypatch.syspath_prepend(str(root / "scripts"))
    monkeypatch.syspath_prepend(str(root))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mods = {n: importlib.import_module(n) for n in STUDIES}
    argv = {n: [a.format(data=tmp_path) for a in args] for n, args in STUDIES.items()}
    for name, mod in mods.items():
        with pytest.raises(RuntimeError, match="device='cuda'"):
            mod.main(argv[name])
    # the runner of all eight at their own sizes needs the card too
    with pytest.raises(RuntimeError, match="device='cuda'"):
        importlib.import_module("torch_studies_uncut").main([])
    asked = []

    class Asked(Exception):
        pass

    def record(device="cuda"):
        asked.append(str(device))
        raise Asked

    for name, mod in mods.items():
        monkeypatch.setattr(mod, "resolve_device", record)
        with pytest.raises(Asked):
            mod.main(argv[name] + ["--cpu"])
    assert asked == ["cpu"] * len(STUDIES)
    # the Shelf-layout studies find no data where none is
    for name in ("torch_bench_quality_bisect", "torch_fragmentation_study",
                 "torch_oracle_parity_study"):
        with pytest.raises(FileNotFoundError, match="missing"):
            mods[name].main(["--data_dir", str(tmp_path / "missing"), "--cpu"])


def _counterpart_of(path: Path):
    """The program a `torch_` program names as its JAX counterpart
    ("counterpart of `examples/...`" in its docstring), or None."""
    doc = ast.get_docstring(ast.parse(path.read_text())) or ""
    m = re.search(r"counterpart of\s+`((?:examples|scripts)/\w+\.py)`", doc)
    return m.group(1) if m else None


def test_every_run_program_is_ported_or_queued():
    """Every program of `examples/` and `scripts/` has exactly one
    `torch_` counterpart that names it, or is a study ROADMAP.md's queue A4
    still holds (scripts/xla_repros/, TPU compiler repros, and the shell
    scripts are no programs of the system).  So the queue and the tree
    cannot drift apart: a study ported stays queued only until its
    counterpart exists, and a program without one must be queued.  Since
    the eight studies' slice the queue is empty: every program is ported."""
    root = PKG.parent
    programs = {f"{d}/{p.name}" for d in ("examples", "scripts")
                for p in (root / d).glob("*.py") if not p.name.startswith("torch_")}
    named = [_counterpart_of(p) for d in ("examples", "scripts")
             for p in (root / d).glob("torch_*.py")]
    ported = set(named) - {None}
    roadmap = (root / "ROADMAP.md").read_text()
    queued = set()
    if "The last slice: the eight studies" in roadmap:
        section = roadmap[roadmap.index("The last slice: the eight studies"):]
        section = section[:section.index("\n### ")]
        queued = set(re.findall(r"`(scripts/\w+\.py)`", section))
    assert len(programs) >= 17
    assert ported <= programs, ported - programs
    assert all(named.count(p) == 1 for p in ported), sorted(named, key=str)
    assert not ported & queued, ported & queued
    assert programs == ported | queued, programs - ported - queued
    assert not queued, queued


# the TPU kernels' modules and their counterparts (own wrappers, own names)
KERNEL_MODULES = {"ops/als_pallas.py": "ops/als_kernel.py",
                  "ops/solve_pallas.py": "ops/solve_kernel.py"}


def _public_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return sorted(n.name for n in tree.body
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_"))


def test_port_modules_mirror_the_jax_package():
    """Every module of the JAX package, `parallel/` included, has a
    counterpart at the same relative path (the kernel modules at theirs),
    holding every public function and class of the JAX module (read from
    its source; JAX is not imported)."""
    jax_pkg = PKG.parent / "multiview_motion_capture_tpu"
    rels = [p.relative_to(jax_pkg).as_posix() for p in sorted(jax_pkg.rglob("*.py"))]
    assert len(rels) >= 51 and "debug.py" in rels and "utils/viz.py" in rels
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/sharded_association.py",
            "parallel/sharded_solvers.py", "parallel/streams.py", "parallel/train.py"} <= set(rels)
    for rel in rels:
        port_rel = KERNEL_MODULES.get(rel, rel)
        assert (PKG / port_rel).is_file(), rel
        if rel in KERNEL_MODULES:
            continue
        name = ".".join(("multiview_motion_capture_torch",) + Path(port_rel).with_suffix("").parts)
        mod = importlib.import_module(name.removesuffix(".__init__"))
        missing = [n for n in _public_names(jax_pkg / rel) if not hasattr(mod, n)]
        assert not missing, (rel, missing)


def test_cuda_sources_exist_and_are_named_by_the_build_helper():
    names = {lib.source for lib in cuda_lib.ALL_LIBRARIES}
    assert names == {"als.cu", "gj_solve.cu", "fused_normal_gj.cu"}
    assert {p.name for p in (PKG / "csrc").glob("*.cu")} == names
    for lib in cuda_lib.ALL_LIBRARIES:
        text = lib.source_path.read_text()
        assert "Replaces: multiview_motion_capture_tpu/ops/" in text
        for fn in lib.signatures:
            assert f'extern "C" int {fn}(' in text, fn
        so = lib.library_path()
        assert so.parent == cuda_lib.BUILD_DIR and so.suffix == ".so"
        assert so.name.startswith(f"lib{lib.name}_")
    # one library per source; every kernel-table entry launches one of them
    # and keeps its own launch count
    assert len({lib.library_path() for lib in cuda_lib.ALL_LIBRARIES}) == len(names)
    assert {k.library for k in cuda_lib.ALL_KERNELS} == set(cuda_lib.ALL_LIBRARIES)
    assert len({k.name for k in cuda_lib.ALL_KERNELS}) == len(cuda_lib.ALL_KERNELS) == 5
    assert cuda_lib.ALS.library is cuda_lib.ALS_BATCHED.library is cuda_lib.ALS_LIB
    assert cuda_lib.GJ_SOLVE.library is cuda_lib.GJ_SOLVE_GRID.library is cuda_lib.GJ_LIB
    assert [f.name for f in cuda_lib.ALS_LIB.source_files()] == ["als.cu", "gj_elim.cuh"]
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS
    assert cuda_lib.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(SHELF_BENCH, n_views=3)
    seq = synthetic_sequence(n_frames=2, n_people=2, n_views=3, cfg=cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        pipeline.run(seq.batch, seq.cameras, cfg)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        tracker.TrackerContext.build(seq.cameras, cfg)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        tracker.from_numpy_state({})
    with pytest.raises(RuntimeError, match="device='cuda'"):
        port.MvTracker(seq.cameras, cfg)
    ckpts = PKG.parent / "multiview_motion_capture_tpu" / "models" / "checkpoints"
    with pytest.raises(RuntimeError, match="device='cuda'"):
        model_checkpoint.load_posenet(ckpts / "posenet_synth.npz")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        model_checkpoint.load_appearance_head(ckpts / "appearance_head.npz")
    # the training side's entry points
    from multiview_motion_capture_torch.data.appearance_train import descriptor_batch
    from multiview_motion_capture_torch.data.detect_train import generate_samples
    from multiview_motion_capture_torch.data.render import RenderConfig
    from multiview_motion_capture_torch.models.appearance_net import init_head
    from multiview_motion_capture_torch.models.pose_net import PoseNetConfig, create_train_state

    with pytest.raises(RuntimeError, match="device='cuda'"):
        generate_samples([0], RenderConfig(hw=(32, 48)), n_frames=1, n_views=1)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        descriptor_batch(0, n_scenes=1, n_frames=1, n_views=1)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        create_train_state(torch.Generator(), PoseNetConfig())
    with pytest.raises(RuntimeError, match="device='cuda'"):
        init_head(torch.Generator())
    # the side surfaces and the CLI (run and detect without --cpu)
    from multiview_motion_capture_torch import __main__ as cli
    from multiview_motion_capture_torch.ops import association, fk_generic

    with pytest.raises(RuntimeError, match="device='cuda'"):
        association.associate_frame(seq.batch.kps[0], seq.batch.valid[0], seq.cameras)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        fk_generic.GenericSkeleton.build([-1, 0], [[0, 0, 0], [0, 0, 1]])
    for mode in (["run", "--kps_dir", "k"], ["detect", "--image_dir", "i"]):
        with pytest.raises(RuntimeError, match="device='cuda'"):
            cli.main([*mode, "--calib_dir", "c", "--out_dir", "o"])
    # asking for the CPU works
    ctx = tracker.TrackerContext.build(seq.cameras, cfg, device="cpu")
    assert ctx.device.type == "cpu"
    _, head = model_checkpoint.load_appearance_head(ckpts / "appearance_head.npz", device="cpu")
    assert next(head.parameters()).device.type == "cpu"


def test_unported_options_raise():
    """No option of the JAX tracker is left unported, so none raises
    NotImplementedError any more: each builds.  What cannot run
    still raises: more camera clusters than cameras, an unknown LM solver."""
    cfg = dataclasses.replace(SHELF_BENCH, n_views=3)
    cams = synthetic_sequence(n_frames=1, n_people=1, n_views=3, cfg=cfg).cameras
    for change in (dict(motion_gain=0.5), dict(appearance_dim=8), dict(ik_solver="chol")):
        ctx = tracker.TrackerContext.build(cams, dataclasses.replace(cfg, **change),
                                           device="cpu")
        assert ctx.cfg == dataclasses.replace(cfg, **change)
    assert not tracker.TrackerContext.build(cams, cfg, use_ik=False, device="cpu").use_ik
    with pytest.raises(ValueError, match="exceeds n_views"):
        tracker.TrackerContext.build(cams, dataclasses.replace(cfg, assoc_clusters=4),
                                     device="cpu")
    with pytest.raises(ValueError, match="ik_solver"):
        tracker.TrackerContext.build(cams, dataclasses.replace(cfg, ik_solver="lu"),
                                     device="cpu")


def test_high_precision_pins_full_f32():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = False
    precision.high_precision()
    assert precision.precision_flags() == {
        "cuda_matmul_allow_tf32": False, "cudnn_allow_tf32": False,
        "float32_matmul_precision": "highest", "cudnn_benchmark": False,
        "cudnn_deterministic": True}


def test_shelf_bench_preset():
    cfg = SHELF_BENCH
    assert isinstance(cfg, PipelineConfig)
    assert (cfg.n_views, cfg.max_people, cfg.max_tracks) == (5, 6, 8)
    assert cfg.n_matrix == 38 and cfg.ik_solver == "gj"
    assert cfg.assoc_clusters == 1 and cfg.track_rescue_px > 0


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edit to a header a kernel source includes changes the library's
    name, so a stale library is never loaded."""
    (tmp_path / "k.cu").write_text('#include "k.cuh"\nextern "C" int f() { return g(); }\n')
    (tmp_path / "k.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", tmp_path)
    k = cuda_lib.CudaLibrary("k", "k.cu", {})
    assert [f.name for f in k.source_files()] == ["k.cu", "k.cuh"]
    before = k.library_path()
    (tmp_path / "k.cuh").write_text("inline int g() { return 2; }\n")
    assert k.library_path() != before
