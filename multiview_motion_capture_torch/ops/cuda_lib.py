"""Build and load the port's hand-written CUDA kernels.

Each kernel source under `csrc/` has a plain C interface.  At first use it
is compiled by `nvcc` for Hopper (`sm_90a`) into a shared library under
`build/torch_kernels/` at the root of the checkout and loaded with ctypes;
the library name carries a hash of the source and of every `csrc/` header
it includes, so an edited source or header is rebuilt and a stale library
is never loaded.  Nothing is built or loaded at import time: the CPU test
suite imports every module and has no nvcc.

A `CudaLibrary` is one source and its build.  A `CudaKernel` is one entry
of the kernel table (one TPU kernel's counterpart): the library it launches
and a `launches` count that its wrapper raises by one per kernel launch
(`count_launch`, under the entry's lock: `parallel.streams` launches from
several threads) and nowhere else.  A wrapper launches under
`torch.cuda.device(tensor.device)`, so the function attributes and
occupancy queries of the C side, which act on the current device, see the
device of the tensors it was given.  Two entries may launch one library:
B1 and B3 (one ALS problem or C of them), B2 and B5 (the TPU package's two
launch shapes of one Gauss-Jordan solve).  `gj_solve.cu` and `fused_normal_gj.cu`
share their elimination through the header `gj_elim.cuh`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from multiview_motion_capture_torch.utils.profiling import span

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


class CudaLibrary:
    """One `csrc/*.cu` source, its C functions and its build."""

    def __init__(self, name: str, source: str, signatures: Dict[str, tuple]):
        self.name = name
        self.source = source
        self.signatures = signatures   # C function -> (restype, argtypes)
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None
        self._lock = threading.Lock()

    @property
    def source_path(self) -> Path:
        return CSRC_DIR / self.source

    def source_files(self) -> list:
        """The source and every file it includes with `#include "..."`,
        transitively, each once (local includes resolve beside the file
        that names them, as nvcc resolves them)."""
        files, todo = [], [self.source_path]
        while todo:
            f = todo.pop(0).resolve()
            if f in files:
                continue
            files.append(f)
            todo.extend(f.parent / inc for inc in _INCLUDE.findall(f.read_text()))
        return files

    def library_path(self) -> Path:
        h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        for f in self.source_files():
            h.update(f.name.encode() + b"\0" + f.read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:12]}.so"

    def _start_build(self) -> Optional[tuple]:
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source_path)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out, time.perf_counter()

    def _finish_build(self, pending) -> None:
        proc, tmp, out, t0 = pending
        log, _ = proc.communicate()
        self.build_log = log
        self.build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{log}")
        os.replace(tmp, out)

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed (the span
        `setup.kernels`)."""
        with self._lock:
            if self._lib is None:
                with span("setup.kernels"):
                    pending = self._start_build()
                    if pending is not None:
                        self._finish_build(pending)
                    lib = ctypes.CDLL(str(self.library_path()))
                    for fn, (restype, argtypes) in self.signatures.items():
                        getattr(lib, fn).restype = restype
                        getattr(lib, fn).argtypes = argtypes
                    self._lib = lib
            return self._lib


class CudaKernel:
    """One entry of the kernel table: its library and its launch count."""

    def __init__(self, name: str, library: CudaLibrary):
        self.name = name
        self.library = library
        self.launches = 0
        self._lock = threading.Lock()

    def count_launch(self) -> None:
        """One launch more (thread-safe)."""
        with self._lock:
            self.launches += 1

    @property
    def source_path(self) -> Path:
        return self.library.source_path

    def lib(self) -> ctypes.CDLL:
        return self.library.lib()


ALS_LIB = CudaLibrary("als", "als.cu", {
    # n, rank, int[4] out: cluster blocks, threads, smem bytes, resident clusters
    "als_launch_shape": (_i, [_i, _i, _p]),
    # W, diag_mask, init_A, problems, n, rank, alpha, beta, mu0, tol,
    # max_iter, stable_iters, x_bin, x_out (nullable), iters, stream
    "als_solve_f32": (_i, [_p, _p, _p, _i, _i, _i, _f, _f, _f, _f, _i, _i,
                           _p, _p, _p, _p]),
})
GJ_LIB = CudaLibrary("gj_solve", "gj_solve.cu", {
    "gj_max_d": (_i, []),
    # A, g, x, T, D, stream
    "gj_solve_f32": (_i, [_p, _p, _p, _i, _i, _p]),
    # D, int[5] out
    "gj_launch_shape": (_i, [_i, _p]),
})
FUSED_NORMAL_GJ_LIB = CudaLibrary("fused_normal_gj", "fused_normal_gj.cu", {
    "fused_normal_max_d": (_i, []),
    # Jaug, lam, frozen_diag, x, T, R, D, stream
    "fused_normal_gj_f32": (_i, [_p, _p, _p, _p, _i, _i, _i, _p]),
    # D, int[6] out
    "fused_launch_shape": (_i, [_i, _p]),
})
ALL_LIBRARIES = (ALS_LIB, GJ_LIB, FUSED_NORMAL_GJ_LIB)

ALS = CudaKernel("als", ALS_LIB)                            # B1: one problem
ALS_BATCHED = CudaKernel("als_batched", ALS_LIB)            # B3: C cluster problems
GJ_SOLVE = CudaKernel("gj_solve", GJ_LIB)                   # B2: one_program=True
GJ_SOLVE_GRID = CudaKernel("gj_solve_grid", GJ_LIB)         # B5: one_program=False
FUSED_NORMAL_GJ = CudaKernel("fused_normal_gj", FUSED_NORMAL_GJ_LIB)   # B4
ALL_KERNELS = (ALS, ALS_BATCHED, GJ_SOLVE, GJ_SOLVE_GRID, FUSED_NORMAL_GJ)


def build_all(libraries: Iterable[CudaLibrary] = ALL_LIBRARIES) -> Dict[str, float]:
    """Build every library with one nvcc process each, all started together,
    then load them.  Returns seconds per library (0.0 when already built)."""
    libraries = list(libraries)
    pending = [(k, k._start_build()) for k in libraries]
    errors = []
    for k, p in pending:
        if p is None:
            k.build_seconds = 0.0
            continue
        try:
            k._finish_build(p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in libraries:
        k.lib()
    return {k.name: k.build_seconds for k in libraries}
