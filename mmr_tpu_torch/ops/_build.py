"""Build and load the port's CUDA kernels (``mmr_tpu_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process for ``sm_90a`` (all
started together; the shared device code of ``csrc/*.cuh`` is included by
each), then linked into one shared library with a plain C
interface that :mod:`ctypes` loads. The library lands in
``mmr_tpu_torch/_build/`` under a name keyed on a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused. The
build runs at first use: the first CUDA tensor that reaches a kernel.
``ptxas -v`` output (registers, shared memory, spills) is printed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points and their argument types (every pointer, array and the
# stream as c_void_p; ints as c_int, element counts as c_longlong); each
# returns a cudaError_t
SIGNATURES = {
    "mmr_conv3x3": [_P, _I, _I, _P, _P, _P] + [_I] * 7 + [_P],
    "mmr_conv3x3_dw": [_P, _I, _I, _P, _I, _P] + [_I] * 5 + [_P],
    "mmr_confusion": [_P, _I, _P, _I, _L, _I, _P, _P, _P],
    "mmr_fused_conv": [_I] + [_P] * 10 + [_I] * 6 + [_P],
    "mmr_fused_conv_bwd": [_I] + [_P] * 18 + [_I] * 6 + [_P],
    "mmr_fused_conv_down": [_P] * 3 + [_I] + [_P] * 4 + [_I] * 6 + [_P],
    "mmr_fused_conv_down_bwd": [_P] * 3 + [_I] + [_P] * 10 + [_I] * 6 + [_P],
    "mmr_head_loss_fwd": [_P] * 3 + [_I] * 2 + [_P] * 6 + [_I] * 4 + [_P],
    "mmr_head_loss_bwd": ([_P] * 3 + [_I] * 2 + [_P] + [_I] * 2 + [_P] * 8
                          + [_I] * 4 + [_P]),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of mmr_tpu_torch are built "
            "from csrc/ at first use and need the CUDA toolkit")
    return nvcc


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(SRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if the library for these sources is missing;
    returns its path."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    lib = BUILD_DIR / f"libmmr_kernels_{_digest(sources)}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for s, o in zip(sources, objs)]
        failed = []
        for s, pr in zip(sources, procs):
            out, _ = pr.communicate()
            print(f"[nvcc {s.name}]\n{out}", flush=True)
            if pr.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib)
    print(f"[mmr_tpu_torch] built {lib.name} in {time.time() - t0:.1f} s",
          flush=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
