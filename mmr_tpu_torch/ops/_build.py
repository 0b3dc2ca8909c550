"""Build and load the port's CUDA kernels (``mmr_tpu_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process for ``sm_90a`` (all
started together; the shared device code of ``csrc/*.cuh`` is included by
each), then linked into one shared library with a plain C
interface that :mod:`ctypes` loads. The library lands in
``mmr_tpu_torch/_build/`` under a name keyed on a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused. The
build runs at first use: the first CUDA tensor that reaches a kernel.
``ptxas -v`` output (registers, shared memory, spills) is printed, and
one summary line per Hopper kernel (:func:`ptxas_summary`).

:func:`cached_build` and :func:`load` are the policy this library and the
host decoders' (:mod:`mmr_tpu_torch.data.hostlib`, built by ``cc``) share.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from collections.abc import Callable, Sequence
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
    "mmr_conv3x3_dw": [_P, _I, _I, _P, _I, _P, _I, _P] + [_I] * 3 + [_P],
    "mmr_conv3x3_dw_grid": [_I] * 6 + [_P],
    "mmr_conv3x3_dw_info": [_I, _I, _I],
    "mmr_confusion": [_P, _I, _P, _I, _L, _I, _P, _P, _P, _P],
    "mmr_fused_conv": [_I] + [_P] * 10 + [_I] * 6 + [_P],
    "mmr_fused_conv_bwd": [_I] + [_P] * 19 + [_I] * 6 + [_P],
    "mmr_fused_conv_down": [_P] * 3 + [_I] + [_P] * 5 + [_I] * 8 + [_P],
    "mmr_fused_conv_down_bwd": ([_P] * 3 + [_I] + [_P] * 6 + [_I] + [_P]
                                + [_I] * 7 + [_P]),
    "mmr_conv3x3_narrow": [_P, _I, _I, _P, _P, _P] + [_I] * 5 + [_P],
    "mmr_conv3x3_narrow_grid": [_I] * 6 + [_P],
    "mmr_conv3x3_narrow_info": [_I, _I, _I],
    "mmr_head_loss_fwd": ([_P] * 3 + [_I] * 2 + [_P] * 3 + [_I] + [_P] * 2
                          + [_I] + [_P] * 2 + [_I] * 5 + [_P]),
    "mmr_head_loss_fwd_grid": [_I] * 6 + [_P],
    "mmr_head_loss_fwd_info": [_I, _I, _I],
    "mmr_head_loss_bwd": ([_P] * 3 + [_I] * 2 + [_P] + [_I] + [_P] * 5
                          + [_I] + [_P] * 4 + [_I] * 4 + [_P]),
    "mmr_hopper_kernel_info": [_I, _I, _I],
    "mmr_fused_conv_info": [_I, _I, _I],
    "mmr_head_loss_bwd_info": [_I, _I, _I],
    "mmr_fused_conv_down_info": [_I, _I, _I],
    "mmr_fused_conv_down_bwd_info": [_I, _I, _I],
    "mmr_fused_conv_down_grid": [_I] * 7 + [_P],
    "mmr_fused_conv_down_bwd_grid": [_I] * 8 + [_P],
}
# the Hopper kernels by mangled name: the entry that reports their shared
# memory and blocks per SM, their kind there (``mmr_hopper_kernel_info``: 0
# conv, 1 source-resolution dx, 2 K3's dW; ``mmr_conv3x3_dw_info``: the
# modes 0 (cin <= 16), 1 (cin <= 32), 2 (64-channel chunks), each a kind;
# the narrow tile's entries: cin <= 16 (0) or <= 32 (1); the stride-2
# pair's: dense (0), depthwise at stride 2 (1) or 1 (2)) and their
# output-channel tiles (the stride-2 pair's: the flagship's input channels)
HOPPER_KERNELS = {
    "conv_wg_kernel": ("mmr_hopper_kernel_info", 0, (16, 32, 64)),
    "conv_up2_dx_kernel": ("mmr_hopper_kernel_info", 1, (16, 32, 64)),
    "conv_dw_wg_kernel": ("mmr_hopper_kernel_info", 2, (16, 32)),
    "conv3x3_dw_kernel": ("mmr_conv3x3_dw_info", (0, 1, 2), (16, 32, 64)),
    "narrow_conv_kernel": ("mmr_conv3x3_narrow_info", (0, 1), (16, 32)),
    "narrow_head_kernel": ("mmr_head_loss_fwd_info", (0, 1), (16,)),
    "pending_conv_kernel": ("mmr_fused_conv_info", 0, (16, 32, 64)),
    "head_bwd_kernel": ("mmr_head_loss_bwd_info", 0, (16, 32)),
    "down_stem_kernel": ("mmr_fused_conv_down_info", 0, (3,)),
    "down_dw_fwd_kernel": ("mmr_fused_conv_down_info", (1, 2), (16, 72, 88)),
    "down_stem_bwd_kernel": ("mmr_fused_conv_down_bwd_info", 0, (3,)),
    "down_dw_bwd_kernel": ("mmr_fused_conv_down_bwd_info", (1, 2),
                           (16, 72, 88)),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of mmr_tpu_torch are built "
            "from csrc/ at first use and need the CUDA toolkit")
    return nvcc


def ptxas_summary(out: str) -> list[str]:
    """"kernel<ints[, f32]>: registers; spills" for each Hopper kernel in
    nvcc's ``-Xptxas -v`` output."""
    rows, name, spill = {}, None, ""
    for line in out.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            k = re.search(r"\d+(%s)(I(?:Li\d+E)+f?)?" % "|".join(HOPPER_KERNELS),
                          m.group(1))
            args = k and k.group(2) and re.findall(r"Li(\d+)E", k.group(2))
            name = k and (k.group(1) if not args else
                          f"{k.group(1)}<{', '.join(args)}"
                          f"{', f32' if k.group(2).endswith('f') else ''}>")
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            rows[name] = f"{name}: {regs} registers; {spill}"
            name = None
    return sorted(rows.values())


_LOCK = threading.Lock()   # one build at a time in a process


def cached_build(prefix: str, flags: Sequence[str], sources: list[Path],
                 headers: list[Path], compile: Callable[[Path, Path], None],
                 build_dir: Path = BUILD_DIR) -> Path:
    """``build_dir/<prefix>_<hash>.so``, the hash over ``flags`` and the
    names and bytes of ``sources`` and ``headers``: returned where it
    exists, else written by ``compile(tmp_dir, tmp_lib)`` inside a
    temporary directory of ``build_dir`` and renamed into place, so that
    processes building at once each write files of their own. Threads of
    one process build one at a time: the first to come builds, the others
    wait and find its file."""
    h = hashlib.sha256(" ".join(flags).encode())
    for s in [*sources, *headers]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = build_dir / f"{prefix}_{h.hexdigest()[:16]}.so"
    with _LOCK:
        if lib.exists():
            return lib
        build_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            tmp_lib = Path(tmp) / lib.name
            compile(Path(tmp), tmp_lib)
            os.replace(tmp_lib, lib)
    return lib


def load(path: Path, signatures: dict) -> ctypes.CDLL:
    """The library at ``path``, through :class:`ctypes.CDLL` (which
    releases the GIL during each call), each entry of ``signatures`` given
    its argument types and a C ``int`` result."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _nvcc_compile(sources: list[Path], tmp: Path, tmp_lib: Path) -> None:
    nvcc = _nvcc()
    t0 = time.time()
    objs = [tmp / (s.stem + ".o") for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(sources, objs)]
    failed = []
    summary = []
    for s, pr in zip(sources, procs):
        out, _ = pr.communicate()
        print(f"[nvcc {s.name}]\n{out}", flush=True)
        summary += [f"{s.name} {row}" for row in ptxas_summary(out)]
        if pr.returncode != 0:
            failed.append(s.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    for row in summary:
        print(f"[ptxas] {row}", flush=True)
    print(f"[mmr_tpu_torch] built {tmp_lib.name} in {time.time() - t0:.1f} s",
          flush=True)


def build() -> Path:
    """Compile the kernels if the library for these sources is missing;
    returns its path."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    return cached_build("libmmr_kernels", NVCC_FLAGS, sources,
                        sorted(SRC_DIR.glob("*.cuh")),
                        lambda tmp, tmp_lib: _nvcc_compile(sources, tmp, tmp_lib))


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return load(build(), SIGNATURES)
