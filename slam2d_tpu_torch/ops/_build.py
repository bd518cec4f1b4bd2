"""Build and load the package's CUDA kernels.

All of `slam2d_tpu_torch/csrc/*.cu` is compiled by `nvcc` for sm_90a into
one shared library with a plain C interface, on first use, and loaded
with ctypes. The library lands in `slam2d_tpu_torch/_build/` (listed in
.gitignore) under a name keyed by a hash of the sources and flags, so an
edited source builds anew and an unchanged one is reused. A build or load
failure raises; there is no fallback.

Every C entry point returns the `cudaError_t` of `cudaGetLastError()`
right after its launch; `check()` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point, in the order of its parameters
_SIGNATURES = {
    # grid, out, pose, ranges, angles, H, W, B, ox, oy, res, step,
    # angle_min, min_range, max_range, l_free, l_occ, l_clamp, enable, stream
    "slam2d_update_hybrid": [_P, _P, _P, _P, _P, _I, _I, _I]
    + [_F] * 11 + [_P],
    # S, pos_row, pos_col, valid, out, H, W, T, B, R, C, bilinear, stream
    "slam2d_score_offsets": [_P] * 5 + [_I] * 7 + [_P],
    # logodds, scratch, out, H, W, taps (host array), n_taps, 1/occ_sat,
    # free_threshold, free_penalty, stream
    "slam2d_search_space": [_P, _P, _P, _I, _I, _P, _I, _F, _F, _F, _P],
}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libslam2d_kernels_{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a temporary name and rename, so a concurrent or cut-off
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    out = library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream
