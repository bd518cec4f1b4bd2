"""Build and load the package's CUDA kernels.

Each of `slam2d_tpu_torch/csrc/*.cu` is compiled by its own `nvcc -c` for
sm_90a, all of them started together, and the objects are linked into one
shared library with a plain C interface, on first use, and loaded with
ctypes. The library lands in `slam2d_tpu_torch/_build/` (listed in
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
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every C entry point, in the order of its parameters
_SIGNATURES = {
    # grid, out, pose, ranges, angles, H, W, B, ox, oy, res, step,
    # angle_min, min_range, max_range, l_free, l_occ, l_clamp, enable, stream
    "slam2d_update_hybrid": [_P, _P, _P, _P, _P, _I, _I, _I]
    + [_F] * 11 + [_P],
    # map, origin, gate, pose, ranges, angles, H, W, h, w, B, ox, oy, res,
    # step, angle_min, min_range, max_range, l_free, l_occ, l_clamp,
    # enable, stream
    "slam2d_update_hybrid_window": [_P] * 6 + [_I] * 5 + [_F] * 11 + [_P],
    # maps, is_bf16, poses, ranges, P, H, W, Hr, Wr, B, gox, goy, res,
    # inv_res, step, half_step, angle_min, min_range, max_range, occ_tol,
    # l_free, l_occ, l_clamp, enable, gate, stream
    "slam2d_update_ism": [_P, _I, _P, _P] + [_I] * 6 + [_F] * 14 + [_P, _P],
    # S, pos_row, pos_col, valid, out, H, W, T, B, R, C, bilinear, stream
    "slam2d_score_offsets": [_P] * 5 + [_I] * 7 + [_P],
    # S, pos_row, pos_col, valid, out, gate, H, W, T, B, R, C, bilinear,
    # stream
    "slam2d_score_offsets_gated": [_P] * 6 + [_I] * 7 + [_P],
    # stream: one launch of an empty kernel (the floor under a launch)
    "slam2d_empty_launch": [_P],
    # logodds, out, H, W, taps (host array), n_taps, 1/occ_sat,
    # free_threshold, free_penalty, stream
    "slam2d_search_space": [_P, _P, _I, _I, _P, _I, _F, _F, _F, _P],
    # logodds, out, H, W, origin, gate, h, w, margin, taps (host array),
    # n_taps, 1/occ_sat, free_threshold, free_penalty, stream
    "slam2d_search_space_window": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _P,
                                   _I, _F, _F, _F, _P],
    # maps, in_bf16, origins, out, out_bf16, P, Hm, Wm, win, taps (host
    # array), n_taps, 1/occ_sat, free_logit, free_penalty, gate, stream
    "slam2d_window_field": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _I]
    + [_F] * 3 + [_P, _P],
    # -> the variant its last launch ran
    "slam2d_window_field_last_variant": [],
    # E, out, elem_bytes, G, R, C, win, gate, stream
    "slam2d_shift_stack": [_P, _P] + [_I] * 5 + [_P, _P],
    # x, out, ancestors, P, row_bytes, gate, stream
    "slam2d_gather_rows": [_P, _P, _P, _I, _L, _P, _P],
    # -> the variant its last launch ran
    "slam2d_gather_rows_last_variant": [],
    # maps, map_bf16, images, img_bf16, anchors, slots, ep_r, ep_c, ep_w,
    # P, H, W, win, G, B, l_clamp, gate, stream
    "slam2d_shared_apply": [_P, _I, _P, _I] + [_P] * 5 + [_I] * 6
    + [_F, _P, _P],
    # E, e_bf16, Sp, out, P, T, H, W, R, C, gate, stream
    "slam2d_corr_scores": [_P, _I, _P, _P] + [_I] * 6 + [_P, _P],
    # grid, out, pose, ranges, angles, H, W, B, ox, oy, res, min_range,
    # max_range, 1/ray_samples, res/2, 1/res, angle_min, step, l_free,
    # l_occ, l_clamp, enable, stream
    "slam2d_update_ray": [_P] * 5 + [_I] * 3 + [_F] * 14 + [_P],
    # maps, is_bf16, poses, ranges, angles, P, H, W, h, w, B, ox, oy,
    # res, step, angle_min, min_range, max_range, l_free, l_occ, l_clamp,
    # enable, gate, stream
    "slam2d_update_hybrid_particles": [_P, _I, _P, _P, _P] + [_I] * 6
    + [_F] * 11 + [_P, _P],
    # maps, is_bf16, poses, ranges, angles, P, H, W, h, w, B, ox, oy, res,
    # min_range, max_range, 1/ray_samples, res/2, 1/res, angle_min, step,
    # l_free, l_occ, l_clamp, enable, gate, stream
    "slam2d_update_ray_particles": [_P, _I, _P, _P, _P] + [_I] * 6
    + [_F] * 14 + [_P, _P],
    # D, O, Cinv, K, stream
    "slam2d_tridiag_factor": [_P, _P, _P, _I, _P],
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


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails, after all have ended."""
    procs = [
        subprocess.Popen(
            c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
            )


def _build(out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory and rename the library into place, so
    # a concurrent or cut-off build never leaves a half-written library
    # under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            for src, obj in zip(_sources(), objs)
        ])
        lib = os.path.join(tmp, out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)


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


def check_gate(gate, device) -> None:
    """Raise unless `gate` is None or a one-element bool tensor on
    `device`: the device gate a kernel reads (a byte: 0 returns every block
    at once)."""
    if gate is not None and (gate.dtype != torch.bool or gate.numel() != 1
                             or gate.device != device):
        raise ValueError("gate must be a one-element bool tensor on the "
                         "operands' device")


def gate_ptr(gate):
    """The device address of a checked `gate` (None: no gate, always on)."""
    return None if gate is None else gate.data_ptr()


def gated(gate, new, old):
    """A plain version's gate: `new` where the gate is true (or None),
    `old` where it is false, selected on the device with the same bits."""
    return new if gate is None else torch.where(gate.reshape(()), new, old)
