"""ctypes binding of the native CARMEN parser (native/carmen_parser.cpp).

`load_carmen_log_native(path)` has the contract of data/carmen.py's
`load_carmen_log` (the same rows kept and skipped, the same arrays) but
parses with the C++ single-pass parser. The binding reproduces the JAX
package's (slam2d_tpu/data/native.py): `carmen_count` then
`carmen_parse`, with the per-scan stamps.

The parser is compiled on first use with the host's C++ compiler (`c++`,
else `g++`; `CXX` overrides) into `slam2d_tpu_torch/_build/` (listed in
.gitignore), under a name keyed by a hash of the source and flags, as
ops/_build.py builds the kernels: an edited source builds anew, an
unchanged one is reused. `native_available()` is False when no compiler
is found or the build fails; data.load_carmen_log then falls back to the
Python parser.
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

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "carmen_parser.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise OSError("no C++ compiler found (c++, g++ or $CXX)")


def library_path() -> pathlib.Path:
    """Where the parser for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcarmen_parser_{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # built under a temporary name and renamed into place, so a concurrent
    # or cut-off build never leaves a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        proc = subprocess.run(
            [_compiler(), *CXX_FLAGS, "-o", lib, str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise OSError(f"building the CARMEN parser failed:\n{proc.stderr}")
        os.replace(lib, out)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the parser; raises OSError on failure."""
    out = library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    lib.carmen_count.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.carmen_count.restype = ctypes.c_int
    lib.carmen_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.carmen_parse.restype = ctypes.c_int64
    return lib


def native_available() -> bool:
    try:
        load_library()
        return True
    except OSError:
        return False


def load_carmen_log_native(path: str):
    """Parse FLASER / ROBOTLASER1 entries with the C++ parser. Same output
    contract as data/carmen.py's load_carmen_log."""
    lib = load_library()
    n = ctypes.c_int64()
    b = ctypes.c_int64()
    if lib.carmen_count(path.encode(), ctypes.byref(n), ctypes.byref(b)) != 0:
        raise IOError(f"cannot open {path}")
    if n.value == 0 or b.value == 0:
        raise ValueError(f"no FLASER entries in {path}")
    odom = np.empty((n.value, 3), np.float32)
    ranges = np.empty((n.value, b.value), np.float32)
    stamps = np.empty(n.value, np.float64)
    rows = lib.carmen_parse(
        path.encode(),
        odom.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ranges.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n.value,
        b.value,
        stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rows < 0:
        raise IOError(f"parse failed for {path}")
    if rows == 0:
        # as the Python loader: all rows malformed is an error, not empty
        # arrays
        raise ValueError(f"no parseable FLASER entries in {path}")
    return {
        "odom": odom[:rows],
        "ranges": ranges[:rows],
        "stamps": stamps[:rows],
    }
