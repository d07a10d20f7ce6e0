"""Native (C++) host-side data engine: the lane vectorization of
`data/formatter.py` (port of prosim_tpu/native/__init__.py).

`lane_vectorize.cpp` has a plain C interface and is loaded with ctypes. It
is built with g++ at first use into <repo>/build/prosim_torch_native/, named
by a hash of the source and the flags (as ops/_build.py names the CUDA
libraries), so an edited source is rebuilt. A failed build raises with the
compiler's message: the formatter has no silent numpy fallback. The numpy
path (`formatter.vectorize_lanes_plain`) is the plain version the tests
hold the library to, bit for bit.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "lane_vectorize.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "prosim_torch_native"
CXX = "g++"
# no -march: no fused multiply-adds, the numpy path's rounding exactly
CXX_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None

_dbl = ctypes.POINTER(ctypes.c_double)
_f32 = ctypes.POINTER(ctypes.c_float)
_i64 = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"liblanevec_{digest}.so"


def build() -> Path:
    """Compile the library if it is missing; raises RuntimeError with the
    compiler's output if g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        res = subprocess.run([CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                             capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native lane engine: cannot run {CXX}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native lane engine: {CXX} failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                lib.vectorize_lanes.restype = ctypes.c_int
                lib.vectorize_lanes.argtypes = [
                    _dbl, ctypes.c_int64, _i64, ctypes.c_int64, _f32, _f32, _i64,
                    ctypes.c_double, ctypes.c_double, ctypes.c_double,
                    ctypes.c_double, ctypes.c_int64, _f32, ctypes.c_int64,
                ]
                _lib = lib
    return _lib


def vectorize_lanes_native(
    pts: np.ndarray,       # [P, 2] float64 world points (parts concatenated)
    offsets: np.ndarray,   # [K+1] int64
    types: np.ndarray,     # [K] float32
    tls: np.ndarray,       # [K] float32
    rates: np.ndarray,     # [K] int64
    center_xy,
    center_h: float,
    map_range: float,
    max_lane_pts: int,
) -> np.ndarray:
    """[M, max_lane_pts-1, 6] float32 chunks."""
    lib = load()
    pts = np.ascontiguousarray(pts, np.float64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    types = np.ascontiguousarray(types, np.float32)
    tls = np.ascontiguousarray(tls, np.float32)
    rates = np.ascontiguousarray(rates, np.int64)

    max_chunks = int(len(pts) // max(1, max_lane_pts) + len(offsets) + 8)
    while True:
        out = np.zeros((max_chunks, max_lane_pts - 1, 6), np.float32)
        n = lib.vectorize_lanes(
            pts.ctypes.data_as(_dbl), len(pts),
            offsets.ctypes.data_as(_i64), len(offsets) - 1,
            types.ctypes.data_as(_f32), tls.ctypes.data_as(_f32), rates.ctypes.data_as(_i64),
            float(center_xy[0]), float(center_xy[1]), float(center_h),
            float(map_range), int(max_lane_pts),
            out.ctypes.data_as(_f32), max_chunks,
        )
        if n >= 0:
            return out[:n]
        max_chunks = -n * 2  # undersized: grow and retry
