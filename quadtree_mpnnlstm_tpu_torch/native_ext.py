"""ctypes bindings for the port's native host toolkit (``csrc/qtm_host.cpp``).

Counterpart of ``quadtree_mpnnlstm_tpu/native_ext.py``, with its own copy
of the C++ source. The library is built with ``g++`` at first use into
``build/native/`` at the root of the checkout (listed in ``.gitignore``),
keyed by a hash of the source, the flags and what ``-march=native``
means on the host, so an edited source, or another machine, rebuilds. A failed build raises with the compiler's stderr; nothing falls
back to numpy unasked (the numpy paths are the callers' defaults, e.g.
``data/moving_mnist.py`` ``backend="numpy"``).

The functions: the quadtree labels of an image, the deduplicated
adjacency of a label image, and the bouncing-sprite video renderer of the
``backend="native"`` Moving-MNIST generator.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "qtm_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
# the JAX package's native/Makefile flags
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")

_CONDITIONS = {
    "max_larger_than": 0,
    "max_smaller_than": 1,
    "min_larger_than": 2,
    "min_smaller_than": 3,
}


class _QtParams(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_int64),
        ("cols", ctypes.c_int64),
        ("max_size", ctypes.c_int64),
        ("thresh", ctypes.c_double),
        ("padding", ctypes.c_int64),
        ("condition", ctypes.c_int32),
        ("has_mask", ctypes.c_int32),
        ("has_hir", ctypes.c_int32),
    ]


_lib = None


def _native_target(cxx: str) -> bytes:
    """What ``-march=native`` means on this host (the compiler's target
    options), so that a checkout moved to another machine rebuilds."""
    try:
        proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                              capture_output=True)
    except FileNotFoundError:
        return b""
    return proc.stdout


def build(source: Path = SOURCE, out_dir: Path = BUILD_DIR, force: bool = False) -> Path:
    """Compile ``source`` into ``out_dir/libqtmhost-<hash>.so`` (``$CXX``,
    default ``g++``) unless that file exists; returns its path. Raises
    ``RuntimeError`` with the compiler's stderr when the build fails."""
    cxx = os.environ.get("CXX", "g++")
    key = hashlib.sha256(Path(source).read_bytes() + " ".join((cxx,) + CXX_FLAGS).encode()
                         + _native_target(cxx))
    out = Path(out_dir) / f"libqtmhost-{key.hexdigest()[:16]}.so"
    if out.exists() and not force:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename, so concurrent builds never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(source)],
                                  capture_output=True, text=True)
        except FileNotFoundError as exc:
            raise RuntimeError(f"building {source}: no compiler {cxx!r} ({exc})") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"building {source} with {cxx} failed "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """The library, built on first use; raises when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64, i32, u64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.qtm_quadtree_decompose.restype = i64
    lib.qtm_quadtree_decompose.argtypes = [ctypes.POINTER(_QtParams), f64p, u8p, u8p, i64p]
    lib.qtm_adjacency.restype = i64
    lib.qtm_adjacency.argtypes = [i64p, i64, i64, i32, i64p, i64p, i64]
    lib.qtm_moving_sprites.restype = None
    lib.qtm_moving_sprites.argtypes = [f32p, i64, i64, i64, i64, i64, i64, i64,
                                       ctypes.c_float, ctypes.c_float, u64, f32p]
    _lib = lib
    return _lib


def _ptr(a: Optional[np.ndarray], ty):
    return a.ctypes.data_as(ctypes.POINTER(ty)) if a is not None else None


def quadtree_decompose(
    img: np.ndarray,
    thresh: float = 0.05,
    max_size: int = 8,
    mask: Optional[np.ndarray] = None,
    high_interest_region: Optional[np.ndarray] = None,
    padding: int = 0,
    condition: str = "max_larger_than",
) -> Tuple[np.ndarray, int]:
    """Native quadtree labels; returns (labels (rows, cols) int64, n_nodes)."""
    lib = load()
    img = np.ascontiguousarray(img, dtype=np.float64)
    rows, cols = img.shape
    p = _QtParams(rows, cols, max_size, thresh, padding, _CONDITIONS[condition],
                  int(mask is not None), int(high_interest_region is not None))
    maskc = None if mask is None else np.ascontiguousarray(mask, dtype=np.uint8)
    hirc = (None if high_interest_region is None
            else np.ascontiguousarray(high_interest_region, dtype=np.uint8))
    labels = np.empty((rows, cols), dtype=np.int64)
    n = lib.qtm_quadtree_decompose(ctypes.byref(p), _ptr(img, ctypes.c_double),
                                   _ptr(maskc, ctypes.c_uint8), _ptr(hirc, ctypes.c_uint8),
                                   _ptr(labels, ctypes.c_int64))
    return labels, int(n)


def adjacency(labels: np.ndarray, corners: bool = False,
              cap: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicated directed edges (src, dst) sorted by (dst, src)."""
    lib = load()
    labels = np.ascontiguousarray(labels, dtype=np.int64)
    rows, cols = labels.shape
    cap = cap or rows * cols * (8 if corners else 4)
    src = np.empty(cap, dtype=np.int64)
    dst = np.empty(cap, dtype=np.int64)
    n = lib.qtm_adjacency(_ptr(labels, ctypes.c_int64), rows, cols, int(corners),
                          _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64), cap)
    n = min(int(n), cap)
    return src[:n].copy(), dst[:n].copy()


def moving_sprites(
    sprites: np.ndarray,
    n_samples: int,
    t_total: int,
    canvas: int,
    n_digits: int = 1,
    pixel_noise: float = 0.05,
    velocity_noise: float = 0.25,
    seed: int = 0,
) -> np.ndarray:
    """Native bouncing-sprite video batch: (N, T, canvas, canvas) float32."""
    lib = load()
    sprites = np.ascontiguousarray(sprites, dtype=np.float32)
    ns, sh, sw = sprites.shape
    out = np.empty((n_samples, t_total, canvas, canvas), dtype=np.float32)
    lib.qtm_moving_sprites(_ptr(sprites, ctypes.c_float), ns, sh, sw, n_samples, t_total,
                           canvas, n_digits, ctypes.c_float(pixel_noise),
                           ctypes.c_float(velocity_noise), ctypes.c_uint64(seed),
                           _ptr(out, ctypes.c_float))
    return out
