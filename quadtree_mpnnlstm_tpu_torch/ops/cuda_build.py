"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (H100)
into a shared library with a plain C interface, bound with ``ctypes``. The
build runs at first use into ``build/cuda/`` at the root of the checkout
(listed in ``.gitignore``) and is keyed by a hash of the source and flags,
so an edited kernel is rebuilt. ``nvcc``'s register/shared-memory report
(``-Xptxas -v``) is kept beside each library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_C = ctypes.c_int
_P = ctypes.c_void_p
# C signatures of the entry points, by source file
SIGNATURES = {
    "spmm.cu": {
        # src_rel, dst_rel, coeff, live, blocks, B, T, EB, NT, SW, stream
        "qtm_spmm_build_blocks": [_P] * 5 + [_C] * 5 + [_P],
        "qtm_spmm_build_blocks_bf16": [_P] * 5 + [_C] * 5 + [_P],
        # z, blocks, s0, live, out, B, metadata batch (B or 1), T, NT, SW,
        # n_max, F, then the plan: rows a CTA, columns a thread; stream
        "qtm_spmm_apply": [_P] * 5 + [_C] * 9 + [_P],
        "qtm_spmm_apply_bf16": [_P] * 5 + [_C] * 9 + [_P],
    },
    "spmm_rowwarp.cu": {
        # z, blocks, s0, live, out, B, metadata batch, T, NT, SW, n_max, F,
        # features a lane, stream
        "qtm_spmm_apply_rowwarp": [_P] * 5 + [_C] * 8 + [_P],
        "qtm_spmm_apply_rowwarp_bf16": [_P] * 5 + [_C] * 8 + [_P],
    },
    "attn.cu": {
        # q, k, v, we, keep, s0, src_rel, dst_rel, attr, live, out,
        # B, metadata batch (B or 1), T, EB, NT, SW, n_max, H, D, A, KH, then
        # the plan: run, lanes a head, heads an item, lanes an item, slices,
        # warps, rows, chunk; scale, stream, geometry (host int[8] or null)
        "qtm_attn_fwd": [_P] * 11 + [_C] * 19 + [ctypes.c_float, _P, _P],
        "qtm_attn_fwd_bf16": [_P] * 11 + [_C] * 19 + [ctypes.c_float, _P, _P],
        # ... live, g, view order, view offsets, dq, dk, dv, dlog, used,
        # dwe_part, B, metadata batch, T, ..., rows, scale, stream
        "qtm_attn_bwd": [_P] * 19 + [_C] * 12 + [ctypes.c_float, _P],
        "qtm_attn_bwd_bf16": [_P] * 19 + [_C] * 12 + [ctypes.c_float, _P],
    },
    "grid_attn.cu": {
        # q, k, v, e_dir, valid, keep, out,
        # B, rows, cols, heads, d, D, hpg, tile rows, tile cols, scale, stream
        "qtm_grid_attn_fwd": [_P] * 7 + [_C] * 9 + [ctypes.c_float, _P],
        "qtm_grid_attn_fwd_bf16": [_P] * 7 + [_C] * 9 + [ctypes.c_float, _P],
        # q, k, v, e_dir, valid, keep, g, dq, dk, dv, de_part,
        # B, rows, cols, heads, d, D, hpg, tile rows, tile cols, scale, stream
        "qtm_grid_attn_bwd": [_P] * 11 + [_C] * 9 + [ctypes.c_float, _P],
        "qtm_grid_attn_bwd_bf16": [_P] * 11 + [_C] * 9 + [ctypes.c_float, _P],
    },
    "segment.cu": {
        # values, order (or null), offsets, out, B, L, n_out, F, then the plan:
        # route, vec, span, lanes; stream
        "qtm_segment_sum": [_P] * 4 + [_C] * 8 + [_P],
        "qtm_segment_sum_bf16": [_P] * 4 + [_C] * 8 + [_P],
    },
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library for this content exists;
    returns the library's path. Raises if ``nvcc`` fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        capture_output=True, text=True, check=False,
    )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def build_all() -> dict:
    """Compile every source in parallel, one ``nvcc`` each; returns
    {source: library path}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(SIGNATURES)) as pool:
        futures = {s: pool.submit(build, s) for s in SIGNATURES}
        return {s: f.result() for s, f in futures.items()}


@functools.cache
def load_library(source: str = "spmm.cu") -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>`` with its signatures set."""
    lib = ctypes.CDLL(str(build(source)))
    for name, argtypes in SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
