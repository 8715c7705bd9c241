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
        # z, blocks, s0, live, out, B, T, NT, SW, n_max, F, stream
        "qtm_spmm_apply": [_P] * 5 + [_C] * 6 + [_P],
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
