"""The PyTorch port stands alone: no module of ``quadtree_mpnnlstm_tpu_torch``
and no line of ``chip_smoke.py``, ``chip_profile.py`` or ``chip_ab.py``
imports JAX, flax, the JAX package or ``baselines``; ``chip_smoke.py``
fails without a CUDA card (no CPU fallback) and without the port's
package beside it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "quadtree_mpnnlstm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "quadtree_mpnnlstm_tpu", "baselines")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_profile.py",
                                       ROOT / "chip_ab.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_port_has_modules_to_scan():
    names = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in p.parents}
    assert {"ops/spmm.py", "ops/attn.py", "ops/grid_attn.py", "graph/build.py",
            "train/predictor.py", "models/seq2seq.py", "data/ice_dataset.py",
            "graph/static.py", "models/mpnnlstm.py", "eval/plotting.py",
            "utils/normalize.py", "data/netcdf_io.py", "data/loader.py", "eval/results.py",
            "eval/ports.py", "eval/mesh_design.py", "eval/trace_summary.py",
            "models/cnnlstm.py", "train/cnn_predictor.py", "parallel/mesh.py",
            "parallel/dp.py", "parallel/sweep.py", "cli/ice_exp.py", "cli/ice_exp_nwt.py",
            "cli/ice_exp_cnnlstm.py", "cli/ice_inf.py", "cli/ice_profile.py",
            "cli/mnist_demo.py", "native_ext.py", "utils/draws.py"} <= names


def test_chip_scripts_import_no_optional_packages_at_the_top():
    """The card's machine has no h5py, matplotlib, PIL or xarray: the chip
    scripts import none of them at module level (the netCDF reader and the
    plots import theirs when called)."""
    for name in ("chip_smoke.py", "chip_profile.py", "chip_ab.py"):
        tree = ast.parse((ROOT / name).read_text())
        top = set()
        for node in tree.body:
            if isinstance(node, ast.Import):
                top |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                top.add(node.module.split(".")[0])
        assert not top & {"h5py", "matplotlib", "PIL", "xarray"}, (name, top)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_kernel_sources_are_in_the_package():
    for source in ("spmm.cu", "attn.cu", "grid_attn.cu", "segment.cu", "qtm_host.cpp"):
        assert (PORT / "csrc" / source).is_file()
    assert (PORT / "data" / "digit_sprites.npz").is_file()


def _run_smoke(cwd: pathlib.Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, even on a GPU host
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
