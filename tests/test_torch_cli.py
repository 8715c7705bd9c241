"""The port's CLIs (``quadtree_mpnnlstm_tpu_torch/cli/``) and sweep runner
on the CPU: their helpers against the JAX CLIs' on the same inputs, and
each CLI run end to end at a small size: 16×16 synthetic fields, hidden 4
(the experiments' widths are the module constant ``ice_exp.MODEL_KWARGS``,
narrowed here), T_out 2, each IceDataset cut to 4 windows
(``torch_dp_workers.few_windows``) and batches of 2, so an epoch is two
steps."""

import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from quadtree_mpnnlstm_tpu.cli import ice_exp as jax_ice_exp
from quadtree_mpnnlstm_tpu.cli import ice_exp_cnnlstm as jax_cnn_cli
from quadtree_mpnnlstm_tpu.parallel import sweep as jax_sweep
from quadtree_mpnnlstm_tpu_torch.cli import (
    ice_exp,
    ice_exp_cnnlstm,
    ice_exp_nwt,
    ice_inf,
    ice_profile,
    mnist_demo,
)
from quadtree_mpnnlstm_tpu_torch.data import ice_dataset
from quadtree_mpnnlstm_tpu_torch.parallel import sweep
import torch_dp_workers as w
from quadtree_mpnnlstm_tpu_torch.parallel import dp
from torch_threads import one_torch_thread  # noqa: F401

DATA = ["--synthetic", "--shape", "16", "16", "--synthetic-years", "2", "--t-out", "2",
        "--batch-size", "2", "--device", "cpu"]
SMALL = DATA + ["--epochs", "1"]
NARROW = dict(ice_exp.MODEL_KWARGS, hidden_size=w.CLI_HIDDEN)
CUT = [(m, w.few_windows(m.IceDataset)) for m in (ice_exp, ice_inf, ice_exp_nwt, ice_profile)]


def _narrow():
    """The CLIs at the tests' size: narrow models, cut datasets."""
    patches = [mock.patch.object(ice_exp, "MODEL_KWARGS", NARROW)]
    patches += [mock.patch.object(m, "IceDataset", cut) for m, cut in CUT]
    return patches


@pytest.fixture
def narrow():
    patches = _narrow()
    for p in patches:
        p.start()
    yield
    for p in reversed(patches):
        p.stop()


@pytest.mark.parametrize("exp", range(11))
def test_experiment_config_is_the_jax_clis(exp):
    assert ice_exp.experiment_config(exp) == jax_ice_exp.experiment_config(exp)


@pytest.mark.parametrize("exp", range(9))
def test_cnnlstm_experiment_config_is_the_jax_clis(exp):
    assert (ice_exp_cnnlstm.experiment_config(exp)
            == jax_cnn_cli.experiment_config(exp))


def test_helpers_equal_the_jax_clis():
    rng = np.random.default_rng(0)
    arr = rng.random((5, 7)).astype(np.float32) * 1.4 - 0.2
    np.testing.assert_array_equal(ice_exp.dist_from_05(arr), jax_ice_exp.dist_from_05(arr))
    assert torch.equal(ice_exp.dist_from_05(torch.as_tensor(arr)),
                       torch.as_tensor(jax_ice_exp.dist_from_05(arr)))
    for shape in [(16, 16), (24, 32), (224, 304)]:
        np.testing.assert_array_equal(ice_exp.synthetic_hir(shape),
                                      jax_ice_exp.synthetic_hir(shape))
    ours, mask = ice_dataset.synthetic_dataset(shape=(8, 12), years=(2007, 2008), seed=3)
    ref, ref_mask = jax_ice_exp.synthetic_dataset(shape=(8, 12), years=(2007, 2008), seed=3)
    np.testing.assert_array_equal(mask, ref_mask)
    for v in ref.variables:
        np.testing.assert_array_equal(ours.variables[v], ref.variables[v])


def test_save_predictions_writes_the_jax_clis_file(tmp_path):
    rng = np.random.default_rng(1)
    y_hat = rng.random((3, 2, 4, 5, 1)).astype(np.float32)
    y_true = rng.random((3, 2, 4, 5, 1)).astype(np.float32)
    launch = np.array([np.datetime64("2007-06-0%d" % d, "ns").astype(np.int64)
                       for d in (1, 2, 3)])
    ours = ice_exp.save_predictions(str(tmp_path / "ours"), y_hat, y_true, launch, 2)
    ref = jax_ice_exp.save_predictions(str(tmp_path / "ref"), y_hat, y_true, launch, 2)
    assert os.path.splitext(ours)[1] == os.path.splitext(ref)[1] == ".npz"  # no xarray here
    a, b = np.load(ours), np.load(ref)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_load_hir_without_xarray_or_file(capsys, tmp_path):
    path = str(tmp_path / "missing.nc")
    assert ice_exp.load_hir(path, (16, 16)) is None
    ours = capsys.readouterr().out
    assert jax_ice_exp.load_hir(path, (16, 16)) is None
    assert ours == capsys.readouterr().out
    assert "training without it" in ours


def test_save_mesh_png_with_and_without_matplotlib(tmp_path, narrow):
    cfg = ice_exp.experiment_config(0)
    model = ice_exp.make_model(cfg, (16, 16), "png", 2, "cpu")
    x = np.random.default_rng(2).random((1, 16, 16, 1)).astype(np.float32)
    hir = ice_exp.synthetic_hir((16, 16))
    with mock.patch.dict(sys.modules, {"matplotlib": None}):
        assert ice_exp.save_mesh_png(model, x, hir, str(tmp_path / "none.png")) is None
    path = str(tmp_path / "mesh.png")
    assert ice_exp.save_mesh_png(model, x, hir, path) == path and os.path.getsize(path) > 0


@pytest.fixture(scope="module")
def exp0(tmp_path_factory):
    """``ice_exp -e 0`` at the small size, run once for the module."""
    results = tmp_path_factory.mktemp("exp0")
    patches = _narrow()
    for p in patches:
        p.start()
    try:
        out = ice_exp.main(["-m", "6", "-e", "0", *SMALL, "--results-dir", str(results),
                            "--mesh-png"])
    finally:
        for p in reversed(patches):
            p.stop()
    saved = dict(np.load(out["predictions"]))
    return results, out, saved


def test_ice_exp_experiment_0(exp0):
    results, out, saved = exp0
    files = sorted(os.listdir(results))
    name = "M6_Y2007_Y2007_I10O2"
    assert files == [f"{name}.pt", f"loss_{name}.json", f"mesh_hir_{name}.png",
                     f"valpredictions_{name}.npz"]
    loss = json.load(open(results / f"loss_{name}.json"))
    assert np.isfinite(loss["train_loss"]).all() and np.isfinite(loss["test_loss"]).all()
    assert saved["y_hat"].shape == saved["y_true"].shape == (len(saved["launch_dates"]), 2, 16,
                                                              16, 1)
    assert np.isfinite(saved["y_hat"]).all()
    np.testing.assert_array_equal(saved["y_hat"], out["val_predictions"])


def test_ice_inf_reproduces_ice_exp(exp0, narrow):
    results, _, saved = exp0
    out = ice_inf.main(["-m", "6", "-e", "0", "--results-dir", str(results), *DATA])
    again = np.load(out["predictions"])
    for k in ("y_hat", "y_true", "launch_dates"):
        np.testing.assert_array_equal(again[k], saved[k])  # bit for bit


@pytest.mark.parametrize("exp", [5, 9])
def test_ice_exp_experiments(tmp_path, narrow, exp):
    """Experiment 5 (TBPTT 45 on the grid) and 9 (the multires curriculum
    into the heterogeneous preset mesh on the edge list)."""
    out = ice_exp.main(["-m", "6", "-e", str(exp), *SMALL, "--results-dir", str(tmp_path)])
    assert np.isfinite(out["loss"]["train_loss"]).all()
    assert np.isfinite(out["val_predictions"]).all()
    assert os.path.isfile(out["weights"]) and os.path.isfile(out["predictions"])


def test_ice_exp_multires_warm_start(tmp_path, narrow):
    """The full model starts from the half model's trained weights."""
    loaded = []
    load = torch.nn.Module.load_state_dict

    def record(module, state, *a, **kw):
        loaded.append({k: v.clone() for k, v in state.items()})
        return load(module, state, *a, **kw)

    with mock.patch.object(torch.nn.Module, "load_state_dict", record):
        ice_exp.main(["-m", "6", "-e", "3", *SMALL, "--results-dir", str(tmp_path),
                      "--epochs", "0"])
    assert len(loaded) == 1
    model = torch.load(tmp_path / "M6_Y2007_Y2007_I10O2.pt", weights_only=True)
    for k, v in loaded[0].items():
        assert torch.equal(model[k], v), k  # 0 full epochs: the half model's weights


def test_ice_exp_data_parallel_on_cpu_ranks(tmp_path, monkeypatch, narrow, exp0):
    """``--dp-devices 2 --device cpu``: two spawned gloo ranks run
    ``_rank_main`` (here at the tests' widths with the cut datasets, which
    the spawned ranks cannot inherit); rank 0 alone writes the run's files, and its losses
    are the one-process run's."""
    launch = dp.launch
    calls = []

    def small_launch(fn, world, **kw):
        calls.append((fn, world, kw["backend"], kw["device"]))
        return launch(w.small_ice_exp_rank, world, **kw)

    monkeypatch.setattr(ice_exp.dp, "launch", small_launch)
    out = ice_exp.main(["-m", "6", "-e", "0", *SMALL, "--results-dir", str(tmp_path),
                        "--dp-devices", "2", "--mesh-png"])
    assert calls == [(ice_exp._rank_main, 2, "gloo", "cpu")]
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(exp0[0]))
    np.testing.assert_allclose(out["loss"]["train_loss"], exp0[1]["loss"]["train_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(out["loss"]["test_loss"], exp0[1]["loss"]["test_loss"],
                               rtol=1e-4)


def test_dp_devices_above_the_card_count_raise(tmp_path):
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"this machine has {cards}"):
        ice_exp.main(["-m", "6", "--synthetic", "--dp-devices", str(cards + 2),
                      "--results-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        ice_exp.main(["-m", "6", "--synthetic", "--synthetic-years", "1"])


def test_ice_exp_nwt(tmp_path, monkeypatch, narrow):
    """Seed 7's fields (here 8×8, every year the CLI reads), no climatology."""
    real = ice_exp_nwt.synthetic_dataset
    monkeypatch.setattr(ice_exp_nwt, "synthetic_dataset",
                        lambda seed: real(shape=(8, 8), seed=seed))
    monkeypatch.setattr(ice_exp_nwt, "MODEL_KWARGS", NARROW)
    out = ice_exp_nwt.main(["-m", "6", "--synthetic", "--epochs", "1", "--batch-size", "2",
                            "--results-dir", str(tmp_path), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == ["loss_nwt_M6_I10O10.json", "nwt_M6_I10O10.pt",
                                            "valpredictions_nwt_M6_I10O10.npz"]
    assert np.isfinite(out["loss"]["train_loss"]).all()
    assert out["val_predictions"].shape[1:] == (10, 8, 8, 1)


def test_ice_exp_cnnlstm_raises_where_the_jax_cli_fails(tmp_path):
    with pytest.raises(ValueError, match="use_climatology=True"):
        ice_exp_cnnlstm.main(["-m", "6", "--synthetic", "--epochs", "1",
                              "--results-dir", str(tmp_path), "--device", "cpu"])


def test_ice_profile(tmp_path, capsys, narrow):
    trace = tmp_path / "trace"
    ice_profile.main(["--crop", "16", "--epochs", "1", "--batch-size", "2", "--device", "cpu",
                      "--trace-dir", str(trace), "--trace-summary"])
    out = capsys.readouterr().out
    assert "[phase] dataset build" in out and "[phase] train" in out
    assert "[phase] predict" in out and "top " in out and "[trace] written" in out
    assert any(name.endswith(".pt.trace.json") for name in os.listdir(trace))


def test_mnist_demo(tmp_path, monkeypatch, capsys):
    """The demo with its 50-video test and validation sets cut to 8."""
    monkeypatch.chdir(tmp_path)
    real = mnist_demo.ModMovingMNISTDataset
    monkeypatch.setattr(mnist_demo, "ModMovingMNISTDataset",
                        lambda n, **kw: real(min(n, 8), **kw))
    argv = ["--canvas", "16", "--digit", "8", "--train-samples", "8", "--epochs", "1",
            "--batch-size", "8", "--t-out", "3", "--sweep-thresholds", "--device", "cpu"]
    scores = mnist_demo.main(argv + ["--render", str(tmp_path / "demo")])
    assert np.isfinite(scores["RMSE"])
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".png")) == sorted(
        [f"mesh_thresh_{t}.png" for t in mnist_demo.SWEEP_THRESHOLDS]
        + [f"demo_{i}.png" for i in range(3)])
    capsys.readouterr()
    with mock.patch.dict(sys.modules, {"matplotlib": None}):
        mnist_demo.main(argv + ["--render", str(tmp_path / "none")])
    out = capsys.readouterr().out
    assert "matplotlib unavailable; skipping render" in out
    assert all(f"thresh {t}: " in out and "nodes" in out for t in mnist_demo.SWEEP_THRESHOLDS)


def test_sweep_commands():
    cmds = sweep.sweep_commands(months=(6, 7), exp=3, extra_args=("--synthetic",))
    ref = jax_sweep.sweep_commands(months=(6, 7), exp=3, extra_args=("--synthetic",))
    assert [c[2] for c in cmds] == ["quadtree_mpnnlstm_tpu_torch.cli.ice_exp"] * 2
    assert [c[:2] + c[3:] for c in cmds] == [c[:2] + c[3:] for c in ref]
    assert cmds[0][-3:] == ["-e", "3", "--synthetic"]
