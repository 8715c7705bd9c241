"""PyTorch port vs JAX package: data and eval (numpy modules) and
``prefetch_to_device``.

Every output is compared exactly (``np.testing.assert_array_equal``, NaN
positions included): ``utils/normalize.py``; ``data/netcdf_io.py`` on netCDF4 files that
the test writes with h5py (a CF-packed variable with a fill value, CF time
with a clock, two year files concatenated); ``GriddedDataset.from_xarray``
on an xarray-shaped stand-in (no xarray needed);
``prefetch_to_device`` on the CPU (the same batches in the same order as
tensors, launch dates as numpy, and a CNN-LSTM trainer epoch fed through
it bit for bit the plain loader's); every function of ``eval/results.py``
(the heatmap plot's CSV path with matplotlib hidden on both sides, and
``main`` over npz month files); every function of ``eval/ports.py``, A*
on random ice fields path for path.
"""

import json
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from quadtree_mpnnlstm_tpu.data import netcdf_io as j_nc
from quadtree_mpnnlstm_tpu.eval import ports as j_ports
from quadtree_mpnnlstm_tpu.eval import results as j_results
from quadtree_mpnnlstm_tpu.utils import normalize as j_norm
from quadtree_mpnnlstm_tpu_torch.data import netcdf_io as t_nc
from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import GriddedDataset, IceDataset
from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader, prefetch_to_device
from quadtree_mpnnlstm_tpu_torch.eval import ports as t_ports
from quadtree_mpnnlstm_tpu_torch.eval import results as t_results
from quadtree_mpnnlstm_tpu_torch.train.cnn_predictor import NextFramePredictorCNNLSTM
from quadtree_mpnnlstm_tpu_torch.utils import normalize as t_norm

SHAPE = (6, 8)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------- normalize


def test_normalize_and_gen_x_y():
    arr = np.random.default_rng(0).random((30, 3, 2, 4, 4)).astype(np.float32)
    _same(t_norm.normalize(arr), j_norm.normalize(arr))
    flat = np.random.default_rng(1).random((40, 5, 4)).astype(np.float32)
    got = list(t_norm.gen_x_y(flat, input_ts=3, batch_size=4, num_vars=4))
    want = list(j_norm.gen_x_y(flat, input_ts=3, batch_size=4, num_vars=4))
    assert len(got) == len(want) > 1
    for (gx, gy), (wx, wy) in zip(got, want):
        _same(gx, wx)
        _same(gy, wy)


# ---------------------------------------------------------------- netCDF


def _write_year(path, year, seed):
    """A combine-ETL-like year file: CF "days since" time, five float
    variables with a NaN coastal band, and ``t2m`` packed as int16 with a
    scale, an offset and a fill value."""
    import h5py

    rng = np.random.default_rng(seed)
    times = np.arange(np.datetime64(f"{year}-01-01"), np.datetime64(f"{year + 1}-01-01"),
                      np.timedelta64(1, "D"))
    days = (times - np.datetime64("1900-01-01")) / np.timedelta64(1, "D")
    with h5py.File(path, "w") as f:
        tv = f.create_dataset("time", data=days.astype(np.float64))
        tv.attrs["units"] = np.bytes_("days since 1900-01-01")
        f.create_dataset("latitude", data=np.linspace(55, 65, SHAPE[0]))
        for name in ("siconc", "u10", "v10", "sshf"):
            arr = rng.random((len(times), *SHAPE)).astype(np.float32)
            arr[:, :1] = np.nan
            f.create_dataset(name, data=arr)
        packed = rng.integers(-30000, 30000, (len(times), *SHAPE)).astype(np.int16)
        packed[:, 0, :3] = -32767
        d = f.create_dataset("t2m", data=packed)
        d.attrs["scale_factor"] = np.float64(0.001)
        d.attrs["add_offset"] = np.float64(275.0)
        d.attrs["_FillValue"] = np.int16(-32767)


def test_read_netcdf_packed_and_clock_time(tmp_path):
    import h5py

    path = tmp_path / "one.nc"
    _write_year(path, 2007, 0)
    got, want = t_nc.read_netcdf(path), j_nc.read_netcdf(path)
    assert sorted(got[0]) == sorted(want[0]) == ["siconc", "sshf", "t2m", "u10", "v10"]
    for name in want[0]:
        assert got[0][name].dtype == np.float32
        _same(got[0][name], want[0][name])
    _same(got[1], want[1])
    assert np.isnan(got[0]["t2m"][:, 0, :3]).all()

    clock = tmp_path / "clock.nc"
    with h5py.File(clock, "w") as f:
        tv = f.create_dataset("time", data=np.array([0.0, 1.5, 36.0]))
        tv.attrs["units"] = np.bytes_("hours since 2001-02-03 04:05:06.5")
        f.create_dataset("siconc", data=np.ones((3, 2, 2), np.float32))
    _same(t_nc.read_netcdf(clock)[1], j_nc.read_netcdf(clock)[1])
    for units in ("fortnights since 2000-01-01", "days after 2000-01-01"):
        with pytest.raises(ValueError):
            t_nc.decode_cf_time(np.zeros(1), units)
        with pytest.raises(ValueError):
            j_nc.decode_cf_time(np.zeros(1), units)


def test_read_netcdf_many(tmp_path):
    paths = []
    for year in (2008, 2007):  # out of order on purpose
        paths.append(str(tmp_path / f"era5_glorys_{year}.nc"))
        _write_year(paths[-1], year, year)
    got, want = t_nc.read_netcdf_many(paths), j_nc.read_netcdf_many(paths)
    assert isinstance(got, GriddedDataset)
    assert sorted(got.data_vars) == sorted(want.data_vars)
    for name in want.data_vars:
        _same(got.variables[name], want.variables[name])
    _same(got.times, want.times)
    assert len(got.times) == 731 and got.image_shape == SHAPE
    with pytest.raises(FileNotFoundError):
        t_nc.read_netcdf_many([])


def test_from_xarray_duck_type():
    """``GriddedDataset.from_xarray`` reads the xarray Dataset protocol
    (``data_vars``, ``ds[name].values``, ``ds.time.values``)."""
    from quadtree_mpnnlstm_tpu.data.ice_dataset import GriddedDataset as JGridded

    class _Arr:
        def __init__(self, v):
            self.values = v

    class _FakeXarray:
        def __init__(self, variables, times):
            self.data_vars = dict.fromkeys(variables)
            self._variables = variables
            self.time = _Arr(times)

        def __getitem__(self, k):
            return _Arr(self._variables[k])

    times = np.arange(np.datetime64("2007-01-01"), np.datetime64("2007-01-11"),
                      np.timedelta64(1, "D"))
    rng = np.random.default_rng(0)
    fields = {"siconc": rng.random((10, 4, 4)), "t2m": rng.random((10, 4, 4))}
    for names in (None, ["t2m"]):
        got = GriddedDataset.from_xarray(_FakeXarray(fields, times), names)
        want = JGridded.from_xarray(_FakeXarray(fields, times), names)
        assert got.data_vars == want.data_vars
        for n in want.data_vars:
            _same(got.variables[n], want.variables[n])
        _same(got.times, want.times)


# ---------------------------------------------------------------- prefetch


def test_prefetch_to_device_on_cpu(tmp_path):
    """The same batches in the same order as tensors on the CPU, launch
    dates as numpy; a CNN-LSTM trainer's epoch through it equals the plain
    loader's bit for bit (loss and every weight)."""
    rng = np.random.default_rng(0)
    x = rng.random((5, 2, 8, 8, 1)).astype(np.float32)
    y = rng.random((5, 2, 8, 8, 1)).astype(np.float32)
    lds = np.arange(5, dtype=np.int64)
    plain = list(DataLoader(ArrayDataset(x, y, lds), batch_size=2, shuffle=True, seed=3))
    for size in (1, 2, 8):
        loader = DataLoader(ArrayDataset(x, y, lds), batch_size=2, shuffle=True, seed=3)
        got = list(prefetch_to_device(loader, size=size, device="cpu"))
        assert len(got) == len(plain) == 3
        for (gx, gy, gl), (px, py, pl) in zip(got, plain):
            assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
            assert isinstance(gl, np.ndarray)
            _same(gx.numpy(), px)
            _same(gy.numpy(), py)
            _same(gl, pl)

    kw = dict(image_shape=(8, 8), input_features=1, hidden_size=4, input_timesteps=2,
              output_timesteps=2, n_layers=1, dropout=0.1, device="cpu", run_dir=str(tmp_path))
    runs = []
    for fetch in (False, True):
        trainer = NextFramePredictorCNNLSTM(**kw)
        train = DataLoader(ArrayDataset(x, y, lds), batch_size=2)
        test = DataLoader(ArrayDataset(x[:2], y[:2], lds[:2]), batch_size=2)
        if fetch:
            train = list(prefetch_to_device(train, device="cpu"))
            test = list(prefetch_to_device(test, device="cpu"))
        trainer.train(train, test, n_epochs=1, lr=0.01)
        runs.append((trainer.train_loss, trainer.test_loss, trainer.model.state_dict()))
    assert runs[0][:2] == runs[1][:2]
    for name, value in runs[0][2].items():
        assert torch.equal(value, runs[1][2][name]), name


# ---------------------------------------------------------------- results


def _predictions(n=6, t=4, seed=0, months=(3, 3, 3, 7, 7, 7)):
    rng = np.random.default_rng(seed)
    y_true = rng.random((n, t, *SHAPE, 1)).astype(np.float32)
    y_hat = (y_true + rng.normal(0, 0.05, y_true.shape)).astype(np.float32)
    y_true[:, :, 0, 0] = np.nan  # NaN → 0 on both arrays
    lds = np.array([np.datetime64(f"2007-{m:02d}-{10 + i:02d}", "ns").astype(np.int64)
                    for i, m in enumerate(months)])
    mask = np.zeros(SHAPE, bool)
    mask[0, :3] = True
    return y_hat, y_true, lds, mask


def test_metric_closures():
    rng = np.random.default_rng(2)
    a, b = rng.random((3, 5, 5)), rng.random((3, 5, 5))
    m = rng.random((5, 5)) > 0.3
    for name in ("masked_accuracy", "masked_MSE", "masked_RMSE", "masked_RMSE_along_axis"):
        args = (a > 0.5, b > 0.5) if name == "masked_accuracy" else (a, b)
        _same(getattr(t_results, name)(m)(*args), getattr(j_results, name)(m)(*args))


@pytest.mark.parametrize("accuracy", [False, True], ids=["rmse", "accuracy"])
def test_heatmaps(accuracy):
    y_hat, y_true, lds, mask = _predictions()
    clim = np.random.default_rng(3).random((365, *SHAPE)).astype(np.float32)
    _same(t_results.create_heatmap(y_hat, y_true, lds, mask, accuracy),
          j_results.create_heatmap(y_hat, y_true, lds, mask, accuracy))
    _same(t_results.persistence_heatmap(y_true, lds, mask, accuracy),
          j_results.persistence_heatmap(y_true, lds, mask, accuracy))
    # day of year (ld + ts + 1 days) wrapped by the climatology's length
    _same(t_results.climatology_heatmap(y_true, lds, clim, mask, accuracy),
          j_results.climatology_heatmap(y_true, lds, clim, mask, accuracy))
    dt64 = lds.astype("datetime64[ns]")
    _same(t_results._launch_months(dt64), j_results._launch_months(dt64))


def _files(directory):
    return sorted(p.name for p in directory.iterdir())


def test_full_report_and_plots(tmp_path):
    """``full_report`` writes the same CSVs and plots; without matplotlib a
    heatmap plot is a CSV, equal on both sides; the loss curves and the GIF
    are written by both."""
    y_hat, y_true, lds, mask = _predictions()
    clim = np.random.default_rng(3).random((366, *SHAPE)).astype(np.float32)
    for side, mod in (("port", t_results), ("jax", j_results)):
        out = tmp_path / side
        heat = mod.full_report(y_hat, y_true, lds, mask, clim, str(out))
        assert np.isfinite(heat[[2, 6]]).all() and np.isnan(heat[[0, 1, 3]]).all()
        with mock.patch.dict(sys.modules, {"matplotlib": None}):
            mod.save_heatmap_plot(heat, str(out / "nomatplotlib"))
            mod.save_loss_curves({3: {"train_loss": [1.0], "test_loss": [1.0]}},
                                 str(out / "nocurves.png"))
            assert mod.generate_gif(y_true[0], y_hat[0], mask, str(out / "no.gif")) is None
        mod.save_loss_curves({3: {"train_loss": [1.0, 0.5], "test_loss": [1.1, 0.6]}},
                             str(out / "loss_curves.png"))
        gif = mod.generate_gif(np.nan_to_num(y_true[0]), y_hat[0], mask,
                               str(out / "forecast.gif"))
        assert gif == str(out / "forecast.gif")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for name in ("heatmap.csv", "heatmap_clim.csv", "nomatplotlib.csv"):
        _same(np.loadtxt(tmp_path / "port" / name, delimiter=","),
              np.loadtxt(tmp_path / "jax" / name, delimiter=","))


def test_results_main_merges_months(tmp_path, capsys):
    """``main`` over npz month files (and loss files): the merged
    predictions, the month losses and the report's CSVs equal the JAX
    package's."""
    results = tmp_path / "results"
    results.mkdir()
    for m in (3, 7):
        y_hat, y_true, lds, _ = _predictions(n=3, seed=m, months=(m,) * 3)
        y_true[:, :, 0, 0] = 0.0
        np.savez(results / f"valpredictions_M{m}_Y2007_Y2012_I4O4.npz",
                 y_hat=y_hat[..., 0] if m == 3 else y_hat, y_true=y_true[..., 0] if m == 3
                 else y_true, launch_dates=lds)
        with open(results / f"loss_M{m}_Y2007.json", "w") as f:
            json.dump({"train_loss": [1.0, 0.5], "test_loss": [1.1, 0.6]}, f)
    got, want = t_results.merge_predictions(str(results)), j_results.merge_predictions(str(results))
    for a, b in zip(got, want):
        _same(a, b)
    assert t_results._load_month_losses(str(results)) == j_results._load_month_losses(str(results))
    mask = np.zeros(SHAPE, bool)
    mask[1, 1] = True
    np.save(tmp_path / "mask.npy", mask)
    np.save(tmp_path / "clim.npy", np.random.default_rng(0).random((365, *SHAPE)))
    outs = []
    for side, mod in (("port", t_results), ("jax", j_results)):
        outs.append(mod.main(["--results-dir", str(results), "--out-dir", str(tmp_path / side),
                              "--mask", str(tmp_path / "mask.npy"),
                              "--climatology", str(tmp_path / "clim.npy")]))
    printed = capsys.readouterr().out.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    lines = printed.splitlines()
    assert lines[:2] == lines[2:] and "months [3, 7]" in lines[1]
    for name in ("heatmap.csv", "heatmap_clim.csv"):
        heat = np.loadtxt(f"{outs[0]}/{name}", delimiter=",")
        _same(heat, np.loadtxt(f"{outs[1]}/{name}", delimiter=","))
        assert np.isfinite(heat[[2, 6]]).all() and np.isnan(heat[[0, 1, 3, 4, 5]]).all()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    with pytest.raises(FileNotFoundError):
        t_results.merge_predictions(str(tmp_path / "port"))


# ---------------------------------------------------------------- ports


def test_ice_proportion_and_dates():
    times = np.arange(np.datetime64("2015-01-01"), np.datetime64("2017-01-01"),
                      np.timedelta64(1, "D"))
    doy = (times - times.astype("datetime64[Y]")).astype(int)
    rng = np.random.default_rng(0)
    open_water = (doy > 165 + rng.integers(0, 10)) & (doy < 300 + rng.integers(0, 10))
    sic = np.where(open_water[:, None, None], 0.02, 0.9) + rng.normal(0, 0.1, (len(times), 24, 24))
    mask = rng.random((24, 24)) < 0.2
    for center, window in (((12, 12), 5), ((2, 22), 4), ((0, 0), 1)):
        got = t_ports.ice_proportion(sic, mask, center, window)
        _same(got, j_ports.ice_proportion(sic, mask, center, window))
        for level in (0.3, 0.5, 0.99):
            assert (t_ports.breakup_freezeup_dates(got, times, [2015, 2016], level)
                    == j_ports.breakup_freezeup_dates(got, times, [2015, 2016], level))
    _same(t_ports.ice_proportion(sic, np.ones((24, 24), bool), (5, 5)), np.zeros(len(times)))


@pytest.mark.parametrize("seed", range(4))
def test_astar_and_route_open(seed):
    """Random ice fields: the same path cell for cell (ties broken in the
    same heap order), or None on both, with and without diagonals."""
    rng = np.random.default_rng(seed)
    sic = rng.random((24, 30)) * (rng.random((24, 30)) < 0.5)
    mask = rng.random((24, 30)) < 0.1
    blocked = rng.random((24, 30)) < 0.3
    for start, end in (((0, 0), (23, 29)), ((12, 1), (3, 27)), ((5, 5), (5, 5))):
        for b in (blocked.copy(), np.zeros_like(blocked)):
            b[start] = b[end] = False
            for diagonal in (True, False):
                got = t_ports.astar_path(b, start, end, diagonal)
                want = j_ports.astar_path(b, start, end, diagonal)
                assert (got is None) == (want is None)
                if got is not None:
                    _same(got, want)
        got = t_ports.route_open(sic, mask, start, end)
        want = j_ports.route_open(sic, mask, start, end)
        assert (got is None) == (want is None)
        if got is not None:
            _same(got, want)


def test_ice_dataset_is_unchanged_by_netcdf_round_trip(tmp_path):
    """Windows cut from the netCDF reader's dataset equal windows cut from
    the in-memory fields it was written from."""
    path = tmp_path / "era5_glorys_2007.nc"
    _write_year(path, 2007, 5)
    variables, times = t_nc.read_netcdf(path)
    ds = t_nc.read_netcdf_many([str(path)])
    a = IceDataset(ds, [2007], 6, 3, 4, ["siconc", "u10", "doy"], ["siconc"])
    b = IceDataset(GriddedDataset(variables, times), [2007], 6, 3, 4, ["siconc", "u10", "doy"],
                   ["siconc"])
    _same(a.x, b.x)
    _same(a.y, b.y)
    _same(a.launch_dates, b.launch_dates)
