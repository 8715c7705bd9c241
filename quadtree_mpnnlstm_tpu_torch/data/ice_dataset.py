"""Sea-ice dataset windowing, climatology and synthetic inputs (numpy).

Own copy of ``quadtree_mpnnlstm_tpu/data/ice_dataset.py``, of
``synthetic_dataset`` of ``quadtree_mpnnlstm_tpu/cli/ice_exp.py`` and of
``ice_mask`` of ``bench.py``. ``IceDataset`` cuts per year×month windows:

  * train mode widens the month to ±1 month;
  * input/output timestep buffers around the month;
  * an injected day-of-year channel ``doy``;
  * min-max normalisation of each variable over each year's slice;
  * stride-1 sliding windows, NaN → 0;
  * optional ``y > y_binary_thresh`` binarisation.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset


def _month_add(date: datetime.datetime, months: int) -> datetime.datetime:
    m = date.month - 1 + months
    return date.replace(year=date.year + m // 12, month=m % 12 + 1, day=1)


def _day_of_year0(times: np.ndarray) -> np.ndarray:
    """0-based day of the year of datetime64[ns] times, as float64."""
    return ((times - times.astype("datetime64[Y]").astype(times.dtype))
            / np.timedelta64(1, "D")).astype(np.float64)


class GriddedDataset:
    """Minimal (time, lat, lon) multi-variable container: ``variables``
    maps a name to a (T, lat, lon) float array; ``times`` is (T,)
    datetime64[ns]."""

    def __init__(self, variables: Dict[str, np.ndarray], times: np.ndarray):
        self.variables = {k: np.asarray(v) for k, v in variables.items()}
        self.times = np.asarray(times, dtype="datetime64[ns]")
        first = next(iter(self.variables.values()))
        if not all(v.shape == first.shape for v in self.variables.values()):
            raise ValueError("variables differ in shape")
        if len(self.times) != first.shape[0]:
            raise ValueError("times and variables differ in length")

    @property
    def data_vars(self):
        return list(self.variables.keys())

    @property
    def image_shape(self):
        return next(iter(self.variables.values())).shape[1:]

    @classmethod
    def from_xarray(cls, ds, data_vars: Optional[Sequence[str]] = None) -> "GriddedDataset":
        """An ``xarray.Dataset`` (or anything with its ``data_vars``,
        ``ds[name].values`` and ``ds.time.values``) → a GriddedDataset of
        ``data_vars`` (default: all of them); xarray is not imported."""
        names = data_vars or list(ds.data_vars)
        return cls({n: np.asarray(ds[n].values) for n in names}, np.asarray(ds.time.values))


class IceDataset(ArrayDataset):
    """(x, y, launch_date) windows of ``years`` × ``month``; x (N, T_in,
    rows, cols, len(x_vars)), y (N, T_out, rows, cols, len(y_vars)),
    launch dates in ns since the epoch."""

    def __init__(
        self,
        ds: GriddedDataset,
        years: Sequence[int],
        month: int,
        input_timesteps: int,
        output_timesteps: int,
        x_vars: Optional[Sequence[str]] = None,
        y_vars: Optional[Sequence[str]] = None,
        train: bool = False,
        y_binary_thresh: Optional[float] = None,
    ):
        self.train = train
        x, y, launch_dates = self._get_xy(ds, years, month, input_timesteps, output_timesteps,
                                          x_vars, y_vars, y_binary_thresh)
        super().__init__(x, y, launch_dates)

    def _get_xy(self, ds, years, month, input_timesteps, output_timesteps, x_vars, y_vars,
                y_binary_thresh):
        x_vars = list(ds.data_vars) if x_vars is None else list(x_vars)
        y_vars = list(ds.data_vars) if y_vars is None else list(y_vars)
        rows, cols = ds.image_shape

        xs, ys, lds = [], [], []
        for year in years:
            first = datetime.datetime(year, month, 1)
            if self.train:  # 3 months around the month of interest
                start, end = _month_add(first, -1), _month_add(first, 2)
            else:
                start, end = first, _month_add(first, 1)
            start -= datetime.timedelta(days=input_timesteps)
            end += datetime.timedelta(days=output_timesteps - 1)

            sel = (ds.times >= np.datetime64(start)) & (ds.times <= np.datetime64(end))
            idx = np.nonzero(sel)[0]
            if len(idx) == 0:
                continue
            times = ds.times[idx]

            # the (T, rows, cols) fields of the slice, with the doy channel
            doy = _day_of_year0(times) + 1.0
            fields = {v: ds.variables[v][idx] for v in set(x_vars + y_vars) - {"doy"}}
            fields["doy"] = np.broadcast_to(doy[:, None, None], (len(idx), rows, cols)).copy()

            # min-max normalisation over this year's slice
            for v, arr in fields.items():
                lo, hi = np.nanmin(arr), np.nanmax(arr)
                fields[v] = (arr - lo) / (hi - lo if hi != lo else 1.0)

            num = len(idx) - output_timesteps - input_timesteps
            if num <= 0:
                continue
            x_all = np.nan_to_num(np.stack([fields[v] for v in x_vars], axis=-1))
            y_all = np.nan_to_num(np.stack([fields[v] for v in y_vars], axis=-1))

            # stride-1 sliding windows; the final window is dropped, as the
            # reference's strict loop bound drops it
            xs.append(np.stack([x_all[i:i + input_timesteps] for i in range(num)]))
            ys.append(np.stack([
                y_all[i + input_timesteps:i + input_timesteps + output_timesteps]
                for i in range(num)]))
            lds.append(times[input_timesteps:-output_timesteps][:num]
                       .astype("datetime64[ns]").astype(np.int64))

        x = np.concatenate(xs, 0).astype("float32")
        y = np.concatenate(ys, 0).astype("float32")
        launch_dates = np.concatenate(lds, 0)
        if y_binary_thresh is not None:
            y = (y > y_binary_thresh).astype("float32")
        return x, y, launch_dates


def climatology_from_dataset(ds: GriddedDataset, var: str = "siconc") -> np.ndarray:
    """Day-of-year normals (366, rows, cols) of ``var``, NaN → 0; days
    without data (a leap day) take the mean over all days."""
    arr = np.nan_to_num(ds.variables[var])
    doy = _day_of_year0(ds.times).astype(np.int64)
    out = np.zeros((366, *ds.image_shape), np.float32)
    counts = np.zeros(366)
    for d in range(366):
        sel = doy == d
        if sel.any():
            out[d] = arr[sel].mean(0)
            counts[d] = sel.sum()
    if (counts == 0).any():
        out[counts == 0] = arr.mean(0)
    return out


def synthetic_dataset(shape: Tuple[int, int] = (32, 32), years=(2007, 2018),
                      seed: int = 21) -> Tuple[GriddedDataset, np.ndarray]:
    """Season-driven synthetic ice fields (siconc, t2m, v10, u10, sshf)
    over the days of ``years[0]`` up to (not including) ``years[-1]``, with
    a permanent open-water band (NaN) as the mask. Returns (dataset,
    mask (rows, cols) bool, True = invalid)."""
    rng = np.random.default_rng(seed)
    times = np.arange(np.datetime64(f"{years[0]}-01-01"), np.datetime64(f"{years[-1]}-01-01"),
                      np.timedelta64(1, "D")).astype("datetime64[ns]")
    t = len(times)
    doy = _day_of_year0(times).astype(np.float32)
    season = 0.5 + 0.5 * np.cos(2 * np.pi * (doy - 30) / 365.25)
    yy, _ = np.mgrid[0:shape[0], 0:shape[1]]
    lat_grad = yy / shape[0]
    base = season[:, None, None] * (0.3 + 0.7 * lat_grad)[None]
    fields = {
        "siconc": np.clip(base + rng.normal(0, 0.05, (t, *shape)), 0, 1).astype(np.float32),
        "t2m": (270 - 30 * base + rng.normal(0, 2, (t, *shape))).astype(np.float32),
        "v10": rng.normal(0, 5, (t, *shape)).astype(np.float32),
        "u10": rng.normal(0, 5, (t, *shape)).astype(np.float32),
        "sshf": rng.normal(0, 50, (t, *shape)).astype(np.float32),
    }
    mask = lat_grad < 0.1  # permanent open-water band
    for v in fields.values():
        v[:, mask] = np.nan
    return GriddedDataset(fields, times), mask


def ice_mask(shape: Tuple[int, int] = (224, 304), seed: int = 0) -> np.ndarray:
    """Hudson-Bay-like land mask (True = invalid): blocky coastline blobs
    and an open band, about a third of the pixels."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((shape[0] // 16 + 1, shape[1] // 16 + 1)) < 0.28
    blocks = np.kron(coarse, np.ones((16, 16), bool))[:shape[0], :shape[1]]
    yy = np.mgrid[0:shape[0], 0:shape[1]][0] / shape[0]
    return blocks | (yy < 0.06)
