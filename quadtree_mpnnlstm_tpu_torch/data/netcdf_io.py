"""A netCDF4 reader on h5py: year files of (time, lat, lon) variables.

Own copy of ``quadtree_mpnnlstm_tpu/data/netcdf_io.py``. netCDF4 files are
HDF5, so the combined ERA5+GLORYS year files read through h5py without
xarray or the netCDF4 library: every 3-D dataset shaped (T, lat, lon), T
the length of the ``time`` coordinate, is a data variable, and CF-encoded
time ("<unit> since <epoch>" and values) decodes to datetime64[ns].
Packed variables (``scale_factor``/``add_offset``) are unpacked after
``_FillValue`` masks the packed values to NaN.

Scope: the layout that xarray's default netcdf4 engine writes, not a
general netCDF reader. Classic (netCDF-3) files are not HDF5 and are
rejected. h5py is imported when a file is read.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

_UNIT_NS = {
    "nanoseconds": 1,
    "microseconds": 1_000,
    "milliseconds": 1_000_000,
    "seconds": 1_000_000_000,
    "minutes": 60 * 1_000_000_000,
    "hours": 3_600 * 1_000_000_000,
    "days": 86_400 * 1_000_000_000,
}


def decode_cf_time(values: np.ndarray, units: str) -> np.ndarray:
    """``values`` in CF "<unit> since <epoch>" units → datetime64[ns]."""
    m = re.match(
        r"\s*(\w+)\s+since\s+(\d{4}-\d{1,2}-\d{1,2})"
        r"(?:[T ](\d{1,2}:\d{2}(?::\d{2}(?:\.\d+)?)?))?",
        units,
    )
    if not m:
        raise ValueError(f"unsupported CF time units: {units!r}")
    unit, date, clock = m.groups()
    if unit not in _UNIT_NS:
        raise ValueError(f"unsupported CF time unit: {unit!r}")
    parts = [int(p) for p in date.split("-")]
    epoch = np.datetime64(f"{parts[0]:04d}-{parts[1]:02d}-{parts[2]:02d}").astype("datetime64[ns]")
    if clock:
        fields = clock.split(":")
        ns = (int(fields[0]) * 3600 + int(fields[1]) * 60) * 1_000_000_000
        if len(fields) > 2:
            ns += int(round(float(fields[2]) * 1e9))
        epoch = epoch + np.timedelta64(ns, "ns")
    offsets = np.round(np.asarray(values, np.float64) * _UNIT_NS[unit]).astype("timedelta64[ns]")
    return epoch + offsets


def _attr_str(attrs, key, default=None):
    v = attrs.get(key, default)
    return v.decode() if isinstance(v, bytes) else v


def read_netcdf(path) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """One netCDF4 file → ({name: (T, lat, lon) float32 array}, times (T,))."""
    import h5py

    try:
        f = h5py.File(path, "r")
    except OSError as e:
        raise OSError(f"{path} is not an HDF5/netCDF4 file (classic netCDF-3 needs "
                      "the netCDF4 library)") from e
    with f:
        if "time" not in f:
            raise ValueError(f"{path}: no 'time' coordinate")
        tvar = f["time"]
        units = _attr_str(tvar.attrs, "units")
        raw = tvar[...]
        if units:
            times = decode_cf_time(raw, units)
        else:  # datetime64 nanoseconds as int64, without a CF units attribute
            times = np.asarray(raw).astype("datetime64[ns]")
        t = len(times)
        variables = {}
        for name, node in f.items():
            if not isinstance(node, h5py.Dataset) or node.ndim != 3 or node.shape[0] != t:
                continue
            arr = node[...].astype(np.float32)
            # _FillValue compares against the packed values (CF §8.1), so
            # mask before applying scale_factor/add_offset
            fill = node.attrs.get("_FillValue")
            if fill is not None and not np.isnan(np.float32(fill)):
                arr[arr == np.float32(fill)] = np.nan
            scale = node.attrs.get("scale_factor")
            offset = node.attrs.get("add_offset")
            if scale is not None or offset is not None:
                arr = arr * np.float32(1.0 if scale is None else np.asarray(scale).item()) \
                    + np.float32(0.0 if offset is None else np.asarray(offset).item())
            variables[name] = arr
        if not variables:
            raise ValueError(f"{path}: no (time, lat, lon) data variables")
        return variables, times


def read_netcdf_many(paths: Sequence[str]):
    """Files concatenated along time, in time order (stable) → a
    :class:`~quadtree_mpnnlstm_tpu_torch.data.ice_dataset.GriddedDataset`."""
    from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import GriddedDataset

    if not paths:
        raise FileNotFoundError("no netCDF files matched")
    parts: List[Tuple[np.ndarray, Dict[str, np.ndarray]]] = []
    for p in sorted(paths):
        variables, times = read_netcdf(p)
        parts.append((times, variables))
    names = list(parts[0][1])  # the first file's order
    for _, variables in parts[1:]:
        if set(variables) != set(names):
            raise ValueError(f"inconsistent variables across files: {sorted(names)} vs "
                             f"{sorted(variables)}")
    all_times = np.concatenate([t for t, _ in parts])
    order = np.argsort(all_times, kind="stable")
    merged = {n: np.concatenate([v[n] for _, v in parts])[order] for n in names}
    return GriddedDataset(merged, all_times[order])
