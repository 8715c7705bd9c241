"""Offline evaluation and reporting (numpy).

Own copy of ``quadtree_mpnnlstm_tpu/eval/results.py``: masked metric
closures, RMSE and accuracy heatmaps over launch month × lead time, the
persistence and climatology baselines, difference maps, loss-curve grids,
GIF rendering, and ``main``, which merges per-month prediction files into
one report. Everything runs on (N, T, rows, cols, 1) numpy arrays; without
matplotlib a heatmap plot is written as a CSV (``<path>.csv``), and the
loss curves and GIF are skipped.
"""

from __future__ import annotations

import calendar
import datetime
import os
from typing import Dict, Optional, Sequence

import numpy as np

from quadtree_mpnnlstm_tpu_torch.utils.dates import int_to_datetime

# ------------------------------------------------------------------ metrics


def masked_accuracy(mask):
    def loss(y_true, y_pred):
        t = np.multiply(y_true, mask).reshape(-1)
        p = np.multiply(y_pred, mask).reshape(-1)
        return float(np.mean(t == p))

    return loss


def masked_MSE(mask):
    def loss(y_true, y_pred):
        return float(np.mean(np.multiply((y_pred - y_true) ** 2, mask)))

    return loss


def masked_RMSE(mask):
    def loss(y_true, y_pred):
        return float(
            np.sqrt(np.mean(np.multiply((y_pred - y_true) ** 2, mask)))
        )

    return loss


def masked_RMSE_along_axis(mask):
    def loss(y_true, y_pred):
        sq = np.multiply((y_pred - y_true) ** 2, mask)
        return np.sqrt(np.mean(sq, axis=(1, 2)))

    return loss


# ----------------------------------------------------------------- heatmaps


def _launch_months(launch_dates) -> np.ndarray:
    out = []
    for ld in np.asarray(launch_dates).reshape(-1):
        if isinstance(ld, (np.datetime64,)):
            out.append(ld.astype("datetime64[M]").astype(int) % 12 + 1)
        else:
            out.append(int_to_datetime(int(ld)).month)
    return np.asarray(out)


def create_heatmap(
    y_hat: np.ndarray,
    y_true: np.ndarray,
    launch_dates,
    mask: np.ndarray,
    accuracy: bool = False,
    binary_thresh: float = 0.5,
) -> np.ndarray:
    """(12, T) mean masked RMSE (or accuracy) by launch month × lead time;
    months without a launch are NaN."""
    n, t = y_hat.shape[:2]
    y_hat = np.nan_to_num(y_hat.reshape(n, t, *y_hat.shape[2:4]))
    y_true = np.nan_to_num(y_true.reshape(n, t, *y_true.shape[2:4]))
    months = _launch_months(launch_dates)
    valid = ~np.asarray(mask, bool)

    heat = np.zeros((12, t))
    count = np.zeros((12, t))
    for ts in range(t):
        a, b = y_true[:, ts], y_hat[:, ts]
        if accuracy:
            errs = np.array(
                [
                    masked_accuracy(valid)(
                        a[i] > binary_thresh, b[i] > binary_thresh
                    )
                    for i in range(n)
                ]
            )
        else:
            errs = masked_RMSE_along_axis(valid)(a, b)
        for i, e in enumerate(errs):
            heat[months[i] - 1, ts] += e
            count[months[i] - 1, ts] += 1
    with np.errstate(invalid="ignore"):
        return heat / count


def persistence_heatmap(
    y_true: np.ndarray, launch_dates, mask: np.ndarray, accuracy: bool = False
) -> np.ndarray:
    """Persistence baseline: the forecast is the day-1 truth held
    constant."""
    pers = np.repeat(y_true[:, :1], y_true.shape[1], axis=1)
    return create_heatmap(
        pers, y_true, launch_dates, mask, accuracy, binary_thresh=0.15
    )


def climatology_heatmap(
    y_true: np.ndarray,
    launch_dates,
    climatology: np.ndarray,
    mask: np.ndarray,
    accuracy: bool = False,
) -> np.ndarray:
    """Climatology baseline: the forecast of lead ts from launch date ld is
    the normal of the day of the year of ld + ts + 1 days, wrapped by the
    climatology's length."""
    n, t = y_true.shape[:2]
    clim = np.asarray(climatology)
    y_clim = np.empty_like(y_true)
    for i, ld in enumerate(np.asarray(launch_dates).reshape(-1)):
        base = int_to_datetime(int(ld))
        for ts in range(t):
            doy = (base + datetime.timedelta(days=ts + 1)).timetuple().tm_yday
            y_clim[i, ts, ..., 0] = clim[(doy - 1) % len(clim)]
    return create_heatmap(
        y_clim, y_true, launch_dates, mask, accuracy, binary_thresh=0.15
    )


# ------------------------------------------------------------------ reports


def save_heatmap_plot(heat: np.ndarray, path: str, title: str = "",
                      center: Optional[float] = None, vmin=None, vmax=None):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        np.savetxt(path + ".csv", heat, delimiter=",")
        return
    fig, ax = plt.subplots(dpi=80)
    cmap = "coolwarm" if center is not None else "viridis"
    im = ax.imshow(heat, aspect="auto", cmap=cmap, vmin=vmin, vmax=vmax)
    ax.set_yticks(range(12))
    ax.set_yticklabels([calendar.month_name[i + 1][:3] for i in range(12)])
    ax.set_xlabel("Lead time (days)")
    if title:
        ax.set_title(title)
    fig.colorbar(im)
    fig.savefig(path)
    plt.close(fig)


def save_loss_curves(losses: Dict[int, Dict[str, Sequence[float]]], path: str):
    """3×4 month grid of train/test loss curves (nothing without
    matplotlib)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, axs = plt.subplots(3, 4, figsize=(14, 6))
    for i, month in enumerate(range(1, 13)):
        ax = axs.flatten()[i]
        if month in losses:
            ax.plot(losses[month]["train_loss"], label="train")
            ax.plot(losses[month]["test_loss"], label="test")
            ax.legend()
        ax.set_ylabel("Loss (MSE)")
        ax.set_xlabel("Epoch")
        ax.set_title(calendar.month_name[month][:3])
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def generate_gif(
    y_true: np.ndarray,
    y_hat: np.ndarray,
    mask: np.ndarray,
    out_path: str,
    duration: int = 300,
):
    """True-vs-pred animation over lead time; None without matplotlib or
    PIL."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from PIL import Image
    except ImportError:
        return None
    frames = []
    valid = ~np.asarray(mask, bool)
    tmpdir = out_path + "_frames"
    os.makedirs(tmpdir, exist_ok=True)
    fns = []
    for ts in range(y_true.shape[0]):
        fig, axs = plt.subplots(1, 2, figsize=(8, 3))
        for ax, arr, name in (
            (axs[0], y_true[ts], "True"),
            (axs[1], y_hat[ts], "Pred"),
        ):
            a = np.where(valid, arr[..., 0], np.nan)
            ax.imshow(a, vmin=0, vmax=1)
            ax.set_title(f"{name} (step {ts + 1})")
        fig.tight_layout()
        fn = os.path.join(tmpdir, f"{ts}.png")
        fig.savefig(fn)
        plt.close(fig)
        fns.append(fn)
    for fn in fns:
        frames.append(Image.open(fn))
    frames[0].save(
        out_path, format="GIF", append_images=frames[1:], save_all=True,
        duration=duration, loop=0,
    )
    for fn in fns:
        os.remove(fn)
    os.rmdir(tmpdir)
    return out_path


def full_report(
    y_hat: np.ndarray,
    y_true: np.ndarray,
    launch_dates,
    mask: np.ndarray,
    climatology: Optional[np.ndarray],
    out_dir: str,
):
    """Model, persistence and climatology heatmaps, their differences, and
    the CSVs ``heatmap.csv`` and ``heatmap_clim.csv``; returns the model's
    heatmap."""
    os.makedirs(out_dir, exist_ok=True)
    heat = create_heatmap(y_hat, y_true, launch_dates, mask)
    np.savetxt(os.path.join(out_dir, "heatmap.csv"), heat, delimiter=",")
    save_heatmap_plot(heat, os.path.join(out_dir, "heatmap.png"),
                      vmin=0.02, vmax=0.18)

    pers = persistence_heatmap(y_true, launch_dates, mask)
    save_heatmap_plot(pers, os.path.join(out_dir, "heatmap_pers.png"),
                      vmin=0.02, vmax=0.18)
    save_heatmap_plot(
        heat - pers, os.path.join(out_dir, "heatmap_diff_pers.png"),
        title="Blue -> Model outperforms persistence", center=0.0,
        vmin=-0.05, vmax=0.05,
    )

    if climatology is not None:
        clim = climatology_heatmap(y_true, launch_dates, climatology, mask)
        np.savetxt(
            os.path.join(out_dir, "heatmap_clim.csv"), clim, delimiter=","
        )
        save_heatmap_plot(clim, os.path.join(out_dir, "heatmap_clim.png"),
                          vmin=0.02, vmax=0.18)
        save_heatmap_plot(
            heat - clim, os.path.join(out_dir, "heatmap_diff_clim.png"),
            title="Blue -> Model outperforms climatology", center=0.0,
        )
    return heat


# ------------------------------------------------- runnable report entry
# Glob the per-month outputs ``valpredictions_M{month}_*`` of one results
# directory, concatenate them on the launch date, and write the
# heatmap/CSV/GIF report in one command:
#   python -m quadtree_mpnnlstm_tpu_torch.eval.results --results-dir <dir>


def load_predictions(path: str):
    """(y_hat, y_true, launch_dates) from one prediction file: npz, or
    netCDF in ``save_predictions``' xarray layout (xarray is imported
    for it)."""
    if path.endswith(".npz"):
        z = np.load(path)
        y_hat, y_true = z["y_hat"], z["y_true"]
        if y_hat.ndim == 4:
            y_hat, y_true = y_hat[..., None], y_true[..., None]
        return y_hat, y_true, z["launch_dates"]
    import xarray as xr

    ds = xr.open_dataset(path)
    return (
        ds["y_hat"].values[..., None],
        ds["y_true"].values[..., None],
        ds["launch_date"].values,
    )


def merge_predictions(results_dir: str, pattern: str = "valpredictions_M*"):
    """Every month's prediction file under ``results_dir`` concatenated
    on the launch-date axis → (y_hat, y_true, launch_dates, files)."""
    import glob as _glob

    files = sorted(
        f
        for f in _glob.glob(os.path.join(results_dir, pattern))
        if f.endswith((".nc", ".npz"))
    )
    if not files:
        raise FileNotFoundError(
            f"no {pattern}[.nc|.npz] files under {results_dir}"
        )
    y_hat, y_true, lds = [], [], []
    for f in files:
        h, t, ld = load_predictions(f)
        y_hat.append(h)
        y_true.append(t)
        lds.append(np.asarray(ld).reshape(-1))
    return (
        np.concatenate(y_hat, axis=0),
        np.concatenate(y_true, axis=0),
        np.concatenate(lds, axis=0),
        files,
    )


def _load_month_losses(results_dir: str) -> Dict[int, Dict[str, list]]:
    import glob as _glob
    import json
    import re

    out = {}
    for f in _glob.glob(os.path.join(results_dir, "loss_M*.json")):
        m = re.search(r"loss_M(\d+)_", os.path.basename(f))
        if not m:
            continue
        with open(f) as fh:
            out[int(m.group(1))] = json.load(fh)
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Merge per-month valpredictions_M* files and emit the "
        "RMSE/accuracy heatmap report"
    )
    ap.add_argument("--results-dir", required=True)
    ap.add_argument("--pattern", default="valpredictions_M*")
    ap.add_argument("--out-dir", default=None,
                    help="report output dir (default <results-dir>/report)")
    ap.add_argument("--mask", default=None,
                    help=".npy land mask; default = NaN pixels of y_true")
    ap.add_argument("--climatology", default=None,
                    help=".npy (365, rows, cols) day-of-year normals")
    ap.add_argument("--gif", action="store_true",
                    help="render a true-vs-pred GIF of the first sample")
    args = ap.parse_args(argv)

    y_hat, y_true, lds, files = merge_predictions(
        args.results_dir, args.pattern
    )
    print(f"merged {len(files)} month files -> {y_hat.shape[0]} forecasts")

    if args.mask:
        mask = np.load(args.mask).astype(bool)
    else:
        mask = np.isnan(y_true[0, 0, ..., 0])
    clim = np.load(args.climatology) if args.climatology else None

    out_dir = args.out_dir or os.path.join(args.results_dir, "report")
    heat = full_report(y_hat, y_true, lds, mask, clim, out_dir)

    losses = _load_month_losses(args.results_dir)
    if losses:
        save_loss_curves(losses, os.path.join(out_dir, "loss_curves.png"))
    if args.gif:
        generate_gif(
            np.nan_to_num(y_true[0]), np.nan_to_num(y_hat[0]), mask,
            os.path.join(out_dir, "forecast.gif"),
        )
    months = sorted(set(_launch_months(lds).tolist()))
    print(
        f"report -> {out_dir} (months {months}; mean masked RMSE "
        f"{np.nanmean(heat):.4f})"
    )
    return out_dir


if __name__ == "__main__":
    main()
