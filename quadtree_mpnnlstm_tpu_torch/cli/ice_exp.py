"""Hudson-Bay sea-ice experiment script.

Counterpart of ``quadtree_mpnnlstm_tpu/cli/ice_exp.py``:
``python -m quadtree_mpnnlstm_tpu_torch.cli.ice_exp -m <month> -e <exp>``
with the same eleven numbered experiment configs (0-10, ref ice_exp.py
:64-87), the multires curriculum (coarse 5 epochs → full resolution, ref
:91-112, :185-206), the preset static meshes of experiments 9 and 10 (ref
:127-130), day-of-year climatology (ref :141-142) and the prediction dumps
(ref :209-241, netCDF with xarray, else npz). Writes
``loss_<name>.json``, the weights ``<name>.pt`` and
``valpredictions_<name>.npz`` (or ``.nc``) to ``--results-dir``.

Real data needs netCDF files (read through xarray when it is installed,
else through h5py, ``data/netcdf_io.py``); ``--synthetic`` runs the same
pipeline on generated fields. Runs on the card unless ``--device cpu``.
``--dp-devices N`` trains data-parallel on N ranks (``parallel/dp.py``):
one card a rank over NCCL, or N CPU ranks over gloo with ``--device
cpu``; more ranks than cards raises. Only rank 0 writes files.

The warm start of the multires curriculum loads the half-resolution
model's weights into the full model (graph convolutions do not depend on
the resolution; both models read the climatology and share
``fused_gates``, so their parameters have one shape). Under
``--dp-devices`` the half model trains data-parallel too, and
``--max-loss`` guards both phases (the JAX CLI's coarse phase keeps the
literal 4).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import (
    GriddedDataset,
    IceDataset,
    climatology_from_dataset,
    synthetic_dataset,
)
from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader
from quadtree_mpnnlstm_tpu_torch.graph.static import (
    create_static_heterogeneous_graph,
    create_static_homogeneous_graph,
)
from quadtree_mpnnlstm_tpu_torch.parallel import dp
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.dates import int_to_datetime

NEG_INF = float("-inf")
X_VARS = ["siconc", "t2m", "v10", "u10", "sshf"]
Y_VARS = ["siconc"]
# the experiments' model widths (ref ice_exp.py:157-170)
MODEL_KWARGS = dict(hidden_size=32, dropout=0.1, n_layers=1, n_conv_layers=3, rnn_type="LSTM")
HALF_EPOCHS = 5  # the multires curriculum's coarse phase (ref :203-208)


def dist_from_05(arr):
    """Split-criterion transform (ref ice_exp.py:149-150), on numpy
    arrays and torch tensors alike."""
    return abs(abs(arr - 0.5) - 0.5)


def experiment_config(exp: int):
    """The numbered configs (ref ice_exp.py:48-87)."""
    cfg = dict(
        convolution_type="TransformerConv",
        lr=0.0001,
        multires_training=False,
        truncated_backprop=0,
        input_timesteps=10,
        preset_mesh=False,
    )
    if exp == 1:
        cfg["convolution_type"] = "GCNConv"
    elif exp == 2:
        cfg["lr"] = 0.001
    elif exp == 3:
        cfg["multires_training"] = True
    elif exp == 4:
        cfg["lr"] = 0.0001
    elif exp == 5:
        cfg["truncated_backprop"] = 45
    elif exp == 6:
        cfg["truncated_backprop"] = 30
    elif exp == 7:
        cfg["lr"] = 0.001
        cfg["input_timesteps"] = 30
    elif exp == 8:
        cfg["lr"] = 0.001
        cfg["input_timesteps"] = 90
    elif exp == 9:
        cfg["multires_training"] = True
        cfg["preset_mesh"] = "heterogeneous"
    elif exp == 10:
        cfg["multires_training"] = True
        cfg["preset_mesh"] = "homogeneous"
    return cfg


def synthetic_hir(shape):
    """Synthetic shipping corridor: a diagonal band across the grid (stands
    in for the ref's primary_route_mask.nc, ref ice_exp.py:122)."""
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    diag = yy / shape[0] - xx / shape[1]
    return np.abs(diag) < 0.08


def load_hir(path: str, image_shape=None):
    """Load the shipping-corridor high-interest region (ref ice_exp.py:122).

    Returns a bool array (NaN → False, nonzero → True) or None with a
    warning when the file / xarray is unavailable — or when its shape does
    not match ``image_shape`` (a mismatch would otherwise surface only as
    an opaque broadcast error deep inside the graph build).
    """
    try:
        import xarray as xr

        band = xr.open_dataset(path)["band_data"].values
        hir = np.nan_to_num(np.squeeze(band)) > 0
        if image_shape is not None and hir.shape != tuple(image_shape):
            print(
                f"high-interest region shape {hir.shape} != dataset image "
                f"shape {tuple(image_shape)}; training without it"
            )
            return None
        return hir
    except (ImportError, FileNotFoundError, OSError, KeyError) as e:
        print(f"high-interest region unavailable ({e}); training without it")
        return None


def save_mesh_png(model, x, hir, path):
    """Render the quadtree mesh with the HIR active (thresh=+inf splits only
    at mask/HIR boundaries, so corridor densification is visible); None
    without matplotlib."""
    out = model.test_threshold(x, float("inf"), high_interest_region=hir, contours=True)
    fig = out[0]
    if hasattr(fig, "savefig"):
        fig.savefig(path, dpi=100)
        return path
    return None


def load_real_dataset(data_glob: str):
    """Combined ERA5+GLORYS year files → (GriddedDataset, land mask).

    Prefers xarray (ref ice_exp.py:115-125 reads ``open_mfdataset``
    output); without it, netCDF4 files are read directly through h5py
    (data/netcdf_io.py) — same layout, no extra dependencies.
    """
    import glob

    paths = glob.glob(data_glob)
    try:
        import xarray as xr

        ds = xr.open_mfdataset(paths)
        gridded = GriddedDataset.from_xarray(ds)
    except ImportError:
        from quadtree_mpnnlstm_tpu_torch.data.netcdf_io import read_netcdf_many

        gridded = read_netcdf_many(paths)
    mask = np.isnan(gridded.variables["siconc"][0])
    return gridded, mask


def save_predictions(path, y_hat, y_true, launch_dates, output_timesteps):
    """netCDF when xarray is available, else npz (ref ice_exp.py:229-241)."""
    dates = [int_to_datetime(int(t)) for t in launch_dates]
    try:
        import xarray as xr

        ds = xr.Dataset(
            data_vars=dict(
                y_hat=(["launch_date", "timestep", "latitude", "longitude"], y_hat.squeeze(-1)),
                y_true=(["launch_date", "timestep", "latitude", "longitude"],
                        y_true.squeeze(-1)),
            ),
            coords=dict(launch_date=dates, timestep=np.arange(1, output_timesteps + 1)),
        )
        ds.to_netcdf(path + ".nc")
        return path + ".nc"
    except ImportError:
        np.savez(path + ".npz", y_hat=y_hat, y_true=y_true, launch_dates=np.asarray(launch_dates))
        return path + ".npz"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--month", type=int, required=True)
    parser.add_argument("-e", "--exp", type=int, default=0)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--data-glob", default="data/hb_era5_glorys_nc/*.nc")
    parser.add_argument("--hir-path", default="data/shipping_corridors/primary_route_mask.nc",
                        help="shipping-corridor mask netCDF (ref ice_exp.py:122)")
    parser.add_argument("--no-hir", action="store_true",
                        help="train without the high-interest region")
    parser.add_argument("--mesh-png", action="store_true",
                        help="save a quadtree-mesh png showing HIR densification to the "
                        "results dir (needs matplotlib)")
    parser.add_argument("--epochs", type=int, default=15)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--shape", type=int, nargs=2, default=(32, 32), metavar=("ROWS", "COLS"),
                        help="synthetic grid shape; the real Hudson-Bay flagship shape is "
                        "224 304 (ref ice_exp.py)")
    parser.add_argument("--synthetic-years", type=int, default=11,
                        help="years of synthetic daily data (memory: ~shape*365*5vars*4B "
                        "per year)")
    parser.add_argument("--max-loss", type=float, default=4.0,
                        help="divergence-guard threshold (ref literal 4; raise for short "
                        "smoke runs of long rollouts)")
    parser.add_argument("--t-out", type=int, default=None,
                        help="decoder rollout length (default: 90 real data / 10 synthetic; "
                        "the flagship uses 90)")
    parser.add_argument("--grid-attn", default="xla", choices=["xla", "pallas"],
                        help="GraphConfig.grid_attn of the pixelwise grid (the port launches "
                        "its stencil kernel on every card call either way)")
    parser.add_argument("--dp-devices", type=int, default=1,
                        help="data-parallel ranks (parallel/dp.py): the global batch is "
                        "sharded over them and the gradients averaged; one card a rank "
                        "(NCCL), or CPU ranks over gloo with --device cpu; requires "
                        "batch-size divisible by this")
    parser.add_argument("--shared-mesh", action="store_true",
                        help="batched training rides ONE mesh per step instead of "
                        "per-sample meshes (TrainConfig.shared_mesh; only meaningful with "
                        "--batch-size > 1)")
    parser.add_argument("--results-dir", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


def parse_args(argv):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.synthetic and args.synthetic_years < 2:
        parser.error("--synthetic-years must be >= 2 (one train year plus one held-out "
                     "test year)")
    return args


def experiment_data(args, seed: int = 21):
    """(dataset, mask, high-interest region or None, training years) of a
    run: the synthetic fields (``--synthetic``, ``--shape``,
    ``--synthetic-years``; the training years clamped to the generated
    span) or the netCDF files of ``--data-glob``."""
    training_years = range(2007, 2013)
    no_hir = getattr(args, "no_hir", False)
    if args.synthetic:
        y1 = 2007 + args.synthetic_years
        ds, mask = synthetic_dataset(shape=tuple(args.shape), years=(2007, y1), seed=seed)
        training_years = range(2007, max(2008, min(2013, y1 - 1)))
        hir = None if no_hir else synthetic_hir(mask.shape)
    else:
        ds, mask = load_real_dataset(args.data_glob)
        hir = None if no_hir else load_hir(args.hir_path, mask.shape)
    return ds, mask, hir, training_years


def val_years(ds, training_years):
    """The four years after the test year that the data holds, else the
    test year."""
    last_data_year = int(str(ds.times[-1])[:4])
    return [y for y in range(training_years[-1] + 2, training_years[-1] + 6)
            if y <= last_data_year] or [training_years[-1] + 1]


def experiment_name(month: int, training_years, t_in: int, t_out: int) -> str:
    return f"M{month}_Y{training_years[0]}_Y{training_years[-1]}_I{t_in}O{t_out}"


def make_model(cfg, image_shape, name: str, t_out: int, device: str, grid_attn: str = "xla",
               shared_mesh: bool = False, dp_devices: int = 1,
               graph_kwargs=None) -> NextFramePredictorS2S:
    """The experiment's forecaster: the pixelwise grid (``aggregation=
    "grid"``, per-gate stacks) unless the experiment rides a preset mesh
    (the edge list, fused stacks)."""
    if graph_kwargs is None and not cfg["preset_mesh"]:
        graph_kwargs = dict(aggregation="grid", grid_attn=grid_attn)
    return NextFramePredictorS2S(
        shared_mesh=shared_mesh,
        dp_devices=dp_devices,
        image_shape=image_shape,
        thresh=NEG_INF,  # quadtree off in the committed config (ref :145)
        experiment_name=name,
        input_features=len(X_VARS),
        input_timesteps=cfg["input_timesteps"],
        output_timesteps=t_out,
        transform_func=dist_from_05,
        binary=False,
        use_climatology=True,
        device=device,
        model_kwargs=dict(MODEL_KWARGS, convolution_type=cfg["convolution_type"],
                          fused_gates=bool(cfg["preset_mesh"])),
        graph_kwargs=graph_kwargs,
    )


def preset_mesh(cfg, image_shape, mask, device):
    """Experiment 9's or 10's static mesh on ``device``, else None."""
    if not cfg["preset_mesh"]:
        return None
    gmesh = GraphConfig(image_shape=tuple(image_shape), max_grid_size=4, resolution=1 / 12,
                        use_edge_attrs=True)
    mask_t = torch.as_tensor(mask)
    if cfg["preset_mesh"] == "heterogeneous":
        return create_static_heterogeneous_graph(gmesh, mask=mask_t, device=device)
    return create_static_homogeneous_graph(gmesh, mask_t, device=device)


def run(args, device: str, dp_devices: int = 1) -> dict:
    """One experiment on this process's ``device`` (a rank's, under data
    parallelism); returns the written paths, the losses and the
    validation predictions."""
    start = time.time()
    month, exp = args.month, args.exp
    cfg = experiment_config(exp)
    t_in = cfg["input_timesteps"]
    t_out = args.t_out or (90 if not args.synthetic else 10)
    ds, mask, hir, training_years = experiment_data(args)
    image_shape = mask.shape

    data_train = IceDataset(ds, training_years, month, t_in, t_out, X_VARS, Y_VARS, train=True)
    data_test = IceDataset(ds, [training_years[-1] + 1], month, t_in, t_out, X_VARS, Y_VARS)
    data_val = IceDataset(ds, val_years(ds, training_years), month, t_in, t_out, X_VARS, Y_VARS)
    loader_train = DataLoader(data_train, args.batch_size, shuffle=True, seed=21)
    loader_test = DataLoader(data_test, args.batch_size, shuffle=True, seed=22)
    loader_val = DataLoader(data_val, args.batch_size, shuffle=False)
    climatology = climatology_from_dataset(ds, "siconc")

    writer = dp_devices == 1 or torch.distributed.get_rank() == 0
    if writer:
        print(f"Threshold is {NEG_INF}")
    graph_structure = preset_mesh(cfg, image_shape, mask, device)
    name = experiment_name(month, training_years, t_in, t_out)
    model = make_model(cfg, image_shape, name, t_out, device, args.grid_attn, args.shared_mesh,
                       dp_devices)
    if writer:
        print("Num. parameters:", model.get_n_params())

    # Multires curriculum: 2× coarsened epochs first (ref :91-112, :185-206)
    if cfg["multires_training"]:
        coarse = GriddedDataset({k: v[:, ::2, ::2] for k, v in ds.variables.items()}, ds.times)
        mask_half = mask[::2, ::2]
        # the reference trains its coarse phase without climatology but
        # reuses one model, whose decoder head takes the climatology
        # channel; so the half model reads the coarse climatology
        model_half = make_model(cfg, mask_half.shape, name + "_half", t_out, device,
                                dp_devices=dp_devices, graph_kwargs=dict(aggregation="grid"))
        half_train = IceDataset(coarse, training_years, month, t_in, t_out, X_VARS, Y_VARS,
                                train=True)
        half_test = IceDataset(coarse, [training_years[-1] + 1], month, t_in, t_out, X_VARS,
                               Y_VARS)
        model_half.train(
            DataLoader(half_train, args.batch_size, shuffle=True, seed=21),
            DataLoader(half_test, args.batch_size),
            climatology_from_dataset(coarse, "siconc"),
            lr=cfg["lr"], n_epochs=HALF_EPOCHS, mask=mask_half,
            truncated_backprop=cfg["truncated_backprop"], divergence_threshold=args.max_loss,
        )
        # graph convs are resolution-agnostic: warm-start the full model
        model.model.load_state_dict(model_half.model.state_dict())
        epochs = min(args.epochs, 10)
    else:
        epochs = args.epochs

    # full-resolution training uses the high-interest region (ref
    # ice_exp.py:203); like the ref, the coarse phase trains without it
    model.train(
        loader_train, loader_test, climatology, lr=cfg["lr"], n_epochs=epochs, mask=mask,
        high_interest_region=hir, truncated_backprop=cfg["truncated_backprop"],
        graph_structure=graph_structure, divergence_threshold=args.max_loss,
    )

    results_dir = args.results_dir or f"ice_results_exp{exp}"
    if writer:
        os.makedirs(results_dir, exist_ok=True)
    out = dict(loss=model.loss, weights=model.save(results_dir))
    if writer:
        if args.mesh_png and hir is not None:
            png = save_mesh_png(model, data_train.x[0, :1, ..., :1], hir,
                                f"{results_dir}/mesh_hir_{name}.png")
            out["mesh_png"] = png
            if png:
                print("mesh png:", png)
        out["loss_json"] = f"{results_dir}/loss_{name}.json"
        with open(out["loss_json"], "w") as f:
            json.dump(model.loss, f)

    val_preds = model.predict(loader_val, climatology, mask=mask, graph_structure=graph_structure)
    out["val_predictions"] = val_preds
    if writer:
        out["predictions"] = save_predictions(f"{results_dir}/valpredictions_{name}", val_preds,
                                              data_val.y, data_val.launch_dates, t_out)
        print(f"Finished model {month} in {(time.time() - start) / 60} minutes")
        print("predictions:", out["predictions"])
    return out


def _rank_main(rank: int, device, argv):
    """One data-parallel rank of :func:`main`."""
    args = parse_args(argv)
    return run(args, str(device), args.dp_devices)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.dp_devices > 1:
        # NCCL one card a rank, or gloo on the CPU: the device says which
        if args.device == "cuda":
            return dp.launch(_rank_main, args.dp_devices, backend="nccl", args=(argv,))
        return dp.launch(_rank_main, args.dp_devices, backend="gloo", device="cpu",
                         args=(argv,))
    return run(args, args.device)


if __name__ == "__main__":
    main()
