"""Inference-only script (parity: ref ice_inf.py:27-135): rebuild the model,
load the weights that ``cli/ice_exp.py`` saved, predict the validation
months and dump the predictions.

Counterpart of ``quadtree_mpnnlstm_tpu/cli/ice_inf.py``. The JAX CLI
rebuilds a fixed model (TransformerConv, fused gates, the edge list, the
32×32 synthetic fields, T_in 10) that is not the model its ``ice_exp``
trains on the grid with per-gate stacks; this one rebuilds the model,
data and validation years of ``ice_exp``'s run from the same flags
(``-e``, ``--shape``, ``--synthetic-years``, ``--t-out``, ``--grid-attn``),
so it reproduces that run's validation predictions. With the defaults it
reads what the JAX CLI reads. Writes ``valpredictions_<name>`` to
``--results-dir``, over ``ice_exp``'s file of that name.
"""

from __future__ import annotations

import argparse
import os
import time

from quadtree_mpnnlstm_tpu_torch.cli import ice_exp
from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import IceDataset, climatology_from_dataset
from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--month", type=int, required=True)
    parser.add_argument("--results-dir", required=True)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--data-glob", default="data/hb_era5_glorys_nc/*.nc")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("-e", "--exp", type=int, default=0)
    parser.add_argument("--shape", type=int, nargs=2, default=(32, 32), metavar=("ROWS", "COLS"))
    parser.add_argument("--synthetic-years", type=int, default=11)
    parser.add_argument("--t-out", type=int, default=None)
    parser.add_argument("--grid-attn", default="xla", choices=["xla", "pallas"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    args.no_hir = True  # the region shapes meshes only in training

    start = time.time()
    month = args.month
    cfg = ice_exp.experiment_config(args.exp)
    t_in = cfg["input_timesteps"]
    t_out = args.t_out or (90 if not args.synthetic else 10)
    ds, mask, _, training_years = ice_exp.experiment_data(args)

    data_val = IceDataset(ds, ice_exp.val_years(ds, training_years), month, t_in, t_out,
                          ice_exp.X_VARS, ice_exp.Y_VARS)
    loader_val = DataLoader(data_val, args.batch_size, shuffle=False)
    climatology = climatology_from_dataset(ds, "siconc")

    name = ice_exp.experiment_name(month, training_years, t_in, t_out)
    model = ice_exp.make_model(cfg, mask.shape, name, t_out, args.device, args.grid_attn)
    model.load(args.results_dir)
    graph_structure = ice_exp.preset_mesh(cfg, mask.shape, mask, args.device)

    preds = model.predict(loader_val, climatology, mask=mask, graph_structure=graph_structure)
    out = ice_exp.save_predictions(os.path.join(args.results_dir, f"valpredictions_{name}"),
                                   preds, data_val.y, data_val.launch_dates, t_out)
    print(f"Finished inference {month} in {(time.time() - start) / 60:.2f} min")
    print("predictions:", out)
    return dict(predictions=out, val_predictions=preds)


if __name__ == "__main__":
    main()
