"""CNN-LSTM baseline experiments (parity: ref ice_exp_cnnlstm.py:23-159):
numbered sweeps over kernel size / hidden / layers / dropout / lr /
input timesteps, trained on the same ice pipeline.

Counterpart of ``quadtree_mpnnlstm_tpu/cli/ice_exp_cnnlstm.py``. At this
configuration (the five ``x_vars`` and ``use_climatology=True``) the JAX
CLI fails in training with flax's ``ScopeParamShapeError``
(``train/cnn_predictor.py:86-93``, ``models/cnnlstm.py:197-207``); the
port's trainer raises the ``ValueError`` that names the combination when
the model is built (``train/cnn_predictor.py``), and so does this CLI. It
runs no other configuration than the JAX CLI's.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from quadtree_mpnnlstm_tpu_torch.cli.ice_exp import (
    X_VARS,
    Y_VARS,
    load_real_dataset,
    save_predictions,
)
from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import (
    IceDataset,
    climatology_from_dataset,
    synthetic_dataset,
)
from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader
from quadtree_mpnnlstm_tpu_torch.train.cnn_predictor import NextFramePredictorCNNLSTM


def experiment_config(exp: int):
    """Numbered sweeps (ref ice_exp_cnnlstm.py:58-76)."""
    cfg = dict(kernel_size=3, hidden_size=32, n_layers=2, dropout=0.1,
               lr=0.001, input_timesteps=10)
    if exp == 1:
        cfg["kernel_size"] = 5
    elif exp == 2:
        cfg["hidden_size"] = 64
    elif exp == 3:
        cfg["n_layers"] = 3
    elif exp == 4:
        cfg["dropout"] = 0.2
    elif exp == 5:
        cfg["lr"] = 0.01
    elif exp == 6:
        cfg["lr"] = 0.0001
    elif exp == 7:
        cfg["input_timesteps"] = 30
    elif exp == 8:
        cfg["input_timesteps"] = 90
    return cfg


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--month", type=int, required=True)
    parser.add_argument("-e", "--exp", type=int, default=0)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--data-glob", default="data/hb_era5_glorys_nc/*.nc")
    parser.add_argument("--epochs", type=int, default=15)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--results-dir", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    start = time.time()
    cfg = experiment_config(args.exp)
    month = args.month
    training_years = range(2007, 2013)
    output_timesteps = 90 if not args.synthetic else 10

    if args.synthetic:
        ds, mask = synthetic_dataset()
    else:
        ds, mask = load_real_dataset(args.data_glob)

    t_in = cfg["input_timesteps"]
    data_train = IceDataset(ds, training_years, month, t_in, output_timesteps, X_VARS, Y_VARS,
                            train=True)
    data_test = IceDataset(ds, [training_years[-1] + 1], month, t_in, output_timesteps, X_VARS,
                           Y_VARS)
    data_val = IceDataset(ds, range(training_years[-1] + 2, training_years[-1] + 2 + 4), month,
                          t_in, output_timesteps, X_VARS, Y_VARS)
    climatology = climatology_from_dataset(ds, "siconc")

    experiment_name = f"cnn_M{month}_E{args.exp}_I{t_in}O{output_timesteps}"
    model = NextFramePredictorCNNLSTM(
        image_shape=mask.shape,
        experiment_name=experiment_name,
        input_features=len(X_VARS),
        hidden_size=cfg["hidden_size"],
        input_timesteps=t_in,
        output_timesteps=output_timesteps,
        n_layers=cfg["n_layers"],
        dropout=cfg["dropout"],
        kernel_size=cfg["kernel_size"],
        use_climatology=True,
        device=args.device,
    )
    print("Num. parameters:", model.get_n_params())
    model.train(
        DataLoader(data_train, args.batch_size, shuffle=True, seed=21),
        DataLoader(data_test, args.batch_size),
        climatology,
        lr=cfg["lr"],
        n_epochs=args.epochs,
        mask=mask,
    )

    results_dir = args.results_dir or f"ice_results_cnn_exp{args.exp}"
    os.makedirs(results_dir, exist_ok=True)
    with open(f"{results_dir}/loss_{experiment_name}.json", "w") as f:
        json.dump(model.loss, f)
    model.save(results_dir)
    preds = model.predict(DataLoader(data_val, args.batch_size), climatology, mask=mask)
    save_predictions(f"{results_dir}/valpredictions_{experiment_name}", preds, data_val.y,
                     data_val.launch_dates, output_timesteps)
    print(f"Finished CNN model {month} in {(time.time() - start) / 60:.2f} min")


if __name__ == "__main__":
    main()
