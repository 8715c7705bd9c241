"""Northwest-Territories experiment (parity: ref ice_exp_nwt.py:27-164):
the ice_exp pipeline pointed at a different dataset, without climatology or
high-interest region.

Counterpart of ``quadtree_mpnnlstm_tpu/cli/ice_exp_nwt.py``: the
synthetic fields of seed 7 (32×32, 2007-2017), the experiment's
truncated BPTT, the edge-list backend's default ``GraphConfig``. Runs on
the card unless ``--device cpu``. ``--max-loss`` is ice_exp's divergence
bound (the JAX CLI keeps the literal 4, the default here).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from quadtree_mpnnlstm_tpu_torch.cli.ice_exp import (
    MODEL_KWARGS,
    NEG_INF,
    X_VARS,
    Y_VARS,
    dist_from_05,
    experiment_config,
    load_real_dataset,
    save_predictions,
)
from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import IceDataset, synthetic_dataset
from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--month", type=int, required=True)
    parser.add_argument("-e", "--exp", type=int, default=0)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--data-glob", default="data/nwt_era5_glorys_nc/*.nc")
    parser.add_argument("--epochs", type=int, default=15)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--results-dir", default=None)
    parser.add_argument("--max-loss", type=float, default=4.0,
                        help="divergence-guard threshold, as ice_exp's (ref literal 4)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    start = time.time()
    cfg = experiment_config(args.exp)
    month = args.month
    training_years = range(2007, 2013)
    t_in = cfg["input_timesteps"]
    output_timesteps = 90 if not args.synthetic else 10

    if args.synthetic:
        ds, mask = synthetic_dataset(seed=7)
    else:
        ds, mask = load_real_dataset(args.data_glob)

    data_train = IceDataset(ds, training_years, month, t_in, output_timesteps, X_VARS, Y_VARS,
                            train=True)
    data_test = IceDataset(ds, [training_years[-1] + 1], month, t_in, output_timesteps, X_VARS,
                           Y_VARS)
    data_val = IceDataset(ds, range(training_years[-1] + 2, training_years[-1] + 2 + 4), month,
                          t_in, output_timesteps, X_VARS, Y_VARS)

    experiment_name = f"nwt_M{month}_I{t_in}O{output_timesteps}"
    model = NextFramePredictorS2S(
        image_shape=mask.shape,
        thresh=NEG_INF,
        experiment_name=experiment_name,
        input_features=len(X_VARS),
        input_timesteps=t_in,
        output_timesteps=output_timesteps,
        transform_func=dist_from_05,
        use_climatology=False,  # no climatology for NWT (ref ice_exp_nwt.py)
        device=args.device,
        model_kwargs=dict(MODEL_KWARGS, convolution_type=cfg["convolution_type"]),
    )
    print("Num. parameters:", model.get_n_params())
    model.train(
        DataLoader(data_train, args.batch_size, shuffle=True, seed=21),
        DataLoader(data_test, args.batch_size),
        lr=cfg["lr"],
        n_epochs=args.epochs,
        mask=mask,
        truncated_backprop=cfg["truncated_backprop"],
        divergence_threshold=args.max_loss,
    )

    results_dir = args.results_dir or f"ice_results_nwt_exp{args.exp}"
    os.makedirs(results_dir, exist_ok=True)
    with open(f"{results_dir}/loss_{experiment_name}.json", "w") as f:
        json.dump(model.loss, f)
    weights = model.save(results_dir)
    preds = model.predict(DataLoader(data_val, args.batch_size), mask=mask)
    out = save_predictions(f"{results_dir}/valpredictions_{experiment_name}", preds, data_val.y,
                           data_val.launch_dates, output_timesteps)
    print(f"Finished NWT model {month} in {(time.time() - start) / 60:.2f} min")
    return dict(loss=model.loss, weights=weights, predictions=out, val_predictions=preds)


if __name__ == "__main__":
    main()
