"""Profiling harness (parity: ref ice_profile.py:28-200): shrunken config
(spatial crop, small model) exercised end-to-end with a timing breakdown.

Counterpart of ``quadtree_mpnnlstm_tpu/cli/ice_profile.py``, with
``torch.profiler`` in place of ``jax.profiler``: ``--trace-dir`` writes a
Chrome trace of the training epochs there (``*.pt.trace.json``, with the
card's kernels when it runs on the card), ``--trace-summary`` prints the
top ops by accumulated device time (``eval/trace_summary.py``), and the
``[phase]`` lines time the dataset build, training and prediction. Runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import torch

from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import (
    GriddedDataset,
    IceDataset,
    synthetic_dataset,
)
from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--crop", type=int, default=32)
    parser.add_argument("--coarsen", type=int, default=1)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--trace-dir", default=None,
                        help="write a torch.profiler trace here")
    parser.add_argument("--trace-summary", action="store_true",
                        help="after tracing, print the top ops by accumulated device time "
                        "(eval/trace_summary.py)")
    parser.add_argument("--thresh", type=float, default=0.15)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    ds, mask = synthetic_dataset(shape=(args.crop, args.crop))
    if args.coarsen > 1:
        ds = GriddedDataset(
            {k: v[:, ::args.coarsen, ::args.coarsen] for k, v in ds.variables.items()},
            ds.times,
        )
        mask = mask[::args.coarsen, ::args.coarsen]

    x_vars = ["siconc", "t2m"]
    t0 = time.perf_counter()
    data = IceDataset(ds, [2007], 6, 5, 5, x_vars, ["siconc"], train=True)
    loader = DataLoader(data, args.batch_size, drop_last=True)
    print(f"[phase] dataset build: {time.perf_counter() - t0:.2f}s ({len(data)} samples)")

    model = NextFramePredictorS2S(
        image_shape=mask.shape,
        thresh=args.thresh,
        experiment_name="profile",
        input_features=len(x_vars),
        input_timesteps=5,
        output_timesteps=5,
        device=args.device,
        model_kwargs=dict(hidden_size=16, dropout=0.1, n_layers=1, n_conv_layers=1,
                          convolution_type="GCNConv"),
        graph_kwargs=dict(max_grid_size=8),
    )
    t0 = time.perf_counter()
    print("params:", model.get_n_params(), f"(init {time.perf_counter() - t0:.2f}s)")

    profiler = None
    if args.trace_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if model.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(args.trace_dir))
        profiler.start()
    t0 = time.perf_counter()
    model.train(loader, loader, n_epochs=args.epochs, lr=0.01, mask=mask)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    train_t = time.perf_counter() - t0
    if profiler is not None:
        profiler.stop()
        print(f"[trace] written to {args.trace_dir}")
        if args.trace_summary:
            from quadtree_mpnnlstm_tpu_torch.eval.trace_summary import print_trace_summary

            print_trace_summary(args.trace_dir)
    n = len(loader) * args.epochs
    print(f"[phase] train: {train_t:.2f}s total, {train_t / max(n, 1):.3f}s/step "
          f"(first step includes the kernels' first launches)")

    t0 = time.perf_counter()
    model.predict(loader, mask=mask)
    print(f"[phase] predict: {time.perf_counter() - t0:.2f}s")
    return model


if __name__ == "__main__":
    main()
