"""Moving-MNIST end-to-end demo.

Counterpart of ``quadtree_mpnnlstm_tpu/cli/mnist_demo.py``, the script
equivalent of the reference's ``moving_mnist_example.ipynb``: build a
synthetic dataset, sweep mesh thresholds, train the quadtree seq2seq,
report the validation MSE, and optionally render predictions (the PNGs
need matplotlib; without it the sweep prints node counts and the render
says it is skipped). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader
from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S

SWEEP_THRESHOLDS = (0.05, 0.1, 0.2, 0.5)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--canvas", type=int, default=32)
    parser.add_argument("--digit", type=int, default=18)
    parser.add_argument("--train-samples", type=int, default=200)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--thresh", type=float, default=0.1)
    parser.add_argument("--t-in", type=int, default=4)   # ref notebook cell 1
    parser.add_argument("--t-out", type=int, default=10)
    parser.add_argument("--sweep-thresholds", action="store_true")
    parser.add_argument("--render", default=None,
                        help="write prediction grids to this png prefix")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    t_in, t_out = args.t_in, args.t_out
    mnist_kwargs = dict(
        input_timesteps=t_in,
        output_timesteps=t_out,
        n_digits=1,
        canvas_size=(args.canvas, args.canvas),
        digit_size=(args.digit, args.digit),
        pixel_noise=0.02,
        velocity_noise=0.0,
    )
    data_train = ModMovingMNISTDataset(args.train_samples, seed=1, **mnist_kwargs)
    data_test = ModMovingMNISTDataset(50, seed=2, **mnist_kwargs)
    data_val = ModMovingMNISTDataset(50, seed=3, **mnist_kwargs)

    model = NextFramePredictorS2S(
        image_shape=(args.canvas, args.canvas),
        thresh=args.thresh,
        experiment_name="mnist_demo",
        decompose=True,
        input_features=1,
        input_timesteps=t_in,
        output_timesteps=t_out,
        device=args.device,
        model_kwargs=dict(hidden_size=16, dropout=0.1, n_layers=2),
        graph_kwargs=dict(max_grid_size=8),
    )
    print("Num. parameters:", model.get_n_params())

    if args.sweep_thresholds:
        # mesh threshold sweep (ref notebook cell 3 / test_threshold)
        for thr in SWEEP_THRESHOLDS:
            out = model.test_threshold(data_train.x[0], thresh=thr, contours=False)
            if isinstance(out, tuple) and hasattr(out[0], "savefig"):
                out[0].savefig(f"mesh_thresh_{thr}.png")
                print(f"thresh {thr}: wrote mesh_thresh_{thr}.png")
            else:
                recon, labels = out
                n = len(np.unique(labels[labels >= 0]))
                print(f"thresh {thr}: {n} nodes")

    st = time.time()
    model.train(
        DataLoader(data_train, args.batch_size, shuffle=True, seed=1),
        DataLoader(data_test, args.batch_size),
        n_epochs=args.epochs,
        lr=0.01,
    )
    print(f"trained in {(time.time() - st) / 60:.2f} min")

    scores = model.score(DataLoader(data_val, args.batch_size))
    print("validation:", scores)

    if args.render:
        y_hat = model.predict(DataLoader(data_val, args.batch_size))
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            for i in range(min(3, len(y_hat))):
                fig, axs = plt.subplots(1, t_in + t_out, figsize=(2 * (t_in + t_out), 2.4))
                for j in range(t_in):
                    axs[j].imshow(data_val.x[i][j, ..., 0])
                    axs[j].set_title(f"in {j}")
                for j in range(t_out):
                    axs[t_in + j].imshow(y_hat[i][j, ..., 0], vmin=0, vmax=1)
                    axs[t_in + j].set_title(f"pred {j}")
                fig.savefig(f"{args.render}_{i}.png")
                plt.close(fig)
            print(f"wrote {args.render}_*.png")
        except ImportError:
            print("matplotlib unavailable; skipping render")
    return scores


if __name__ == "__main__":
    main()
