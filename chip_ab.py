#!/usr/bin/env python3
"""Time the paths of one checkout of the port on one CUDA card: by default
the remeshing quadtree paths, a forecast batch (``predict``) and a train
step (``train_step``) of ``bench.py``'s 64×64 Moving-MNIST model
(``chip_smoke.py`` phases 2, 5, 9 and 11: batch 16, T_in 4 → T_out 10,
thresh 0.1, random weights from ``--seed``), with ChebConv and with
TransformerConv (``--conv``: only one of them, or GCNConv, phase 43, or
MHTransformerConv, GATConv or GATv2Conv, phases 46-47);
with ``--workload ice`` the sea-ice flagship on the pixelwise grid
(phases 13 and 16: one 224×304 forecast of 10 → 90 days through
``predict``, and one full-BPTT train step, batch 1, with climatology;
``--conv GCNConv`` is the JAX package's experiment 1, phase 44), with
``--workload ice-xla`` the same flagship on the pixelwise edge list
(phases 20, 41 and 45); with ``--workload ice-quadtree``
``bench.py``'s ice-quadtree model (phase 42: remeshing quadtree meshes
of the transformed criterion on attention windows, a forecast and a
full-BPTT step). Each in f32 or, with ``--dtype bfloat16``, in bf16
(``bench.py``'s default dtype; phases 26, 28, 31, 33, 35 and 37).
``--remat`` sets the per-step remat of the train steps (default
``none``, as the numbers before it were taken, and ``full`` with
``--preset``; ``bench.py`` trains with ``full``) and ``--per-gate`` the per-gate gate stacks of the flagship
(``bench.py``'s default on the pixelwise meshes), so that
``--workload ice|ice-xla --dtype bfloat16 --remat full --per-gate``
times ``bench.py --workload ice|ice-xla`` as it configures it. With ``--workload k7`` the segment-sum kernel K7 alone: on
the operand sets of a forecast and a train step of the ChebConv and the
TransformerConv model, each in f32 and bf16 (as ``chip_smoke.py`` phases
10, 27 and 32 capture them), and on the pixel views of coarse to fine
quadtree meshes built from the Moving-MNIST frames (phase 27b,
``k7_mesh_sets``: F 1, 3, 16 in f32 and bf16); each set bit-identical to
the entry-ordered sum, timed by CUDA graph and by events beside its bound
and ``index_add_`` (``k7_measure``). With ``--preset heterogeneous`` or
``homogeneous`` the JAX package's sea-ice experiment 9 or 10 (phases
50-51: the flagship's model on that preset mesh, a forecast and a
full-BPTT step under remat full unless ``--remat`` says otherwise), and
with ``--remesh-input`` or ``--remesh-every N`` the quadtree paths in
those remeshing modes (phase 52). ``--batch N`` sets the quadtree paths'
batch (default 16), ``--shared-mesh`` trains it on one mesh a step
(``bench.py --shared-mesh``; phase 55: ``--dtype bfloat16 --remat full
--shared-mesh --batch 8`` or ``32`` are ``bench.py --full``'s
``pallas_bf16_shared_b8``/``_b32`` rows), and ``--adjacency csum``
builds the quadtree paths' and the ice-quadtree model's edge lists
without a sort (``bench.py --adjacency csum``; phase 56).

    python3 chip_ab.py [--workload quadtree|ice|ice-xla|ice-quadtree|k7]
                       [--conv GCNConv|ChebConv|TransformerConv|MHTransformerConv|GATConv|GATv2Conv]
                       [--dtype float32|bfloat16]
                       [--remat none|full|mesh|dots] [--per-gate]
                       [--preset heterogeneous|homogeneous]
                       [--remesh-input] [--remesh-every N]
                       [--batch N] [--shared-mesh] [--adjacency sort|csum]
                       [--tree DIR] [--reps 5] [--seed 0]

``--tree`` imports the port's package from another checkout, for example a
parent commit unpacked into a git-ignored directory, so that one script
times two versions in turns on one card (parent, change, change, parent);
this checkout's model factories pass ``remat`` (and ``remesh_every``),
so the other tree's predictor must take them; ``--preset``, the
remeshing modes, ``--shared-mesh`` and ``--adjacency csum`` need a tree
that has them.
Each forecast and each step is timed alone on the host clock, after a
warm-up, and ends in ``torch.cuda.synchronize()``. Prints one JSON line
with every sample, its median and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _timed(fn, reps: int) -> list:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="quadtree",
                        choices=("quadtree", "ice", "ice-xla", "ice-quadtree", "k7"))
    parser.add_argument("--conv", choices=("GCNConv", "ChebConv", "TransformerConv",
                                               "MHTransformerConv", "GATConv", "GATv2Conv"),
                        help="time only this model of the quadtree paths (default: ChebConv "
                             "and TransformerConv), or the flagship's conv (--workload "
                             "ice|ice-xla; default TransformerConv)")
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                        help="compute dtype of the models")
    parser.add_argument("--remat", choices=("none", "full", "mesh", "dots"),
                        help="per-step remat of the train steps (default: full with "
                             "--preset, else none; bench.py: full)")
    parser.add_argument("--per-gate", action="store_true",
                        help="per-gate gate stacks of the flagship (--workload ice|ice-xla)")
    parser.add_argument("--preset", choices=("heterogeneous", "homogeneous"),
                        help="the sea-ice experiment 9 or 10 on its preset mesh")
    parser.add_argument("--remesh-input", action="store_true",
                        help="remesh the encoder onto each input frame (--workload quadtree)")
    parser.add_argument("--remesh-every", type=int, default=1,
                        help="remesh the decoder every N steps (--workload quadtree)")
    parser.add_argument("--batch", type=int,
                        help="batch of the quadtree paths (--workload quadtree; default 16)")
    parser.add_argument("--shared-mesh", action="store_true",
                        help="train the quadtree paths on one mesh a step for the batch")
    parser.add_argument("--adjacency", default="sort", choices=("sort", "csum"),
                        help="edge-list builder of the quadtree meshes (--workload "
                             "quadtree|ice-quadtree)")
    parser.add_argument("--tree", default=HERE)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if args.remat is None:  # the presets train at full BPTT: remat full
        args.remat = "full" if args.preset else "none"
    if args.per_gate and args.workload not in ("ice", "ice-xla"):
        parser.error("--per-gate is bench.py's default on the pixelwise meshes "
                     "(--workload ice|ice-xla)")
    if args.conv and args.workload in ("ice-quadtree", "k7"):
        parser.error(f"--workload {args.workload} has its own convolutions")
    if args.preset and (args.workload != "quadtree" or args.conv or args.per_gate):
        parser.error("--preset runs the experiments' own model (TransformerConv, fused gates, "
                     "the pixelwise edge list)")
    if (args.remesh_input or args.remesh_every != 1 or args.batch or args.shared_mesh) and (
            args.workload != "quadtree" or args.preset):
        parser.error("--remesh-input, --remesh-every, --batch and --shared-mesh apply to "
                     "--workload quadtree")
    if args.adjacency == "csum" and (args.workload not in ("quadtree", "ice-quadtree")
                                     or args.preset):
        parser.error("--adjacency csum builds the quadtree meshes (--workload "
                     "quadtree|ice-quadtree)")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA card", file=sys.stderr)
        return 2
    # this checkout's model definitions, the other tree's package
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import quadtree_mpnnlstm_tpu_torch  # noqa: F401  (from the tree on sys.path)

    package = sys.modules["quadtree_mpnnlstm_tpu_torch"].__file__
    if not package.startswith(tree):
        raise RuntimeError(f"imported the port from {package}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    run_dir = tempfile.TemporaryDirectory()
    result = {"tree": tree, "card": cs.card_line(),
              "workload": f"preset-{args.preset}" if args.preset else args.workload,
              "conv": args.conv, "dtype": args.dtype, "remat": args.remat,
              "fused_gates": not args.per_gate, "remesh_input": args.remesh_input,
              "remesh_every": args.remesh_every, "batch": args.batch,
              "shared_mesh": args.shared_mesh, "adjacency": args.adjacency, "reps": args.reps}
    if args.preset:
        _time_preset(cs, args, run_dir.name, result)
    elif args.workload in ("ice", "ice-xla", "ice-quadtree"):
        _time_ice(cs, args, run_dir.name, result)
    elif args.workload == "k7":
        _time_k7(cs, args, run_dir.name, result)
    else:
        _time_quadtree(cs, args, run_dir.name, result)
    print(json.dumps(result), flush=True)
    run_dir.cleanup()
    return 0


def _record(result: dict, name: str, samples: list) -> None:
    result[name] = samples
    result[f"{name}_median"] = statistics.median(samples)


def _time_quadtree(cs, args, run_dir: str, result: dict) -> None:
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    batch = args.batch or cs.BATCH
    ds = ModMovingMNISTDataset(
        batch, input_timesteps=cs.T_IN, output_timesteps=cs.T_OUT, canvas_size=cs.CANVAS,
        digit_size=cs.DIGIT, pixel_noise=0.02, velocity_noise=0.0, seed=args.seed,
    )
    loader = DataLoader(ds, batch_size=batch)
    if batch == cs.BATCH:
        _, batches = cs.train_batches(args.seed, 1)
    else:
        batches = cs.shared_batches(args.seed, batch, 1)
    x, y = batches[0]
    remesh = {}
    if args.remesh_input:
        remesh["remesh_input"] = True
    if args.remesh_every != 1:
        remesh["remesh_every"] = args.remesh_every
    if args.adjacency != "sort":
        remesh["graph_extra"] = dict(adjacency=args.adjacency)
    shared = dict(shared_mesh=True) if args.shared_mesh else {}
    for conv in (args.conv,) if args.conv else ("ChebConv", "TransformerConv"):
        model = cs.make_model(args.seed, run_dir, conv, dtype=args.dtype, **remesh)
        _record(result, f"{conv}_forecast_s", _timed(lambda: model.predict(loader), args.reps))
        trainer = cs.make_trainer(args.seed, run_dir, conv, dtype=args.dtype, remat=args.remat,
                                  **remesh, **shared)
        _record(result, f"{conv}_step_s",
                _timed(lambda: float(trainer.train_step(x, y)[0]), args.reps))
        del model, trainer
        torch.cuda.empty_cache()


def _time_k7(cs, args, run_dir: str, result: dict) -> None:
    """K7 per operand set: each path's sets (``k7_by_path``, keyed by conv
    and dtype) and the mesh densities' (``k7_mesh_sets``)."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
    from quadtree_mpnnlstm_tpu_torch.ops import segment, segment_sum

    ds = ModMovingMNISTDataset(
        cs.BATCH, input_timesteps=cs.T_IN, output_timesteps=cs.T_OUT, canvas_size=cs.CANVAS,
        digit_size=cs.DIGIT, pixel_noise=0.02, velocity_noise=0.0, seed=args.seed)
    x = torch.as_tensor(ds.x, device=cs.DEVICE)
    _, batches = cs.train_batches(args.seed, 1)
    p = cs.CANVAS[0] * cs.CANVAS[1]
    result["k7_by_path"] = {}
    for conv in ("ChebConv", "TransformerConv"):
        for dtype in ("float32", "bfloat16"):
            model = cs.make_model(args.seed, run_dir, conv, dtype=dtype)
            trainer = cs.make_trainer(args.seed, run_dir, conv, dtype=dtype)
            with cs.SegmentCapture(segment, p, keep=True, counts=True) as seg_f:
                model.forecast(x)
            with cs.SegmentCapture(segment, p, keep=True, counts=True) as seg_t:
                trainer.train_step(*batches[0])
            sets = {**seg_t.ops, **seg_f.ops}
            result["k7_by_path"][f"{conv}_{dtype}"] = [
                cs.k7_measure(segment_sum, key, sets[key], seg_t.calls.get(key, 0),
                              cs.BF16_TOL if sets[key][0].dtype == torch.bfloat16
                              else cs.K7_TOL)
                for key in sorted(sets)]
            del model, trainer, seg_f, seg_t, sets
            torch.cuda.empty_cache()
    result["k7_mesh_sets"] = cs.k7_mesh_sets(segment_sum, x, args.seed)


def _time_ice(cs, args, run_dir: str, result: dict) -> None:
    """The flagship's forecast (one window through ``predict``) and its
    full-BPTT train step on the first window, as phases 13 and 16 run them
    on the grid (``--workload ice``) and phases 41 and 45 on the edge list
    (``ice-xla``), or the ice-quadtree model's, as phase 42 does."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader

    def make():
        if args.workload == "ice-quadtree":
            csum = dict(adjacency="csum") if args.adjacency == "csum" else {}
            return cs.make_ice_quadtree_model(args.seed, run_dir, dtype=args.dtype,
                                              remat=args.remat, **csum)
        return cs.make_ice_model(args.seed, run_dir, dtype=args.dtype, remat=args.remat,
                                 fused_gates=not args.per_gate,
                                 aggregation="xla" if args.workload == "ice-xla" else "grid",
                                 conv=args.conv or "TransformerConv")

    data, clim, mask = cs.ice_data(args.seed)
    window = DataLoader(ArrayDataset(data.x[:1], data.y[:1], data.launch_dates[:1]))
    model = make()
    _record(result, "ice_forecast_s",
            _timed(lambda: model.predict(window, climatology=clim, mask=mask), args.reps))
    del model
    torch.cuda.empty_cache()
    trainer = make()
    trainer.initiate_training(lr=cs.LR, lr_decay=0.95)
    # the edge list keeps ≈ 100 GB of activations at full BPTT without remat
    tbptt = cs.EDGE_TBPTT if args.workload == "ice-xla" and args.remat == "none" else cs.ICE_TBPTT
    result["truncated_backprop"] = tbptt
    x, y, c = data.x[:1], data.y[:1], trainer._clim_batch(clim, data.launch_dates[:1])
    _record(result, "ice_step_s",
            _timed(lambda: float(trainer.train_step(x, y, mask=mask, climatology=c,
                                                    truncated_backprop=tbptt)[0]),
                   args.reps))
    del trainer
    torch.cuda.empty_cache()



def _time_preset(cs, args, run_dir: str, result: dict) -> None:
    """Experiment 9 or 10 (``--preset``): a forecast of one window through
    ``predict`` and a full-BPTT train step on the first window, on the
    preset mesh built once, as phases 50 and 51 run them."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.cli.ice_exp import synthetic_hir
    from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader

    data, clim, mask = cs.ice_data(args.seed)
    mesh = dict(graph_structure=cs.make_preset(args.preset, mask),
                high_interest_region=synthetic_hir(cs.ICE_SHAPE))
    window = DataLoader(ArrayDataset(data.x[:1], data.y[:1], data.launch_dates[:1]))
    model = cs.make_preset_model(args.seed, run_dir, dtype=args.dtype, remat=args.remat)
    _record(result, "ice_forecast_s",
            _timed(lambda: model.predict(window, climatology=clim, mask=mask, **mesh),
                   args.reps))
    model.initiate_training(lr=cs.LR, lr_decay=0.95)
    x, y, c = data.x[:1], data.y[:1], model._clim_batch(clim, data.launch_dates[:1])
    _record(result, "ice_step_s",
            _timed(lambda: float(model.train_step(x, y, mask=mask, climatology=c, **mesh)[0]),
                   args.reps))
    del model
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
