#!/usr/bin/env python3
"""Where the port's time goes on one CUDA card.

    python3 chip_profile.py [--seed 0] [--reps 5] [--train] [--conv GCNConv|TransformerConv]
    python3 chip_profile.py --conv MHTransformerConv|GATConv|GATv2Conv [--train] [--dtype bfloat16]
    python3 chip_profile.py --workload ice --conv MHTransformerConv --dtype bfloat16 --per-gate --remat full --train
    python3 chip_profile.py --dtype bfloat16 [--train] [--conv GCNConv|TransformerConv]
    python3 chip_profile.py --workload ice [--train] [--dtype bfloat16] [--conv GCNConv]
    python3 chip_profile.py --workload ice-xla [--train]
    python3 chip_profile.py --workload ice-xla --dtype bfloat16 --per-gate --remat full --train
    python3 chip_profile.py --workload ice-quadtree --dtype bfloat16 --remat full [--train]
    python3 chip_profile.py --workload ice --dtype bfloat16 --per-gate --remat full --train
    python3 chip_profile.py --preset heterogeneous|homogeneous [--dtype bfloat16] [--train]
    python3 chip_profile.py --remesh-input|--remesh-every 2 [--dtype bfloat16] [--train]
    python3 chip_profile.py --shared-mesh --batch 8|16|32 --dtype bfloat16 --remat full --train
    python3 chip_profile.py [--workload ice-quadtree] --adjacency csum [--train]

Runs the main path of ``chip_smoke.py`` (16 Moving-MNIST 64×64 videos,
4 → 10 frames, remesh every step; ChebConv, or with ``--conv
TransformerConv`` the attention model, with ``--conv GCNConv`` the JAX
package's default conv, with ``--conv MHTransformerConv``, ``GATConv`` or
``GATv2Conv`` those convs), or with ``--workload ice`` its sea-ice flagship
(one 224×304 pixelwise forecast of 10 → 90 days, TransformerConv, or
with ``--conv GCNConv`` the JAX package's experiment 1, with ``--conv
MHTransformerConv`` the attention kernels by head groups, with climatology,
batch 1); ``--dtype bfloat16`` runs any of them in bf16, ``bench.py``'s
default; or with ``--workload ice-xla`` the same model on the pixelwise
edge list (training with truncated BPTT of 30 steps, full BPTT under
``--remat``), or with ``--workload
ice-quadtree`` ``bench.py``'s ice-quadtree model (``chip_smoke.py``
``make_ice_quadtree_model``: remeshing quadtree meshes of the transformed
criterion, attention windows), or with ``--preset heterogeneous`` or
``homogeneous`` the JAX package's sea-ice experiment 9 or 10 (the
flagship's model on that preset mesh of its mask, ``chip_smoke.py``
``make_preset_model``/``make_preset``, remat full unless ``--remat``
says otherwise: full BPTT), under ``torch.profiler`` after
a warm-up: the forecast by default, and with ``--train`` the training step
(``train_step``: fwd + bwd + clipped Adam). Prints one JSON line: wall
time per batch, the device's busy time and idle share over the profiled
window, the device time of the hand-written kernels, and the kernels that
took the most device time. ``--remat`` sets the model's per-step remat
(default ``none``, as the numbers before it were taken, and ``full``
with ``--preset``; ``bench.py`` trains with ``full``) and ``--per-gate`` the per-gate gate layout
(``bench.py``'s default on the pixelwise meshes); ``--remesh-input`` and
``--remesh-every N`` put the main path's model in those remeshing modes
(``chip_smoke.py`` phase 52); ``--batch N`` sets the main path's batch
(default 16), ``--shared-mesh`` trains it on one mesh a step (phase 55;
``bench.py --shared-mesh``) and ``--adjacency csum`` builds the main
path's or the ice-quadtree model's edge lists without a sort (phase 56).
Wall times with the profiler off come first,
so the profiler's overhead shows as the difference. The time of K1, K2,
K2b, K3, K4, K5, K6 and K7 is given apiece: their launchers run inside
``record_function`` ranges named after their launch counters (K2 and K2b
are one kernel, told apart by the range that launched it; K4's and K6's
ranges also hold the fixed-order sums of their partials), which the profiler mirrors on
the device as annotation spans; those spans, and the optimizer's, are
kept out of the kernel sums and the busy time. The per-mesh views a
remesh builds (the CSR views, K4's ``slot_view``) get ranges too, with
their host time beside their device span.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
import time
from unittest import mock

import chip_smoke

# (module, launcher) → range name, the launch counter's
RANGES = {("spmm", "_build_blocks_cuda"): "spmm_build_blocks",
          ("spmm", "_apply_cuda"): "spmm_apply",
          ("spmm", "_apply_bwd_cuda"): "spmm_apply_bwd",
          ("attn", "_attn_fwd_cuda"): "attn_apply",
          ("attn", "_attn_bwd_cuda"): "attn_apply_bwd",
          ("grid_attn", "_grid_attn_fwd_cuda"): "grid_attn_apply",
          ("grid_attn", "_grid_attn_bwd_cuda"): "grid_attn_apply_bwd",
          ("segment_sum", "_segment_sum_cuda"): "segment_sum",
          # the per-mesh views a remesh builds (integer ops, no kernel of ours):
          # the graph build's CSR views (pixel_node's; edge_dst's and
          # edge_src's where the edge list is built) and K4's slot view
          ("build", "segment_view"): "csr_views",
          ("attn", "slot_view"): "slot_view"}
# the port's kernels by the start of their device names (csrc/*.cu)
KERNELS = {"build_blocks_kernel": "::build_blocks_kernel<", "apply_kernel": "::apply_kernel<",
           "attn_fwd_kernel": "::attn_fwd_kernel<", "attn_bwd_kernel": "::attn_bwd_kernel<",
           "attn_bwd_src_kernel": "::attn_bwd_src_kernel<",
           "grid_attn_fwd_kernel": "::grid_attn_fwd_kernel<",
           "grid_attn_bwd_kernel": "::grid_attn_bwd_kernel<",
           "segment_sum_kernel": "::segment_sum_kernel<",
           "segment_spans_kernel": "::segment_spans_kernel<"}


def _in_range(fn, name):
    import torch

    def wrapped(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)

    return wrapped


def _workload(args, run_dir: str):
    """(batch, conv, warm_up, run): the callables that run one warm-up and
    one profiled forecast or train step of the chosen workload."""
    import torch

    if args.preset:
        data, clim, mask = chip_smoke.ice_data(args.seed)
        model = chip_smoke.make_preset_model(args.seed, run_dir, dtype=args.dtype,
                                             remat=args.remat)
        mesh = dict(graph_structure=chip_smoke.make_preset(args.preset, mask),
                    high_interest_region=chip_smoke.synthetic_hir(chip_smoke.ICE_SHAPE))
        windows = [(data.x[i:i + 1], data.y[i:i + 1],
                    model._clim_batch(clim, data.launch_dates[i:i + 1]))
                   for i in range(1 + args.reps)]
        if not args.train:
            x0, _, c0 = windows[0]
            run = lambda: model.forecast(x0, mask=mask, climatology=c0, **mesh)  # noqa: E731
            return 1, "TransformerConv", run, run
        model.initiate_training(lr=chip_smoke.LR, lr_decay=0.95)
        step = lambda b: model.train_step(b[0], b[1], mask=mask,  # noqa: E731
                                          climatology=b[2], **mesh)
        it = iter(windows[1:] * 3)
        return 1, "TransformerConv", lambda: step(windows[0]), lambda: step(next(it))
    if args.workload in ("ice", "ice-xla", "ice-quadtree"):
        edge_list = args.workload == "ice-xla"
        data, clim, mask = chip_smoke.ice_data(args.seed)
        conv = args.conv or "TransformerConv"
        if args.workload == "ice-quadtree":
            model = chip_smoke.make_ice_quadtree_model(args.seed, run_dir, dtype=args.dtype,
                                                       remat=args.remat,
                                                       adjacency=args.adjacency)
        else:
            model = chip_smoke.make_ice_model(args.seed, run_dir,
                                              aggregation="xla" if edge_list else "grid",
                                              dtype=args.dtype, remat=args.remat,
                                              fused_gates=not args.per_gate, conv=conv)
        # the edge list keeps ≈ 100 GB of activations at full BPTT without remat
        tbptt = (chip_smoke.EDGE_TBPTT if edge_list and args.remat == "none"
                 else chip_smoke.ICE_TBPTT)
        windows = [(data.x[i:i + 1], data.y[i:i + 1],
                    model._clim_batch(clim, data.launch_dates[i:i + 1]))
                   for i in range(1 + args.reps)]
        if not args.train:
            x0, _, c0 = windows[0]
            run = lambda: model.forecast(x0, mask=mask, climatology=c0)  # noqa: E731
            return 1, conv, run, run
        model.initiate_training(lr=chip_smoke.LR, lr_decay=0.95)
        step = lambda b: model.train_step(b[0], b[1], mask=mask, climatology=b[2],  # noqa: E731
                                          truncated_backprop=tbptt)
        it = iter(windows[1:] * 3)
        return 1, conv, lambda: step(windows[0]), lambda: step(next(it))
    conv = args.conv or "ChebConv"
    batch = args.batch or chip_smoke.BATCH
    batches = chip_smoke.shared_batches(args.seed, batch, 1 + (args.reps if args.train else 0))
    remesh = dict(remesh_input=args.remesh_input, remesh_every=args.remesh_every)
    if args.adjacency != "sort":
        remesh["graph_extra"] = dict(adjacency=args.adjacency)
    if args.train:
        shared = dict(shared_mesh=True) if args.shared_mesh else {}
        model = chip_smoke.make_trainer(args.seed, run_dir, conv, dtype=args.dtype,
                                        remat=args.remat, **remesh, **shared)
        it = iter(batches[1:] * 3)
        return (batch, conv, lambda: model.train_step(*batches[0]),
                lambda: model.train_step(*next(it)))
    model = chip_smoke.make_model(args.seed, run_dir, conv, dtype=args.dtype,
                                  remat=args.remat, **remesh)
    x = torch.as_tensor(batches[0][0], device="cuda")
    run = lambda: model.forecast(x)  # noqa: E731
    return batch, conv, run, run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--train", action="store_true", help="profile train_step")
    parser.add_argument("--conv", choices=("GCNConv", "ChebConv", "TransformerConv",
                                               "MHTransformerConv", "GATConv", "GATv2Conv"),
                        help="the model's conv (default: ChebConv; TransformerConv on "
                             "--workload ice|ice-xla)")
    parser.add_argument("--workload", default="mnist",
                        choices=("mnist", "ice", "ice-xla", "ice-quadtree"))
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                        help="compute dtype of the model")
    parser.add_argument("--remat", choices=("none", "full", "mesh", "dots"),
                        help="per-step remat of the training rollout (default: full with "
                             "--preset, else none; bench.py: full)")
    parser.add_argument("--per-gate", action="store_true",
                        help="per-gate gate stacks (fused_gates=False), --workload ice|ice-xla")
    parser.add_argument("--preset", choices=("heterogeneous", "homogeneous"),
                        help="the sea-ice experiment 9 or 10 on its preset mesh")
    parser.add_argument("--remesh-input", action="store_true",
                        help="remesh the encoder onto each input frame (the main path)")
    parser.add_argument("--remesh-every", type=int, default=1,
                        help="remesh the decoder every N steps (the main path)")
    parser.add_argument("--batch", type=int, help="the main path's batch (default 16)")
    parser.add_argument("--shared-mesh", action="store_true",
                        help="train the main path on one mesh a step for the batch (--train)")
    parser.add_argument("--adjacency", default="sort", choices=("sort", "csum"),
                        help="edge-list builder of the quadtree meshes (the main path, "
                             "--workload ice-quadtree)")
    args = parser.parse_args()
    if args.remat is None:  # the presets train at full BPTT: remat full
        args.remat = "full" if args.preset else "none"
    if args.preset and (args.workload != "mnist" or args.conv or args.per_gate):
        parser.error("--preset runs the experiments' own model (TransformerConv, fused gates, "
                     "the pixelwise edge list)")
    if (args.remesh_input or args.remesh_every != 1 or args.batch or args.shared_mesh) and (
            args.workload != "mnist" or args.preset):
        parser.error("--remesh-input, --remesh-every, --batch and --shared-mesh apply to the "
                     "main path's model")
    if args.shared_mesh and not args.train:
        parser.error("--shared-mesh is for training (--train); forecasts stay per-sample")
    if args.adjacency == "csum" and (args.workload not in ("mnist", "ice-quadtree")
                                     or args.preset):
        parser.error("--adjacency csum builds the quadtree meshes (the main path, --workload "
                     "ice-quadtree)")
    if args.per_gate and args.workload not in ("ice", "ice-xla"):
        parser.error("--per-gate is bench.py's default on the pixelwise meshes only "
                     "(--workload ice or ice-xla)")
    if args.conv and args.workload == "ice-quadtree":
        parser.error("--workload ice-quadtree has its own convolution (TransformerConv)")

    import torch
    from torch.profiler import ProfilerActivity, profile

    from quadtree_mpnnlstm_tpu_torch.graph import build
    from quadtree_mpnnlstm_tpu_torch.ops import attn, grid_attn, segment_sum, spmm

    modules = {"spmm": spmm, "attn": attn, "grid_attn": grid_attn, "segment_sum": segment_sum,
               "build": build}

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    run_dir = tempfile.TemporaryDirectory()
    batch, conv, warm_up, run = _workload(args, run_dir.name)

    with contextlib.ExitStack() as stack:
        for (mod, attr), name in RANGES.items():
            module = modules[mod]
            stack.enter_context(
                mock.patch.object(module, attr, _in_range(getattr(module, attr), name)))
        warm_up()
        torch.cuda.synchronize()

        def timed():
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        wall = sorted(timed() for _ in range(args.reps))
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                run()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    run_dir.cleanup()

    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # device mirrors of annotation ranges (ours, the optimizer's) are spans, not kernels
    kernels = [e for e in device if e.name not in RANGES.values()
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    port_us = sum(us for name, us in by_name.items()
                  if any(pat in name for pat in KERNELS.values()))
    per_range = {name: 0.0 for name in RANGES.values()}
    host_range = {name: 0.0 for name in RANGES.values()}
    calls = {name: 0 for name in RANGES.values()}
    for e in device:
        if e.name in per_range:
            per_range[e.name] += e.time_range.elapsed_us()
            calls[e.name] += 1
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in host_range:
            host_range[e.name] += e.time_range.elapsed_us()
    print(json.dumps({
        "card": chip_smoke.card_line(),
        "workload": f"preset-{args.preset}" if args.preset else args.workload,
        "path": "train_step" if args.train else "forecast",
        "remesh_input": args.remesh_input, "remesh_every": args.remesh_every,
        "shared_mesh": args.shared_mesh, "adjacency": args.adjacency,
        "conv": conv, "dtype": args.dtype, "batch": batch, "remat": args.remat,
        "fused_gates": not args.per_gate,
        "wall_s_per_batch_median": wall[len(wall) // 2],
        "wall_s_per_batch_all": wall,
        "profiled_s_per_batch": window_s / args.reps,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "device_kernels_per_batch": len(kernels) / args.reps,
        "device_busy_ms_per_batch": busy_us / 1e3 / args.reps,
        "device_idle_share": (1.0 - busy_us / 1e6 / window_s) if busy_us else None,
        "port_kernels_ms_per_batch": port_us / 1e3 / args.reps,
        "port_kernel_ms_by_name": {k: sum(us for n, us in by_name.items() if pat in n) / 1e3
                                   / args.reps for k, pat in KERNELS.items()},
        "kernel_ms_per_batch": {n: us / 1e3 / args.reps for n, us in per_range.items()},
        "range_host_ms_per_batch": {n: us / 1e3 / args.reps for n, us in host_range.items()},
        "kernel_launches_per_batch": {n: c / args.reps for n, c in calls.items()},
        "top_kernels_ms_per_batch": [[n[:90], us / 1e3 / args.reps] for n, us in top],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
