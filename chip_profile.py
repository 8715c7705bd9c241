#!/usr/bin/env python3
"""Where the port's time goes on one CUDA card.

    python3 chip_profile.py [--seed 0] [--reps 5] [--train] [--conv TransformerConv]

Runs the main path of ``chip_smoke.py`` (16 Moving-MNIST 64×64 videos,
4 → 10 frames, remesh every step; ChebConv, or with ``--conv
TransformerConv`` the attention model) under ``torch.profiler`` after a
warm-up: the forecast by default, and with ``--train`` the training step
(``train_step``: fwd + bwd + clipped Adam). Prints one JSON line: wall
time per batch, the device's busy time and idle share over the profiled
window, the device time of the hand-written kernels, and the kernels that
took the most device time. Wall times with the profiler off come first,
so the profiler's overhead shows as the difference. The time of K1, K2,
K2b, K3 and K4 is given apiece: their launchers run inside
``record_function`` ranges named after their launch counters (K2 and K2b
are one kernel, told apart by the range that launched it; K4's range also
holds the fixed-order sums of its partials), which the profiler mirrors on
the device as annotation spans; those spans, and the optimizer's, are
kept out of the kernel sums and the busy time.
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
          ("attn", "_attn_bwd_cuda"): "attn_apply_bwd"}
# the port's kernels by the start of their device names (csrc/*.cu)
KERNELS = {"build_blocks_kernel": "::build_blocks_kernel(", "apply_kernel": "::apply_kernel(",
           "attn_fwd_kernel": "::attn_fwd_kernel<", "attn_bwd_kernel": "::attn_bwd_kernel<"}


def _in_range(fn, name):
    import torch

    def wrapped(*args):
        with torch.profiler.record_function(name):
            return fn(*args)

    return wrapped


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--train", action="store_true", help="profile train_step")
    parser.add_argument("--conv", default="ChebConv", choices=("ChebConv", "TransformerConv"))
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from quadtree_mpnnlstm_tpu_torch.ops import attn, spmm

    modules = {"spmm": spmm, "attn": attn}

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    run_dir = tempfile.TemporaryDirectory()
    ds, batches = chip_smoke.train_batches(args.seed, 1 + (args.reps if args.train else 0))
    if args.train:
        model = chip_smoke.make_trainer(args.seed, run_dir.name, args.conv)
        it = iter(batches[1:] * 3)

        def run():
            return model.train_step(*next(it))
    else:
        model = chip_smoke.make_model(args.seed, run_dir.name, args.conv)
        x = torch.as_tensor(ds.x, device="cuda")

        def run():
            return model.forecast(x)

    with contextlib.ExitStack() as stack:
        for (mod, attr), name in RANGES.items():
            module = modules[mod]
            stack.enter_context(
                mock.patch.object(module, attr, _in_range(getattr(module, attr), name)))
        if args.train:
            model.train_step(*batches[0])
        else:
            run()
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
    calls = {name: 0 for name in RANGES.values()}
    for e in device:
        if e.name in per_range:
            per_range[e.name] += e.time_range.elapsed_us()
            calls[e.name] += 1
    print(json.dumps({
        "card": chip_smoke.card_line(),
        "path": "train_step" if args.train else "forecast", "conv": args.conv,
        "batch": chip_smoke.BATCH,
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
        "kernel_launches_per_batch": {n: c / args.reps for n, c in calls.items()},
        "top_kernels_ms_per_batch": [[n[:90], us / 1e3 / args.reps] for n, us in top],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
