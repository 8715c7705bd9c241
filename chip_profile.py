#!/usr/bin/env python3
"""Where the port's forecast time goes on one CUDA card.

    python3 chip_profile.py [--seed 0] [--reps 5]

Runs the main path of ``chip_smoke.py`` (16 Moving-MNIST 64×64 videos,
4 → 10 frames, remesh every step) under ``torch.profiler`` after a
warm-up, and prints one JSON line: wall time per batch, the device's busy
time and idle share over the profiled window, the summed device time of
the two Â-block kernels, and the kernels that took the most device time.
Wall times with the profiler off come first, so the profiler's overhead
shows as the difference.
"""

from __future__ import annotations

import argparse
import json
import time

import chip_smoke


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = ModMovingMNISTDataset(
        chip_smoke.BATCH, input_timesteps=chip_smoke.T_IN, output_timesteps=chip_smoke.T_OUT,
        canvas_size=chip_smoke.CANVAS, digit_size=(18, 18), pixel_noise=0.02,
        velocity_noise=0.0, seed=args.seed,
    )
    model = chip_smoke.make_model(args.seed)
    x = torch.as_tensor(ds.x, device="cuda")
    model.forecast(x)
    torch.cuda.synchronize()

    def timed():
        t0 = time.perf_counter()
        model.forecast(x)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = sorted(timed() for _ in range(args.reps))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            model.forecast(x)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    spmm_us = sum(us for name, us in by_name.items() if "apply_kernel" in name
                  or "build_blocks_kernel" in name)
    print(json.dumps({
        "card": chip_smoke.card_line(),
        "batch": chip_smoke.BATCH,
        "wall_s_per_batch_median": wall[len(wall) // 2],
        "wall_s_per_batch_all": wall,
        "profiled_s_per_batch": window_s / args.reps,
        "device_kernels_per_batch": len(kernels) / args.reps,
        "device_busy_ms_per_batch": busy_us / 1e3 / args.reps,
        "device_idle_share": (1.0 - busy_us / 1e6 / window_s) if busy_us else None,
        "spmm_kernels_ms_per_batch": spmm_us / 1e3 / args.reps,
        "top_kernels_ms_per_batch": [[n[:90], us / 1e3 / args.reps] for n, us in top],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
