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
and ``index_add_`` (``k7_measure``). With ``--workload k2`` the block
product K2 and its backward K2b alone (``k2_sets``): on the operands of a
forecast (K2 at each width of the first decoder step) and a train step
(K2b at each width) of the ChebConv and the GCNConv model in f32 and bf16
(phases 3, 7, 27 and 43), and of a shared-mesh train step in f32 at batch
16 and bf16 at batch 32 (phase 55); each set timed by CUDA graph and by
events beside its bound, ``torch.sparse.mm`` (by graph), in bf16 the f32
kernel on the same operands, and, where the tree has it, the row-a-warp
yardstick kernel, which it must equal bit for bit; each set's inputs and
output digested (sha256), so that ``--against FILE`` (an earlier run's
output) holds this run's outputs to that run's bit for bit, set by set
(exit 1 if any differ). ``k2_means`` averages each path's sets, weighted
by their calls; ``--summarize RUN.json ...`` prints them for earlier runs
side by side, without a card. With ``--workload k4`` the attention
backward K4 alone (``k4_sets``): on the operands of a TransformerConv train
step in f32 and bf16 (phases 10 and 32: HD 128, 16, 1), of the
ice-quadtree model's full-BPTT bf16 step (phase 42: HD 256, and 32 and
1), of a MHTransformerConv step in f32 and bf16 (phase 46: HD 384, 48, 3)
and of a shared-mesh TransformerConv step (phase 55, f32, batch 16), each
captured as that phase captures it; each set
against its plain version, repeated bit for bit, timed by CUDA graph and
by events beside its bound, in bf16 the f32 kernel on the same operands,
and split between K4's two kernels and the rest of the call by one
``torch.profiler`` pass (``k4_measure``); ``k4_means`` averages each
path's sets by their calls, and ``--summarize`` prints them too. With
``--workload k3`` the window-attention forward K3 alone (``k3_sets``): on
the first call at each width of a forecast (no keep) and of a train step
(keep where it drops out) of the TransformerConv and MHTransformerConv
models in f32 and bf16 (HD 128, 16, 1; 384, 48, 3) and of the
ice-quadtree model in bf16 and f32 (HD 256, a T_out-90 forecast and a
T_out-6 step), and at HD 768 on one ice-quadtree mesh with and without
keep rows; each set at the call's whole width (a tree's head groups where
it has them) against ``attn_plain``, repeated bit for bit, timed by CUDA
graph and by events beside its bound, the plain version and, in bf16, the
f32 kernel on the same operands, with the slots per distinct source of its
32-row groups (``k3_measure``); then K4 at HD 768 a call in both dtypes
(``k4_hd768``); ``k3_means`` averages each path's sets by their calls. With ``--workload
k6`` the grid-attention backward K6 alone (``k6_sets``): on the operands of
the sea-ice flagship's train steps as ``chip_smoke.py`` captures them (T_out
6, with the dropout keep planes): the fused gate stacks in f32 (phase 14:
H 256, 32 and 1) and bf16 (phase 36), the per-gate stacks in bf16 under
remat full (``bench.py``'s default, phase 39) and
MHTransformerConv in bf16 (phase 49: H 768, 96 and 3); each set against
``grid_attn_bwd_plain``, repeated bit for bit, timed by CUDA graph and by
events beside its bound, in bf16 the f32 kernel on the same operands, with
the calls of a full (T_out 90) step as its weight (a forecast's K5 calls
at that width) and a tree's head-group dispatch where it has one
(``k6_measure``); ``k6_means`` averages each path's sets by their calls. With
``--workload k5`` the grid-attention forward K5 alone (``k5_sets``): on the
same four paths' operands, the first call at each width of a T_out-90
forecast (no keep planes) and of a T_out-6 train step (with them); each set
bit-identical to ``grid_attn_plain`` and on a repeat, timed by CUDA graph
and by events beside its bound and the plain version, in bf16 the f32
kernel on the same operands, with the forecast's calls at that width as its
weight (``k5_measure``); ``k5_means`` averages each path's forecast and
train sets by their calls. With ``--preset heterogeneous`` or
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

    python3 chip_ab.py [--workload quadtree|ice|ice-xla|ice-quadtree|k7|k2|k3|k4|k5|k6]
                       [--conv GCNConv|ChebConv|TransformerConv|MHTransformerConv|GATConv|GATv2Conv]
                       [--dtype float32|bfloat16]
                       [--remat none|full|mesh|dots] [--per-gate]
                       [--preset heterogeneous|homogeneous]
                       [--remesh-input] [--remesh-every N]
                       [--batch N] [--shared-mesh] [--adjacency sort|csum]
                       [--tree DIR] [--against FILE] [--reps 5] [--seed 0]
    python3 chip_ab.py --summarize RUN.json [RUN.json ...]

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
from unittest import mock

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
                        choices=("quadtree", "ice", "ice-xla", "ice-quadtree", "k7", "k2",
                                 "k3", "k4", "k5", "k6"))
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
    parser.add_argument("--summarize", nargs="+", metavar="RUN",
                        help="print the k2_means, k3_means, k4_means, k5_means or k6_means "
                             "of earlier --workload k2, k3, k4, k5 or k6 runs and exit")
    parser.add_argument("--against",
                        help="an earlier --workload k2 run's output: hold this run's K2 and K2b "
                             "outputs to it bit for bit")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if args.summarize:
        print(json.dumps({run: _means(_last_run(run)) for run in args.summarize}))
        return 0
    if args.remat is None:  # the presets train at full BPTT: remat full
        args.remat = "full" if args.preset else "none"
    if args.per_gate and args.workload not in ("ice", "ice-xla"):
        parser.error("--per-gate is bench.py's default on the pixelwise meshes "
                     "(--workload ice|ice-xla)")
    if args.against and args.workload != "k2":
        parser.error("--against compares --workload k2 runs")
    if args.conv and args.workload in ("ice-quadtree", "k7", "k2", "k3", "k4", "k5", "k6"):
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
    elif args.workload == "k2":
        _time_k2(cs, args, run_dir.name, result)
    elif args.workload == "k3":
        _time_k3(cs, args, run_dir.name, result)
    elif args.workload == "k4":
        _time_k4(cs, args, run_dir.name, result)
    elif args.workload == "k5":
        _time_k5(cs, args, run_dir.name, result)
    elif args.workload == "k6":
        _time_k6(cs, args, run_dir.name, result)
    else:
        _time_quadtree(cs, args, run_dir.name, result)
    print(json.dumps(result), flush=True)
    run_dir.cleanup()
    return 1 if result.get("against", {}).get("bit_identical") is False else 0


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


def _digest(*xs) -> str:
    """sha256 of the tensors' bytes (the first 32 hex digits)."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for x in xs:
        h.update(x.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:32]


def k2_measure(cs, spmm, name: str, kernel: str, calls: int, args) -> dict:
    """One K2 (``kernel`` "spmm_apply") or K2b ("spmm_apply_bwd") operand
    set: the kernel against ``apply_plain`` (f32 within ``K2_TOL``, bf16
    within one rounding), repeated bit for bit and, where the tree has the
    row-a-warp yardstick, equal to it bit for bit; graph and event times
    beside the bound (``k2_shared_bound_ms`` on a shared mesh),
    ``torch.sparse.mm`` of Â by z (on a shared mesh by the batch folded
    into the features), in bf16 the f32 kernel on the same operands; the
    digests of the inputs and the output."""
    import torch

    z, s0, blocks, live, n_max, nt, sw = args
    b, f = z.shape[0], z.shape[-1]
    launch = spmm._apply_cuda if kernel == "spmm_apply" else spmm._apply_bwd_cuda
    with torch.no_grad():
        out, plain = launch(*args), spmm.apply_plain(*args)
        again = launch(*args)
    err = float((out.float() - plain.float()).abs().max())
    scale = max(1.0, float(plain.float().abs().max()))
    bf16 = z.dtype == torch.bfloat16
    cs.check(err <= (cs.BF16_TOL * scale if bf16 else cs.K2_TOL),
             f"{name}: {kernel} differs from its plain version by {err}")
    shared = s0.shape[0] == 1 and b > 1
    bound_fn = cs.k2_shared_bound_ms if shared else cs.k2_bound_ms
    bound, b_ms, o_ms = bound_fn(s0, blocks, live, n_max, nt, sw, f, b)
    folded = z.permute(1, 0, 2).reshape(1, n_max, b * f).contiguous() if shared else z
    library, refused = cs._library_spmm(s0, blocks, n_max, nt, sw, folded)
    row = dict(set=name, kernel=kernel, dtype=str(z.dtype).replace("torch.", ""), batch=b, F=f,
               shared_mesh=shared, calls=calls, live_tiles=int(live.long().sum()),
               max_abs_err=err, err_rel_to_max=err / scale,
               repeat_bit_identical=bool(torch.equal(out, again)),
               ms=cs.graph_ms(lambda: launch(*args)), events_ms=cs.cuda_ms(lambda: launch(*args)),
               bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms,
               bound_by="bytes" if b_ms >= o_ms else "operations", library_refused=refused,
               input_sha=_digest(z, s0, blocks, live), output_sha=_digest(out))
    if library is not None:
        row.update(cs.library_times(library))
    if bf16:
        f32_args = (z.float(), s0, blocks.float()) + tuple(args[3:])
        row["f32_ms"] = cs.graph_ms(lambda: launch(*f32_args))
    if hasattr(spmm, "_apply_rowwarp_cuda"):
        row.update(cs.rowwarp_times(spmm, args, out, f"{name} {kernel}"))
    cs.check(row["repeat_bit_identical"], f"{name}: two launches of {kernel} differ")
    return row


def _last_run(path: str) -> dict:
    """The last JSON line with ``k2_sets``, ``k3_sets``, ``k4_sets``,
    ``k5_sets`` or ``k6_sets`` of a ``--workload k2``, ``k3``, ``k4``,
    ``k5`` or ``k6`` run's output."""
    with open(path) as fh:
        return next(json.loads(ln) for ln in reversed(fh.read().splitlines())
                    if ln.startswith("{")
                    and any(f'"{k}_sets"' in ln for k in ("k2", "k3", "k4", "k5", "k6")))


def _means(run: dict) -> dict:
    """A run's launch-weighted means: ``k2_means``, ``k3_means`` (with
    ``k4_hd768``), ``k4_means``, ``k5_means`` (by ``k6_means``) or
    ``k6_means``."""
    if "k2_sets" in run:
        return k2_means(run["k2_sets"])
    if "k3_sets" in run:
        return dict(k3_means(run["k3_sets"]),
                    k4_hd768={r["set"]: r["ms"] for r in run["k4_hd768"]})
    if "k4_sets" in run:
        return k4_means(run["k4_sets"])
    return k6_means(run["k5_sets"] if "k5_sets" in run else run["k6_sets"])


def k2_means(rows: list) -> dict:
    """Per path (a set's name without its width) and kernel, each number of
    its sets averaged with the sets' calls as weights: graph and event
    times, the bound, the library call, the f32 kernel on the same operands
    and the row-a-warp kernel, where the sets have them."""
    groups = {}
    for r in rows:
        groups.setdefault(f"{r['set'].rsplit('_F', 1)[0]} {r['kernel']}", []).append(r)
    out = {}
    for key, rs in groups.items():
        n = sum(r["calls"] for r in rs)
        out[key] = {"calls": n, "widths": [r["F"] for r in rs]}
        for k in ("ms", "events_ms", "bound_ms", "library_ms", "library_events_ms", "f32_ms",
                  "rowwarp_ms", "rowwarp_events_ms"):
            if all(r.get(k) is not None for r in rs):
                out[key][k] = sum(r["calls"] * r[k] for r in rs) / n
    return out


def _time_k2(cs, args, run_dir: str, result: dict) -> None:
    """K2 and K2b per operand set (``k2_sets``), then ``--against``."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
    from quadtree_mpnnlstm_tpu_torch.ops import spmm

    ds = ModMovingMNISTDataset(
        cs.BATCH, input_timesteps=cs.T_IN, output_timesteps=cs.T_OUT, canvas_size=cs.CANVAS,
        digit_size=cs.DIGIT, pixel_noise=0.02, velocity_noise=0.0, seed=args.seed)
    x = torch.as_tensor(ds.x, device=cs.DEVICE)
    _, batches = cs.train_batches(args.seed, 1)
    rows = []
    for conv in ("ChebConv", "GCNConv"):
        for dtype in ("float32", "bfloat16"):
            model = cs.make_model(args.seed, run_dir, conv, dtype=dtype)
            cfg = model.cfg
            k = 2 if conv == "ChebConv" else 1  # Â·z a conv layer (ChebConv: K = 3 taps)
            with cs.Capture(spmm, cs.T_IN * cfg.n_layers * cfg.n_conv_layers * k,
                            (cfg.n_layers + 2) * k) as cap:
                model.forecast(x)
            trainer = cs.make_trainer(args.seed, run_dir, conv, dtype=dtype)
            with cs.CaptureBwd(spmm, "_apply_bwd_cuda") as cap_b:
                trainer.train_step(*batches[0])
            path = f"{conv}_{dtype}"
            rows += [k2_measure(cs, spmm, f"{path}_F{f}", "spmm_apply", cap.per_width[f], a)
                     for f, a in cap.operands().items()]
            rows += [k2_measure(cs, spmm, f"{path}_F{f}", "spmm_apply_bwd", cap_b.per_width[f], a)
                     for f, a in sorted(cap_b.first.items())]
            del model, trainer, cap, cap_b
            torch.cuda.empty_cache()
    for dtype, batch in (("float32", cs.BATCH), ("bfloat16", 32)):
        trainer = cs.make_trainer(args.seed, run_dir, dtype=dtype, remat="full",
                                  shared_mesh=True)
        xb, yb = cs.shared_batches(args.seed, batch, 1)[0]
        with cs.CaptureBwd(spmm, "_apply_cuda") as fwd, \
                cs.CaptureBwd(spmm, "_apply_bwd_cuda") as bwd:
            trainer.train_step(xb, yb)
        for kernel, cap in (("spmm_apply", fwd), ("spmm_apply_bwd", bwd)):
            rows += [k2_measure(cs, spmm, f"shared_{dtype}_b{batch}_F{f}", kernel,
                                cap.per_width[f], a) for f, a in sorted(cap.first.items())]
        del trainer, fwd, bwd
        torch.cuda.empty_cache()
    result["k2_sets"] = rows
    result["k2_means"] = k2_means(rows)
    if args.against:
        other = _last_run(args.against)
        theirs = {(r["set"], r["kernel"]): r for r in other["k2_sets"]}
        keys = [(r["set"], r["kernel"]) for r in rows]
        inputs = all(k in theirs and theirs[k]["input_sha"] == r["input_sha"]
                     for k, r in zip(keys, rows))
        differ = [k for k, r in zip(keys, rows)
                  if k not in theirs or theirs[k]["output_sha"] != r["output_sha"]]
        result["against"] = dict(file=args.against, tree=other.get("tree"), sets=len(rows),
                                 inputs_identical=inputs, bit_identical=inputs and not differ,
                                 differing=differ)


def _k4_split(attn, args, reps: int = 5) -> dict:
    """ms per call of K4's first kernel (per destination), its second (per
    source) and every other device kernel of the call (the dWₑ sum, the
    cast), from one ``torch.profiler`` pass over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    attn._attn_bwd_cuda(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            attn._attn_bwd_cuda(*args)
        torch.cuda.synchronize()
    split = {"first_ms": 0.0, "second_ms": 0.0, "other_ms": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation",
                                                                      False):
            continue
        key = ("first_ms" if "attn_bwd_kernel" in e.name else
               "second_ms" if "attn_bwd_src_kernel" in e.name else "other_ms")
        split[key] += e.time_range.elapsed_us() / 1e3 / reps
    return split


def k4_measure(cs, attn, name: str, calls: int, args) -> dict:
    """One K4 operand set: the kernel against ``attn_bwd_plain`` (f32 within
    ``K4_TOL`` × max(1, max|grad|), bf16 within one rounding), repeated bit
    for bit; graph and event times beside the bound (the shared-window
    bound on a shared mesh), in bf16 the f32 kernel on the same operands,
    the split between K4's kernels (:func:`_k4_split`), the plan where the
    tree has one, and the digest of the inputs."""
    import torch

    q, meta, dims = args[0], args[5], args[6]
    bf16 = q.dtype == torch.bfloat16
    kern, plain = attn._attn_bwd_cuda(*args), attn.attn_bwd_plain(*args)
    again = attn._attn_bwd_cuda(*args)
    err = {n: float((a.float() - p.float()).abs().max()) for n, a, p in
           zip(("dq", "dk", "dv", "dwe"), kern, plain)}
    rel = {n: err[n] / max(1.0, float(p.float().abs().max())) for n, p in
           zip(("dq", "dk", "dv", "dwe"), plain)}
    cs.check(max(rel.values()) <= (cs.BF16_TOL if bf16 else cs.K4_TOL),
             f"{name}: K4 differs from its plain version: {rel}")
    repeat = all(torch.equal(a, b) for a, b in zip(kern, again))
    cs.check(repeat, f"{name}: two K4 launches differ")
    shared = meta.s0.shape[0] == 1 and q.shape[0] > 1
    bound_fn = cs.attn_shared_bound_ms if shared else cs.attn_bound_ms
    bound, b_ms, o_ms = bound_fn(attn, args, True)
    row = dict(set=name, dtype=str(q.dtype).replace("torch.", ""), batch=q.shape[0],
               HD=q.shape[-1], heads=dims.heads, d=dims.d, shared_mesh=shared, calls=calls,
               keep=args[4] is not None, live_tiles=int(meta.live.long().sum()),
               max_abs_err=max(err.values()), err_rel_to_max=rel, repeat_bit_identical=repeat,
               ms=cs.graph_ms(lambda: attn._attn_bwd_cuda(*args)),
               events_ms=cs.cuda_ms(lambda: attn._attn_bwd_cuda(*args)),
               bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms,
               bound_by="bytes" if b_ms >= o_ms else "operations", split=_k4_split(attn, args),
               plan=attn.bwd_plan(dims, q.element_size())._asdict()
               if hasattr(attn, "bwd_plan") else None,
               input_sha=_digest(*(x for x in args if torch.is_tensor(x)), *meta))
    if bf16:
        f32_args = tuple(x.float() if torch.is_tensor(x) and x.dtype == torch.bfloat16 else x
                         for x in args)
        row["f32_ms"] = cs.graph_ms(lambda: attn._attn_bwd_cuda(*f32_args))
    return row


def k4_means(rows: list) -> dict:
    """Per path (a set's name without its width), each number of its sets
    averaged with the sets' calls as weights: graph and event times, the
    bound, the f32 kernel on the same operands and the split, where the
    sets have them."""
    groups = {}
    for r in rows:
        groups.setdefault(r["set"].rsplit("_HD", 1)[0], []).append(r)
    out = {}
    for key, rs in groups.items():
        n = sum(r["calls"] for r in rs)
        out[key] = {"calls": n, "widths": [r["HD"] for r in rs]}
        for k in ("ms", "events_ms", "bound_ms", "plain_ms", "f32_ms"):
            if all(r.get(k) is not None for r in rs):
                out[key][k] = sum(r["calls"] * r[k] for r in rs) / n
        out[key]["split"] = {k: sum(r["calls"] * r["split"][k] for r in rs) / n
                             for k in rs[0]["split"]}
    return out


def _time_k4(cs, args, run_dir: str, result: dict) -> None:
    """K4 per operand set (``k4_sets``): the first call at each width of
    the train steps that ``chip_smoke.py`` captures K4 in: TransformerConv
    in f32 and bf16 on phase 10's batch, MHTransformerConv in f32 and bf16
    with phase 46's teacher forcing and batch, the ice-quadtree model's
    full-BPTT step (phase 42) and a shared-mesh step after a warm-up step
    (phase 55)."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.ops import attn

    rows = []

    def capture(path, trainer, step):
        with cs.CaptureBwd(attn, "_attn_bwd_cuda") as cap:
            step(trainer)
        del trainer
        out = [k4_measure(cs, attn, f"{path}_HD{hd}", cap.per_width[hd], a)
               for hd, a in sorted(cap.first.items())]
        del cap
        torch.cuda.empty_cache()
        return out

    for conv, n, forcing in (("TransformerConv", cs.TRAIN_STEPS + 1, 0.0),
                             ("MHTransformerConv", 2, 0.5)):
        batch = cs.train_batches(args.seed, n)[1][0]
        for dtype in ("float32", "bfloat16"):
            rows += capture(f"{conv}_{dtype}",
                            cs.make_trainer(args.seed, run_dir, conv, dtype=dtype,
                                            teacher_forcing_ratio=forcing),
                            lambda tr: tr.train_step(*batch))
    data, clim, mask = cs.ice_data(args.seed)
    trainer = cs.make_ice_quadtree_model(args.seed, run_dir)
    trainer.initiate_training(lr=cs.LR, lr_decay=0.95)
    c = trainer._clim_batch(clim, data.launch_dates[:1])
    rows += capture("ice_quadtree_bfloat16", trainer,
                    lambda tr: tr.train_step(data.x[:1], data.y[:1], mask=mask, climatology=c,
                                             truncated_backprop=cs.ICE_TBPTT))
    del trainer, data, clim, mask, c
    xb, yb = cs.shared_batches(args.seed, cs.BATCH, 1)[0]
    trainer = cs.make_trainer(args.seed, run_dir, conv="TransformerConv", shared_mesh=True)
    trainer.train_step(xb, yb)  # warm-up
    rows += capture(f"shared_float32_b{cs.BATCH}", trainer, lambda tr: tr.train_step(xb, yb))
    result["k4_sets"] = rows
    result["k4_means"] = k4_means(rows)



def k3_reuse(attn, meta, dims, rows: int = 32) -> dict:
    """How often a 32-row group's slots name the same source: live slots
    (a visible row, a source in the window) over the distinct (group,
    source) pairs, over the batch's meshes (host-side, from the windows)."""
    import torch

    dst, src = attn.slot_nodes(meta, dims)
    ok = (dst >= 0) & (src >= 0)
    b = torch.arange(dst.shape[0], device=dst.device)[:, None].expand_as(dst)
    groups = -(-dims.n_max // rows)
    key = ((b * groups + dst // rows) * (dims.n_max + 1) + src)[ok]
    slots, distinct = int(ok.sum()), int(torch.unique(key).numel())
    return dict(rows=rows, slots=slots, distinct=distinct,
                slots_per_source=slots / max(1, distinct))


def _k3_full_width(attn):
    """K3 on a call's whole width as the tree's ``AttnApply`` runs it: one
    launch, or the tree's head groups (a launch a group on column copies)."""
    if hasattr(attn, "attn_fwd_by_groups"):
        return lambda *a: attn.attn_fwd_by_groups(attn._attn_fwd_cuda, *a)
    return attn._attn_fwd_cuda


def _k4_full_width(attn):
    """K4 likewise (:func:`_k3_full_width`)."""
    if hasattr(attn, "attn_bwd_by_groups"):
        return lambda *a: attn.attn_bwd_by_groups(attn._attn_bwd_cuda, *a)
    return attn._attn_bwd_cuda


def k3_measure(cs, attn, name: str, calls: int, args) -> dict:
    """One K3 operand set at the call's whole width: the kernel against
    ``attn_plain`` (f32 within ``K3_TOL``, bf16 within one rounding ×
    max(1, max|plain|)), repeated bit for bit; graph and event times beside
    the bound, the plain version's time, in bf16 the f32 kernel on the same
    operands; the slots per distinct source of its 32-row groups, the
    launches a call, the plan where the tree has one and the digests."""
    import torch

    q, keep, meta, dims = args[0], args[4], args[5], args[6]
    bf16 = q.dtype == torch.bfloat16
    fwd = _k3_full_width(attn)
    counts = attn.LAUNCHES_BF16 if bf16 else attn.LAUNCHES
    with torch.no_grad():
        before = counts["attn_apply"]
        kern = fwd(*args)
        launches = counts["attn_apply"] - before
        plain, again = attn.attn_plain(*args), fwd(*args)
    err = float((kern.float() - plain.float()).abs().max())
    scale = max(1.0, float(plain.float().abs().max()))
    cs.check(err <= (cs.BF16_TOL * scale if bf16 else cs.K3_TOL),
             f"{name}: K3 differs from its plain version by {err}")
    repeat = torch.equal(kern, again)
    cs.check(repeat, f"{name}: two K3 launches differ")
    bound, b_ms, o_ms = cs.attn_bound_ms(attn, args, False)
    row = dict(set=name, dtype=str(q.dtype).replace("torch.", ""), batch=q.shape[0],
               HD=q.shape[-1], heads=dims.heads, d=dims.d, calls=calls, keep=keep is not None,
               live_tiles=int(meta.live.long().sum()), launches_per_call=launches,
               max_abs_err=err, err_rel_to_max=err / scale, repeat_bit_identical=repeat,
               ms=cs.graph_ms(lambda: fwd(*args)), events_ms=cs.cuda_ms(lambda: fwd(*args)),
               plain_ms=cs.cuda_ms(lambda: attn.attn_plain(*args)), bound_ms=bound,
               bytes_ms=b_ms, ops_ms=o_ms, bound_by="bytes" if b_ms >= o_ms else "operations",
               reuse=k3_reuse(attn, meta, dims),
               plan=attn.fwd_plan(dims, q.element_size())._asdict(),
               input_sha=_digest(*(x for x in args if torch.is_tensor(x)), *meta),
               output_sha=_digest(kern))
    if bf16:
        f32_args = tuple(x.float() if torch.is_tensor(x) and x.dtype == torch.bfloat16 else x
                         for x in args)
        row["f32_ms"] = cs.graph_ms(lambda: fwd(*f32_args))
    return row


def k4_call_row(cs, attn, name: str, args) -> dict:
    """K4 on one call's whole width (:func:`_k4_full_width`) against
    ``attn_bwd_plain`` (f32 within ``K4_TOL`` × max(1, max|grad|), bf16
    within one rounding), repeated bit for bit; graph and event times
    beside the bound and the launches a call."""
    import torch

    q = args[0]
    bf16 = q.dtype == torch.bfloat16
    bwd = _k4_full_width(attn)
    counts = attn.LAUNCHES_BF16 if bf16 else attn.LAUNCHES
    before = counts["attn_apply_bwd"]
    kern = bwd(*args)
    launches = counts["attn_apply_bwd"] - before
    plain, again = attn.attn_bwd_plain(*args), bwd(*args)
    names = ("dq", "dk", "dv", "dwe")
    rel = {n: float((a.float() - p.float()).abs().max()) / max(1.0, float(p.float().abs().max()))
           for n, a, p in zip(names, kern, plain)}
    cs.check(max(rel.values()) <= (cs.BF16_TOL if bf16 else cs.K4_TOL),
             f"{name}: K4 differs from its plain version: {rel}")
    repeat = all(torch.equal(a, b) for a, b in zip(kern, again))
    cs.check(repeat, f"{name}: two K4 calls differ")
    bound, b_ms, o_ms = cs.attn_bound_ms(attn, args, True)
    return dict(set=name, kernel="attn_apply_bwd", dtype=str(q.dtype).replace("torch.", ""),
                HD=q.shape[-1], calls=1, keep=args[4] is not None, launches_per_call=launches,
                err_rel_to_max=rel, repeat_bit_identical=repeat,
                ms=cs.graph_ms(lambda: bwd(*args)), events_ms=cs.cuda_ms(lambda: bwd(*args)),
                bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms,
                output_sha=_digest(*kern))


def k3_means(rows: list) -> dict:
    """Per path (a set's name without its width), each number of its sets
    averaged with the sets' calls as weights: graph and event times, the
    bound, the plain version, the f32 kernel on the same operands and the
    slots per distinct source."""
    groups = {}
    for r in rows:
        groups.setdefault(r["set"].rsplit("_HD", 1)[0], []).append(r)
    out = {}
    for key, rs in groups.items():
        n = sum(r["calls"] for r in rs)
        out[key] = {"calls": n, "widths": [r["HD"] for r in rs]}
        for k in ("ms", "events_ms", "bound_ms", "plain_ms", "f32_ms"):
            if all(r.get(k) is not None for r in rs):
                out[key][k] = sum(r["calls"] * r[k] for r in rs) / n
        if all("reuse" in r for r in rs):
            out[key]["slots_per_source"] = sum(r["calls"] * r["reuse"]["slots_per_source"]
                                               for r in rs) / n
    return out


def _time_k3(cs, args, run_dir: str, result: dict) -> None:
    """K3 per operand set (``k3_sets``): the first call at each width of a
    forecast (no keep) and of a train step (keep windows where the step
    drops out) of ``bench.py``'s TransformerConv model (phases 9-12, 31-34)
    and MHTransformerConv model (phase 46: HD 384, 48, 3), each in f32 and
    bf16, and of the ice-quadtree model (phase 42: HD 256; a T_out-90
    forecast, a T_out-6 full-BPTT step) in bf16 and f32, each weighted by
    its run's calls at that width; then HD 768 (24 heads × d 32, phase
    49's operands on one ice-quadtree mesh) with keep rows a head and
    without, in both dtypes, a call each, and K4 at HD 768 a call
    (``k4_hd768``)."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    ds = ModMovingMNISTDataset(
        cs.BATCH, input_timesteps=cs.T_IN, output_timesteps=cs.T_OUT, canvas_size=cs.CANVAS,
        digit_size=cs.DIGIT, pixel_noise=0.02, velocity_noise=0.0, seed=args.seed)
    x = torch.as_tensor(ds.x, device=cs.DEVICE)
    rows = []

    def measure(path, fwd_cap, step_cap):
        for kind, cap in (("forecast", fwd_cap), ("train", step_cap)):
            for hd, a in sorted(cap.first.items()):
                rows.append(k3_measure(cs, attn, f"{path}_{kind}_HD{hd}", cap.per_width[hd], a))
                print(json.dumps(rows[-1]), flush=True)

    for conv, n, forcing in (("TransformerConv", cs.TRAIN_STEPS + 1, 0.0),
                             ("MHTransformerConv", 2, 0.5)):
        batch = cs.train_batches(args.seed, n)[1][0]
        for dtype in ("float32", "bfloat16"):
            model = cs.make_model(args.seed, run_dir, conv, dtype=dtype)
            with cs.CaptureBwd(attn, "_attn_fwd_cuda") as fwd_cap:
                model.forecast(x)
            del model
            trainer = cs.make_trainer(args.seed, run_dir, conv, dtype=dtype,
                                      teacher_forcing_ratio=forcing)
            with cs.CaptureBwd(attn, "_attn_fwd_cuda") as step_cap:
                trainer.train_step(*batch)
            del trainer
            measure(f"{conv}_{dtype}", fwd_cap, step_cap)
            del fwd_cap, step_cap
            torch.cuda.empty_cache()
    data, clim, mask = cs.ice_data(args.seed)
    x0, y0 = data.x[:1], data.y[:1]
    for dtype in ("bfloat16", "float32"):
        model = cs.make_ice_quadtree_model(args.seed, run_dir, dtype=dtype)
        c = model._clim_batch(clim, data.launch_dates[:1])
        with cs.CaptureBwd(attn, "_attn_fwd_cuda") as fwd_cap:
            model.forecast(x0, mask=mask, climatology=c)
        del model
        short = cs.make_ice_quadtree_model(args.seed, run_dir, t_out=cs.ICE_SHORT_T_OUT,
                                           dtype=dtype)
        short.initiate_training(lr=cs.LR, lr_decay=0.95)
        with cs.CaptureBwd(attn, "_attn_fwd_cuda") as step_cap:
            short.train_step(x0, y0[:, :cs.ICE_SHORT_T_OUT], mask=mask,
                             climatology=c[:, :cs.ICE_SHORT_T_OUT],
                             truncated_backprop=cs.ICE_TBPTT)
        del short
        measure(f"ice_quadtree_{dtype}", fwd_cap, step_cap)
        del fwd_cap, step_cap
        torch.cuda.empty_cache()
    # HD 768 on one ice-quadtree mesh (phase 49's operands)
    bf16 = torch.bfloat16
    quad = cs.make_ice_quadtree_model(args.seed, run_dir)
    graph, _ = quad.model._graph(torch.as_tensor(x0, device=cs.DEVICE).to(bf16),
                                 torch.as_tensor(mask, device=cs.DEVICE))
    g = quad.gcfg
    del quad
    dims = attn.AttnDims(g.n_max, g.agg_nt, g.agg_eb, g.agg_sw, 24, 32)
    meta = graph.attn_meta
    gen = torch.Generator(cs.DEVICE).manual_seed(args.seed)
    qkv = [torch.randn(1, g.n_max, 768, device=cs.DEVICE, generator=gen) for _ in range(4)]
    we = torch.randn(meta.attr.shape[-1], 768, device=cs.DEVICE, generator=gen)
    keep = ((torch.rand(1, meta.s0.shape[1], 24, g.agg_eb, device=cs.DEVICE, generator=gen)
             < 0.9).float() / 0.9)
    k4_rows = []
    for dtype in ("float32", "bfloat16"):
        cast = (lambda t: t.to(bf16)) if dtype == "bfloat16" else (lambda t: t)
        q, k, v, cot = (cast(t) for t in qkv)
        for kp, kind in ((None, "forecast"), (keep, "train")):
            rows.append(k3_measure(cs, attn, f"hd768_{dtype}_{kind}_HD768", 1,
                                   (q, k, v, cast(we), kp, meta, dims)))
            print(json.dumps(rows[-1]), flush=True)
        k4_rows.append(k4_call_row(cs, attn, f"hd768_{dtype}_train_HD768",
                                   (q, k, v, cast(we), keep, meta, dims, cot, graph.slot_view)))
        print(json.dumps(k4_rows[-1]), flush=True)
    result["k3_sets"] = rows
    result["k3_means"] = k3_means(rows)
    result["k4_hd768"] = k4_rows

def _k6_full_width(grid_attn):
    """K6 on a call's whole width, as the tree's ``GridAttnApply`` runs it:
    one launch, or a tree's head-group dispatch (one launch a group on
    column copies) where it has one."""
    if hasattr(grid_attn, "grid_bwd_by_groups"):
        return lambda *a: grid_attn.grid_bwd_by_groups(grid_attn._grid_attn_bwd_cuda, *a)
    return grid_attn._grid_attn_bwd_cuda


class _K6Capture:
    """Wraps the launcher ``GridAttnApply.backward`` calls (the head-group
    dispatch where the tree has one) during a train step and keeps the
    first call's operands at each width H."""

    def __init__(self, grid_attn):
        self.grouped = hasattr(grid_attn, "grid_bwd_by_groups")
        self.name = "grid_bwd_by_groups" if self.grouped else "_grid_attn_bwd_cuda"
        self.module, self.first = grid_attn, {}
        self._launch = getattr(grid_attn, self.name)

    def __call__(self, *args):
        ops = args[1:] if self.grouped else args
        self.first.setdefault(ops[0].shape[-1], ops)
        return self._launch(*args)

    def __enter__(self):
        self._patch = mock.patch.object(self.module, self.name, self)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def k6_measure(cs, grid_attn, name: str, calls: int, args) -> dict:
    """One K6 operand set: the backward at the call's width (one launch, or
    the tree's head groups) against ``grid_attn_bwd_plain`` (f32 within
    ``K6_TOL`` × max(1, max|grad|), bf16 within one rounding), repeated bit
    for bit; graph and event times beside the bound, in bf16 the f32 kernel
    on the same operands, the plan where the tree has one, and the digest
    of the inputs."""
    import torch

    q, dims = args[0], args[6]
    bf16 = q.dtype == torch.bfloat16
    bwd = _k6_full_width(grid_attn)
    kern, plain = bwd(*args), grid_attn.grid_attn_bwd_plain(*args)
    again = bwd(*args)
    names = ("dq", "dk", "dv", "de_dir")
    err = {n: float((a.float() - p.float()).abs().max()) for n, a, p in zip(names, kern, plain)}
    rel = {n: err[n] / max(1.0, float(p.float().abs().max())) for n, p in zip(names, plain)}
    cs.check(max(rel.values()) <= (cs.BF16_TOL if bf16 else cs.K6_TOL),
             f"{name}: K6 differs from its plain version: {rel}")
    repeat = all(torch.equal(a, b) for a, b in zip(kern, again))
    cs.check(repeat, f"{name}: two K6 launches differ")
    bound, b_ms, o_ms = cs.grid_bound_ms(args, backward=True)
    plan = None
    if hasattr(grid_attn, "BwdPlan"):
        plan = grid_attn.bwd_plan(dims, q.element_size(), q.shape[0])._asdict()
    row = dict(set=name, dtype=str(q.dtype).replace("torch.", ""), batch=q.shape[0],
               H=q.shape[-1], heads=dims.heads, d=dims.d, ndirs=dims.ndirs, calls=calls,
               keep=args[5] is not None, max_abs_err=max(err.values()), err_rel_to_max=rel,
               repeat_bit_identical=repeat, ms=cs.graph_ms(lambda: bwd(*args)),
               events_ms=cs.cuda_ms(lambda: bwd(*args)), bound_ms=bound, bytes_ms=b_ms,
               ops_ms=o_ms, bound_by="bytes" if b_ms >= o_ms else "operations", plan=plan,
               input_sha=_digest(*(x for x in args if torch.is_tensor(x))))
    if bf16:
        f32_args = tuple(x.float() if torch.is_tensor(x) and x.dtype == torch.bfloat16 else x
                         for x in args)
        row["f32_ms"] = cs.graph_ms(lambda: bwd(*f32_args))
    return row


def k6_means(rows: list) -> dict:
    """Per path (a set's name without its width; K5's: with forecast or
    train), each number of its sets averaged with the sets' calls as
    weights: graph and event times, the bound and the f32 kernel on the
    same operands, where the sets have them."""
    groups = {}
    for r in rows:
        groups.setdefault(r["set"].rsplit("_H", 1)[0], []).append(r)
    out = {}
    for key, rs in groups.items():
        n = sum(r["calls"] for r in rs)
        out[key] = {"calls": n, "widths": [r["H"] for r in rs]}
        for k in ("ms", "events_ms", "bound_ms", "plain_ms", "f32_ms"):
            if all(r.get(k) is not None for r in rs):
                out[key][k] = sum(r["calls"] * r[k] for r in rs) / n
    return out


def _time_k6(cs, args, run_dir: str, result: dict) -> None:
    """K6 per operand set (``k6_sets``): the first call at each width of a
    T_out-6 train step of the flagship on the grid, fused in f32 and bf16,
    per-gate in bf16 under remat full and MHTransformerConv in bf16 under
    remat full, weighted by the calls at that width of a full step (the
    ``grid_attn_apply`` calls of a T_out-90 forecast)."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.ops import grid_attn

    data, clim, mask = cs.ice_data(args.seed)
    x0, y0 = data.x[:1], data.y[:1]
    rows = []
    for path, kw in K5_PATHS:
        model = cs.make_ice_model(args.seed, run_dir, **kw)
        clim0 = model._clim_batch(clim, data.launch_dates[:1])
        calls = {}
        apply = grid_attn.grid_attn_apply

        def count(*a, _apply=apply):  # a call at its whole width, by head groups or not
            calls[a[0].shape[-1]] = calls.get(a[0].shape[-1], 0) + 1
            return _apply(*a)

        with mock.patch.object(grid_attn, "grid_attn_apply", count):
            model.forecast(x0, mask=mask, climatology=clim0)
        del model
        short = cs.make_ice_model(args.seed, run_dir, t_out=cs.ICE_SHORT_T_OUT, **kw)
        short.initiate_training(lr=cs.LR, lr_decay=0.95)
        with _K6Capture(grid_attn) as cap:
            short.train_step(x0, y0[:, :cs.ICE_SHORT_T_OUT], mask=mask,
                             climatology=clim0[:, :cs.ICE_SHORT_T_OUT],
                             truncated_backprop=cs.ICE_TBPTT)
        del short
        for h, a in sorted(cap.first.items()):
            rows.append(k6_measure(cs, grid_attn, f"{path}_H{h}", calls[h], a))
            print(json.dumps(rows[-1]), flush=True)
        del cap
        torch.cuda.empty_cache()
    result["k6_sets"] = rows
    result["k6_means"] = k6_means(rows)

class _K5Capture:
    """Wraps the launcher ``_grid_attn_fwd_cuda`` while a forecast or a
    train step runs and keeps the first call's operands at each width H."""

    def __init__(self, grid_attn):
        self.module, self.first = grid_attn, {}
        self._launch = grid_attn._grid_attn_fwd_cuda

    def __call__(self, *args):
        self.first.setdefault(args[0].shape[-1], args)
        return self._launch(*args)

    def __enter__(self):
        self._patch = mock.patch.object(self.module, "_grid_attn_fwd_cuda", self)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def k5_measure(cs, grid_attn, name: str, calls: int, args) -> dict:
    """One K5 operand set: the forward against ``grid_attn_plain`` (bit for
    bit, or the run fails), repeated bit for bit; graph and event times
    beside the bound and the plain version's time, in bf16 the f32 kernel
    on the same operands, the plan (where the tree has ``FwdPlan``) and
    the digest of the inputs."""
    import torch

    q, dims = args[0], args[6]
    fwd = grid_attn._grid_attn_fwd_cuda
    with torch.no_grad():
        kern, plain, again = fwd(*args), grid_attn.grid_attn_plain(*args), fwd(*args)
    err = float((kern.float() - plain.float()).abs().max())
    cs.check(torch.equal(kern, plain),
             f"{name}: K5 is not bit-identical to its plain version: {err}")
    repeat = torch.equal(kern, again)
    cs.check(repeat, f"{name}: two K5 launches differ")
    bound, b_ms, o_ms = cs.grid_bound_ms(args, backward=False)
    if hasattr(grid_attn, "FwdPlan"):
        plan = grid_attn.fwd_plan(dims, q.element_size(), q.shape[0])._asdict()
    else:
        plan = list(grid_attn.fwd_plan(dims))
    row = dict(set=name, dtype=str(q.dtype).replace("torch.", ""), batch=q.shape[0],
               H=q.shape[-1], heads=dims.heads, d=dims.d, ndirs=dims.ndirs, calls=calls,
               keep=args[5] is not None, max_abs_err=err, bit_identical=True,
               repeat_bit_identical=repeat, ms=cs.graph_ms(lambda: fwd(*args)),
               events_ms=cs.cuda_ms(lambda: fwd(*args)),
               plain_ms=cs.cuda_ms(lambda: grid_attn.grid_attn_plain(*args)), bound_ms=bound,
               bytes_ms=b_ms, ops_ms=o_ms, bound_by="bytes" if b_ms >= o_ms else "operations",
               plan=plan, input_sha=_digest(*(x for x in args if torch.is_tensor(x))))
    if q.dtype == torch.bfloat16:
        f32_args = tuple(x.float() if torch.is_tensor(x) and x.dtype == torch.bfloat16 else x
                         for x in args)
        row["f32_ms"] = cs.graph_ms(lambda: fwd(*f32_args))
    return row


def _time_k5(cs, args, run_dir: str, result: dict) -> None:
    """K5 per operand set (``k5_sets``): the first call at each width of a
    T_out-90 forecast (no keep planes) and of a T_out-6 train step (with the
    dropout keep planes) of the flagship on the grid, fused in f32 and
    bf16, per-gate in bf16 under remat full and MHTransformerConv in bf16
    under remat full, each weighted by the calls at that width of the
    forecast."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.ops import grid_attn

    data, clim, mask = cs.ice_data(args.seed)
    x0, y0 = data.x[:1], data.y[:1]
    rows = []
    for path, kw in K5_PATHS:
        model = cs.make_ice_model(args.seed, run_dir, **kw)
        clim0 = model._clim_batch(clim, data.launch_dates[:1])
        calls = {}
        apply = grid_attn.grid_attn_apply

        def count(*a, _apply=apply):
            calls[a[0].shape[-1]] = calls.get(a[0].shape[-1], 0) + 1
            return _apply(*a)

        with mock.patch.object(grid_attn, "grid_attn_apply", count), _K5Capture(grid_attn) as cap:
            model.forecast(x0, mask=mask, climatology=clim0)
        sets = {"forecast": cap.first}
        del model
        short = cs.make_ice_model(args.seed, run_dir, t_out=cs.ICE_SHORT_T_OUT, **kw)
        short.initiate_training(lr=cs.LR, lr_decay=0.95)
        with _K5Capture(grid_attn) as cap:
            short.train_step(x0, y0[:, :cs.ICE_SHORT_T_OUT], mask=mask,
                             climatology=clim0[:, :cs.ICE_SHORT_T_OUT],
                             truncated_backprop=cs.ICE_TBPTT)
        sets["train"] = cap.first
        del short
        for kind, first in sets.items():
            for h, a in sorted(first.items()):
                cs.check((a[5] is not None) == (kind == "train"),
                         f"{path} {kind} H {h}: keep planes {a[5] is not None}")
                rows.append(k5_measure(cs, grid_attn, f"{path}_{kind}_H{h}", calls[h], a))
                print(json.dumps(rows[-1]), flush=True)
        del sets, cap
        torch.cuda.empty_cache()
    result["k5_sets"] = rows
    result["k5_means"] = k6_means(rows)


# the paths --workload k5 and k6 time: chip_smoke.py phases 13-14 (fused
# f32), 35-36 (fused bf16), 39-40 (per-gate bf16, remat full) and 49 (MH
# bf16, remat full: H 768, 96 and 3)
K5_PATHS = (("fused_float32", dict()), ("fused_bfloat16", dict(dtype="bfloat16")),
            ("per_gate_bfloat16", dict(dtype="bfloat16", remat=True, fused_gates=False)),
            ("mh_bfloat16", dict(dtype="bfloat16", remat=True, fused_gates=False,
                                 conv="MHTransformerConv")))


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
