#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's forecast and training paths on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases (each prints one line; any failure raises and exits non-zero):

1. card name and power limit (``nvidia-smi``); build the CUDA kernels from
   ``quadtree_mpnnlstm_tpu_torch/csrc`` with ``nvcc`` and load them;
2. main path: ``NextFramePredictorS2S.predict`` on 16 Moving-MNIST 64×64
   videos made from ``--seed`` — T_in=4 → T_out=10, quadtree thresh=0.1
   with a remesh every decoder step, ChebConv GConvLSTM, hidden 16, 2×2
   layers, n_max=2048, e_max=10240, node_budget=2048, NT=128,
   EB=SW=1024, f32, random weights from the seed. Checks finite outputs of
   shape (16, 10, 64, 64, 1) and zero mesh overflow; times one batch after
   a warm-up and counts the kernel launches of that batch;
3. each kernel against its plain PyTorch version on the operands of the
   main path (the Â windows of the meshes the first decoder steps run on;
   the z of every width F the path uses): K1 exact, K2 ≤1e-5; times
   kernel, plain version and library call with CUDA events;
4. the whole rollout again with the plain versions on the card: the first
   decoder step's meshes must be identical, and frames must agree to
   ≤1e-4 up to the first step where a sample's mesh differs (a quadtree
   cell near the threshold can flip; such a flip is reported);
5. train path: ``train_step`` (fwd + bwd + clipped Adam, lr 0.01,
   dropout 0.1) at the same width on batches of 16 made from ``--seed`` as
   ``bench.py`` ``measure`` makes them: one warm-up step (in which every
   Â·z whose input requires grad must carry the K2b autograd node), then
   8 timed steps with the loss and overflow fetched one step late. Checks
   a finite loss, zero overflow and the launches per step read from the
   code (K1 11, K2 112, K2b 110); prints steps/s, frames/s and peak memory;
6. train entry: one epoch of ``train()`` over 2 training batches and 1
   test batch, then ``score()``; finite losses;
7. gradients vs plain: K2b against its plain version on the cotangents of
   every width F of one train step (≤1e-5, timed like K2), then one whole
   train step with the kernels and one with the plain versions from the
   same weights and generator: the meshes must be identical, and every
   gradient leaf must agree to ≤1e-4 × max(1, max|g|);
8. train determinism: the same train step twice gives a bit-identical
   loss and gradients;
9. the ``kernels`` JSON line, then the card line and the result line.

It fails at once without a CUDA card, and when the port's package is not
beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# outside the tensor cores (the kernels use no TF32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

DEVICE = "cuda"
CANVAS, DIGIT = (64, 64), (18, 18)
T_IN, T_OUT, BATCH = 4, 10, 16
K2_TOL, ROLLOUT_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-4
REPS = 20
TRAIN_STEPS, LR = 8, 0.01


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def make_model(seed: int, run_dir: str = "runs"):
    from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S

    return NextFramePredictorS2S(
        image_shape=CANVAS, thresh=0.1,
        input_features=1, input_timesteps=T_IN, output_timesteps=T_OUT,
        device=DEVICE, seed=seed, run_dir=run_dir,
        model_kwargs=dict(hidden_size=16, n_layers=2, n_conv_layers=2,
                          convolution_type="ChebConv"),
        graph_kwargs=dict(max_grid_size=8, n_max=2048, e_max=10240, node_budget=2048,
                          agg_eb=1024, agg_sw=1024, aggregation="pallas"),
    )


class Capture:
    """Wraps the kernel launchers during one extra forecast and keeps the
    operands of the first two mesh builds and, per width F, of the first
    decoder step's Â·z (or the first call at a width the decoder does not
    use), plus the number of calls at each width."""

    def __init__(self, spmm, enc_calls: int, dec_step_calls: int):
        self.spmm = spmm
        self.builds, self.per_width = [], {}
        self.first_ops, self.dec0_ops = {}, {}
        self.calls = 0
        self.dec0 = range(enc_calls, enc_calls + dec_step_calls)
        self._build, self._apply = spmm._build_blocks_cuda, spmm._apply_cuda

    def build(self, *args):
        if len(self.builds) < 2:
            self.builds.append(args)
        return self._build(*args)

    def apply(self, *args):
        f = args[0].shape[-1]
        self.per_width[f] = self.per_width.get(f, 0) + 1
        (self.dec0_ops if self.calls in self.dec0 else self.first_ops).setdefault(f, args)
        self.calls += 1
        return self._apply(*args)

    def operands(self):
        """{F: args}: the first decoder step's where it has F, else the
        first call's."""
        return dict(sorted({**self.first_ops, **self.dec0_ops}.items()))

    def __enter__(self):
        self._patches = [mock.patch.object(self.spmm, "_build_blocks_cuda", self.build),
                         mock.patch.object(self.spmm, "_apply_cuda", self.apply)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in reversed(self._patches):
            p.stop()


def make_trainer(seed: int, run_dir: str):
    """The main path's model, ready to train (Adam at lr 0.01, γ 0.95)."""
    model = make_model(seed, run_dir)
    model.initiate_training(lr=LR, lr_decay=0.95)
    return model


def expected_launches(cfg) -> dict:
    """Kernel launches of one full-BPTT train step, read from the code:
    K1 once per mesh (the encoder's and one remesh after every decoder
    step); K2 twice per conv layer (K = 3 taps) of every encoder cell
    step, decoder cell step (1 conv layer each) and head conv (2); K2b
    for every K2 whose input requires grad, which is all of them but the
    first conv layer of encoder layer 0 at step 0: there ``[x ‖ h]`` holds
    the input frame and the zero initial state, and no parameter."""
    k2 = 2 * (T_IN * cfg.n_layers * cfg.n_conv_layers + T_OUT * (cfg.n_layers + 2))
    return {"spmm_build_blocks": 1 + T_OUT, "spmm_apply": k2, "spmm_apply_bwd": k2 - 2}


def train_batches(seed: int, n: int):
    """``n`` batches of 16 made as ``bench.py`` ``measure`` makes them."""
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    ds = ModMovingMNISTDataset(
        BATCH * n, input_timesteps=T_IN, output_timesteps=T_OUT, canvas_size=CANVAS,
        digit_size=DIGIT, pixel_noise=0.02, velocity_noise=0.0, seed=seed,
    )
    return ds, [(ds.x[i * BATCH:(i + 1) * BATCH], ds.y[i * BATCH:(i + 1) * BATCH])
                for i in range(n)]


class GradFnCheck:
    """Wraps ``spmm_apply`` for one train step and records every output
    whose input requires grad but whose autograd node is not K2b's."""

    def __init__(self, spmm):
        self.spmm, self.calls, self.bad = spmm, 0, []
        self._apply = spmm.spmm_apply

    def __call__(self, z, *args):
        out = self._apply(z, *args)
        if z.requires_grad:
            self.calls += 1
            if type(out.grad_fn).__name__ != "SpmmApplyBackward":
                self.bad.append(type(out.grad_fn).__name__)
        return out

    def __enter__(self):
        self._patch = mock.patch.object(self.spmm, "spmm_apply", self)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


class CaptureBwd:
    """Wraps K2b's launcher during one train step and keeps the operands
    of the first call at each cotangent width F, with the calls per F."""

    def __init__(self, spmm):
        self.spmm, self.first, self.per_width = spmm, {}, {}
        self._launch = spmm._apply_bwd_cuda

    def __call__(self, *args):
        f = args[0].shape[-1]
        self.per_width[f] = self.per_width.get(f, 0) + 1
        self.first.setdefault(f, args)
        return self._launch(*args)

    def __enter__(self):
        self._patch = mock.patch.object(self.spmm, "_apply_bwd_cuda", self)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def step_with_meshes(trainer, x, y, seed: int):
    """One ``train_step`` with its own generator; returns (loss, overflow,
    {name: grad}, meshes (T_out, B, P) the decoder ran on)."""
    import torch

    seq = trainer.model
    meshes = []
    decode = seq.decode

    def recording_decode(*args, **kw):
        out = decode(*args, **kw)
        meshes.append(out[2])
        return out

    seq.decode = recording_decode
    try:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        loss, overflow = trainer.train_step(x, y, generator=gen)
    finally:
        del seq.decode
    grads = {n: p.grad.detach().clone() for n, p in seq.named_parameters()}
    return loss, overflow, grads, torch.cat(meshes)


def k1_bound_ms(src_rel, dst_rel, live, nt, sw):
    """Least time for K1's work: read the live tiles' windows (3 × 4 B a
    slot) and write every block once (4 B an entry); one add a valid slot."""
    import torch

    b, t, eb = src_rel.shape
    n_live = int(live.long().sum())
    nbytes = n_live * eb * 12 + b * t * nt * sw * 4
    tile = torch.arange(t, device=src_rel.device)[None, :, None]
    valid = (src_rel >= 0) & (dst_rel >= 0) & (tile < live[:, None, None])
    ops = int(valid.sum())
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def k2_bound_ms(live, n_max, nt, sw, f, batch):
    """Least time for K2's work: per live tile its Â block (NT·SW·4 B) and
    z window (SW·F·4 B) read once, the output written once; 2·NT·SW·F
    f32 operations a live tile."""
    n_live = int(live.long().sum())
    nbytes = n_live * (nt * sw * 4 + sw * f * 4) + batch * n_max * f * 4
    ops = 2 * nt * sw * f * n_live
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def block_diag_csr(s0, blocks, n_max, nt, sw):
    """Â of every sample as one block-diagonal sparse CSR matrix, for the
    library yardstick (torch.sparse.mm)."""
    import torch

    b, t = s0.shape
    bi, ti, ri, si = torch.nonzero(blocks, as_tuple=True)
    rows = bi * n_max + ti * nt + ri
    cols = bi * n_max + s0.long()[bi, ti] + si
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), blocks[bi, ti, ri, si],
                                  (b * n_max, b * n_max), check_invariants=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "CSR support is in beta"
        return coo.coalesce().to_sparse_csr()


def train_phases(seed: int, card: str, spmm, cfg, nt: int, sw: int, n_max: int):
    """Phases 5-8 on the training path; returns the launches of the timed
    train steps and K2b's per-width measurements."""
    import torch

    from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader

    # ---- phase 5: the train path through train_step
    run_dir = tempfile.TemporaryDirectory()
    trainer = make_trainer(seed, run_dir.name)
    want = expected_launches(cfg)
    _, batches = train_batches(seed, TRAIN_STEPS + 1)
    with GradFnCheck(spmm) as gcheck:
        loss, overflow = trainer.train_step(*batches[0])  # warm-up
    check(float(loss) == float(loss), "warm-up loss is NaN")
    check(not gcheck.bad and gcheck.calls == want["spmm_apply_bwd"],
          f"Â·z outputs without the K2b node: {gcheck.bad[:3]} "
          f"({gcheck.calls} outputs required grad)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spmm.reset_launch_counts()
    t0 = time.perf_counter()
    losses, worst, pending = [], 0, None
    for x_b, y_b in batches[1:]:
        loss, overflow = trainer.train_step(x_b, y_b)
        if pending is not None:  # one step late, as train() drains
            losses.append(float(pending[0]))
            worst = max(worst, int(pending[1]))
        pending = (loss, overflow)
    losses.append(float(pending[0]))
    worst = max(worst, int(pending[1]))
    train_s = time.perf_counter() - t0
    train_launches = dict(spmm.LAUNCHES)
    per_step = {k: v / TRAIN_STEPS for k, v in train_launches.items()}
    check(bool(np.isfinite(losses).all()), f"non-finite training loss {losses}")
    check(worst == 0, f"mesh overflow {worst} in training")
    check(per_step == {k: float(v) for k, v in want.items()},
          f"launches per step {per_step}, expected {want}")
    print(json.dumps({
        "phase": "train_path", "card": card, "batch": BATCH, "steps": TRAIN_STEPS,
        "seconds": train_s, "steps_per_s": TRAIN_STEPS / train_s,
        "frames_per_s": TRAIN_STEPS * BATCH * T_OUT / train_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "losses": losses, "overflow": worst, "launches_per_step": per_step,
        "k2_outputs_checked": gcheck.calls,
    }), flush=True)

    # ---- phase 6: one epoch of train(), then score()
    entry = make_trainer(seed, run_dir.name)
    train_set = ArrayDataset(np.concatenate([b[0] for b in batches[:2]]),
                             np.concatenate([b[1] for b in batches[:2]]), np.zeros(2 * BATCH))
    loader_train = DataLoader(train_set, batch_size=BATCH)
    loader_test = DataLoader(ArrayDataset(batches[2][0], batches[2][1], np.zeros(BATCH)),
                             batch_size=BATCH)
    t0 = time.perf_counter()
    entry.train(loader_train, loader_test, n_epochs=1, divergence_threshold=float("inf"))
    epoch_s = time.perf_counter() - t0
    score = entry.score(loader_test)
    check(bool(np.isfinite(entry.loss["train_loss"] + entry.loss["test_loss"]).all()),
          f"non-finite epoch losses {entry.loss}")
    check(np.isfinite(score["MSE"]), f"score() gave {score}")
    print(json.dumps({"phase": "train_entry", "card": card, "epoch_s": epoch_s,
                      "train_loss": entry.loss["train_loss"][0],
                      "test_loss": entry.loss["test_loss"][0], "score": score}), flush=True)

    # ---- phase 7: K2b vs its plain version, then a step on each path
    x_g, y_g = batches[0]
    with CaptureBwd(spmm) as cap_b:
        make_trainer(seed, run_dir.name).train_step(x_g, y_g)
    bwd_widths = []
    for f, bargs in sorted(cap_b.first.items()):
        g, s0, blocks, live = bargs[:4]
        kern = spmm._apply_bwd_cuda(*bargs)
        plain = spmm.apply_plain(*bargs)
        err = float((kern - plain).abs().max())
        check(err <= K2_TOL, f"K2b differs from its plain version at F={f}: {err}")
        csr = block_diag_csr(s0, blocks, n_max, nt, sw)
        gf = g.reshape(-1, f)
        bound, b_ms, o_ms = k2_bound_ms(live, n_max, nt, sw, f, g.shape[0])
        bwd_widths.append(dict(
            F=f, calls=cap_b.per_width[f], max_abs_err=err, live_tiles=int(live.long().sum()),
            ms=cuda_ms(lambda: spmm._apply_bwd_cuda(*bargs)),
            plain_ms=cuda_ms(lambda: spmm.apply_plain(*bargs)),
            library_ms=cuda_ms(lambda: torch.sparse.mm(csr, gf)),
            bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms,
        ))
    check(sum(w["calls"] for w in bwd_widths) == want["spmm_apply_bwd"],
          "capture step disagrees with the train path")
    loss_k, _, grads_k, meshes_k = step_with_meshes(make_trainer(seed, run_dir.name),
                                                    x_g, y_g, seed=1)
    with mock.patch.object(spmm, "_build_blocks_cuda", spmm.build_blocks_plain), \
            mock.patch.object(spmm, "_apply_cuda", spmm.apply_plain), \
            mock.patch.object(spmm, "_apply_bwd_cuda", spmm.apply_plain):
        loss_p, _, grads_p, meshes_p = step_with_meshes(
            make_trainer(seed, run_dir.name), x_g, y_g, seed=1)
    check(torch.equal(meshes_k, meshes_p), "kernel and plain train steps ran on different meshes")
    leaf_err = max(float((grads_k[n] - grads_p[n]).abs().max())
                   / max(1.0, float(grads_p[n].abs().max())) for n in grads_p)
    check(leaf_err <= GRAD_TOL, f"gradients differ from the plain path by {leaf_err}")
    print(json.dumps({
        "phase": "grads_vs_plain", "card": card, "k2b_by_width": bwd_widths,
        "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
        "max_leaf_err_rel": leaf_err, "leaves": len(grads_p), "meshes_identical": True,
    }), flush=True)

    # ---- phase 8: the same train step again is bit-identical
    loss_k2, _, grads_k2, meshes_k2 = step_with_meshes(make_trainer(seed, run_dir.name),
                                                       x_g, y_g, seed=1)
    same = (torch.equal(loss_k, loss_k2) and torch.equal(meshes_k, meshes_k2)
            and all(torch.equal(grads_k[n], grads_k2[n]) for n in grads_k))
    check(same, "two identical train steps differ")
    print(json.dumps({"phase": "train_determinism", "card": card, "loss": float(loss_k2),
                      "bit_identical": same}), flush=True)
    run_dir.cleanup()
    return train_launches, bwd_widths


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's kernels need one", file=sys.stderr)
        return 2
    try:
        from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader
        from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
        from quadtree_mpnnlstm_tpu_torch.ops import cuda_build, spmm
    except ImportError as exc:
        print(f"chip_smoke: the port's package is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    # ---- phase 1: build
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    cuda_build.load_library("spmm.cu")  # raises if it does not load
    ptxas = [ln.strip() for src in libs for ln in
             libs[src].with_suffix(".log").read_text().splitlines() if "registers" in ln]
    print(json.dumps({"phase": "build", "card": card, "sources": sorted(libs),
                      "seconds": time.perf_counter() - t0, "ptxas": ptxas}), flush=True)

    # ---- phase 2: main path through predict()
    ds = ModMovingMNISTDataset(
        BATCH, input_timesteps=T_IN, output_timesteps=T_OUT, canvas_size=CANVAS,
        digit_size=DIGIT, pixel_noise=0.02, velocity_noise=0.0, seed=args.seed,
    )
    loader = DataLoader(ds, batch_size=BATCH)
    model = make_model(args.seed)
    model.predict(loader)  # warm-up (first launches, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spmm.reset_launch_counts()
    t0 = time.perf_counter()
    y = model.predict(loader)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = dict(spmm.LAUNCHES)
    check(y.shape == (BATCH, T_OUT, *CANVAS, 1), f"predict shape {y.shape}")
    check(bool(np.isfinite(y).all()), "non-finite forecast")
    check(model.last_overflow == 0, f"mesh overflow {model.last_overflow}")
    for name in ("spmm_build_blocks", "spmm_apply"):
        check(launches[name] > 0, f"{name} was not launched on the main path")
    print(json.dumps({
        "phase": "main_path", "card": card, "batch": BATCH, "batch_s": batch_s,
        "frames_per_s": BATCH * T_OUT / batch_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "overflow": model.last_overflow, "launches": launches,
    }), flush=True)

    # ---- phase 3: kernels vs plain versions on the main path's operands
    cfg = model.cfg
    enc_calls = T_IN * cfg.n_layers * cfg.n_conv_layers * 2  # K=3: 2 Â·z a layer
    dec_step_calls = cfg.n_layers * 2 + 2 * 2                # cells + the head
    x = torch.as_tensor(ds.x, device=DEVICE)
    with Capture(spmm, enc_calls, dec_step_calls) as cap:
        model.forecast(x)
    check(cap.calls == launches["spmm_apply"], "capture run disagrees with main path")
    gcfg = model.gcfg
    nt, sw, n_max = gcfg.agg_nt, gcfg.agg_sw, gcfg.n_max

    k1_err, k1 = 0.0, {}
    for i, bargs in enumerate(cap.builds):
        kern = spmm._build_blocks_cuda(*bargs)
        plain = spmm.build_blocks_plain(*bargs)
        check(torch.equal(kern, plain), f"K1 differs from its plain version (build {i})")
        k1_err = max(k1_err, float((kern - plain).abs().max()))
    bargs = cap.builds[0]
    k1["ms"] = cuda_ms(lambda: spmm._build_blocks_cuda(*bargs))
    k1["plain_ms"] = cuda_ms(lambda: spmm.build_blocks_plain(*bargs))
    k1["bound_ms"], k1_bytes_ms, k1_ops_ms = k1_bound_ms(bargs[0], bargs[1], bargs[3], nt, sw)
    k1["bound_by"] = "bytes" if k1_bytes_ms >= k1_ops_ms else "operations"

    widths = []
    for f, aargs in cap.operands().items():
        z, s0, blocks, live = aargs[:4]
        kern = spmm._apply_cuda(*aargs)
        plain = spmm.apply_plain(*aargs)
        err = float((kern - plain).abs().max())
        check(err <= K2_TOL, f"K2 differs from its plain version at F={f}: {err}")
        csr = block_diag_csr(s0, blocks, n_max, nt, sw)
        zf = z.reshape(-1, f)
        lib_err = float((torch.sparse.mm(csr, zf).reshape(z.shape) - plain).abs().max())
        bound, b_ms, o_ms = k2_bound_ms(live, n_max, nt, sw, f, z.shape[0])
        widths.append(dict(
            F=f, calls=cap.per_width[f], max_abs_err=err, library_max_abs_err=lib_err,
            live_tiles=int(live.long().sum()),
            ms=cuda_ms(lambda: spmm._apply_cuda(*aargs)),
            plain_ms=cuda_ms(lambda: spmm.apply_plain(*aargs)),
            library_ms=cuda_ms(lambda: torch.sparse.mm(csr, zf)),
            bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms,
        ))
    check(sorted(w["F"] for w in widths) == sorted(cap.per_width), "a width was not checked")
    print(json.dumps({"phase": "kernels_vs_plain", "card": card, "k1_max_abs_err": k1_err,
                      "k1_builds_checked": len(cap.builds), "k2_by_width": widths}),
          flush=True)

    # ---- phase 4: the rollout on the plain versions, on the card
    y_k, ovf_k, meshes_k = model.forecast(x)
    with mock.patch.object(spmm, "_build_blocks_cuda", spmm.build_blocks_plain), \
            mock.patch.object(spmm, "_apply_cuda", spmm.apply_plain):
        y_p, ovf_p, meshes_p = model.forecast(x)
    check(torch.equal(meshes_k[0], meshes_p[0]), "first decoder step's meshes differ")
    same = (meshes_k == meshes_p).all(dim=-1)  # (T_out, B)
    first_diff = [int(torch.nonzero(~same[:, b])[0]) if not same[:, b].all() else T_OUT
                  for b in range(BATCH)]
    frame_err = (y_k - y_p).abs().amax(dim=(2, 3, 4))  # (B, T_out)
    agree = max((float(frame_err[b, :first_diff[b]].max()) for b in range(BATCH)
                 if first_diff[b] > 0), default=0.0)
    check(agree <= ROLLOUT_TOL, f"frames differ by {agree} before any mesh flip")
    nodes = lambda m: (m.max(dim=-1).values + 1).tolist()  # noqa: E731
    print(json.dumps({
        "phase": "rollout_vs_plain", "card": card, "max_abs_err_before_flip": agree,
        "first_mesh_flip_step": first_diff, "overflow_kernel": int(ovf_k.max()),
        "overflow_plain": int(ovf_p.max()), "n_nodes_kernel": nodes(meshes_k),
        "n_nodes_plain": nodes(meshes_p),
    }), flush=True)

    train_launches, bwd_widths = train_phases(args.seed, card, spmm, cfg, nt, sw, n_max)

    # ---- phase 9: the kernels line
    n = sum(w["calls"] for w in widths)
    mean = lambda key: sum(w["calls"] * w[key] for w in widths) / n  # noqa: E731
    nb = sum(w["calls"] for w in bwd_widths)
    mean_b = lambda key: sum(w["calls"] * w[key] for w in bwd_widths) / nb  # noqa: E731
    by_path = lambda name: {"predict_batch": launches.get(name, 0),  # noqa: E731
                            f"train_{TRAIN_STEPS}_steps": train_launches[name]}
    source = "quadtree_mpnnlstm_tpu_torch/csrc/spmm.cu"
    kernels = [
        dict(name="spmm_build_blocks", route="cuda", source=source,
             replaces="quadtree_mpnnlstm_tpu/ops/pallas_spmm.py:249",
             launches=train_launches["spmm_build_blocks"], max_abs_err=k1_err, ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"], bound_by=k1["bound_by"],
             library_ms=None, launches_by_path=by_path("spmm_build_blocks")),
        dict(name="spmm_apply", route="cuda", source=source,
             replaces="quadtree_mpnnlstm_tpu/ops/pallas_spmm.py:322",
             launches=train_launches["spmm_apply"],
             max_abs_err=max(w["max_abs_err"] for w in widths),
             ms=mean("ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
             bound_by="bytes" if mean("bytes_ms") >= mean("ops_ms") else "operations",
             library_ms=mean("library_ms"), launches_by_path=by_path("spmm_apply")),
        dict(name="spmm_apply_bwd", route="cuda", source=source,
             replaces="quadtree_mpnnlstm_tpu/ops/pallas_spmm.py:363-365",
             launches=train_launches["spmm_apply_bwd"],
             max_abs_err=max(w["max_abs_err"] for w in bwd_widths),
             ms=mean_b("ms"), plain_ms=mean_b("plain_ms"), bound_ms=mean_b("bound_ms"),
             bound_by="bytes" if mean_b("bytes_ms") >= mean_b("ops_ms") else "operations",
             library_ms=mean_b("library_ms"), launches_by_path=by_path("spmm_apply_bwd")),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
