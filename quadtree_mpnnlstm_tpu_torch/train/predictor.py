"""Trainer and forecaster: ``NextFramePredictorS2S``.

Counterpart of ``quadtree_mpnnlstm_tpu/train/predictor.py``: config
resolution, ``train`` (Adam, global-norm clip, StepLR, truncated BPTT,
scheduled sampling, the NaN and divergence guards), ``predict``,
``score`` and checkpoints. The JAX package vmaps the model over the
samples of a batch; here the batch axis is explicit and each sample keeps
its own mesh. The batch loss is the mean over samples of each sample's
loss, as the vmapped JAX loss is.

Runs on ``device="cuda"`` unless the caller passes ``device="cpu"``; on
the card the Â-block kernels (ops/spmm.py, ChebConv on quadtree meshes;
also in bf16 with ``compute_dtype="bfloat16"``, which defaults to
``train_config.dtype``), the attention-window kernels (ops/attn.py,
TransformerConv on quadtree meshes) or the stencil attention kernels
(ops/grid_attn.py, TransformerConv on the pixelwise grid) carry every
aggregation and its backward; on an edge list (``aggregation="xla"``, the
pixelwise edge-list mesh among them) the segment-sum kernel (ops/segment_sum.py) carries the segment sums, as
it carries the pixel→node pooling, the node counts and the gathers'
backwards on every mesh that is not the grid. With
``use_climatology`` the decoder reads the day-of-year climatology of each
forecast day (``climatology=`` (366 or 365, rows, cols) on ``train``,
``predict``, ``score``, ``forecast`` and ``train_step``).
``model_kwargs["remat"]`` (default True, the JAX package's) is the model's
per-step remat while training (``models/seq2seq.py``),
``model_kwargs["fused_gates"]=False`` keeps the per-gate parameter layout
(``models/fused.py``), ``model_kwargs["rnn_type"]`` picks the cell and
``model_kwargs["dummy"]`` the JAX package's dummy mode. As the JAX
predictor does, MHTransformerConv rides the attention windows on
``aggregation="pallas"`` (TransformerConv's kernels), and GATConv or
GATv2Conv on ``aggregation="grid"`` falls back to ``"xla"`` (GAT needs
the edge list; its sums run on the segment-sum kernel).
``transform_func`` transforms the quadtree split criterion
(``graph/quadtree.py`` ``dist_from_05`` for the sea-ice quadtree). Dropout and scheduled sampling draw from the predictor's
``generator`` (a ``torch.Generator`` on its device, seeded from ``seed``),
never from torch's global RNG.

``train``, ``train_step``, ``forecast``, ``predict`` and ``score`` take
``high_interest_region`` (rows, cols) bool, which reaches every mesh
build, and ``graph_structure``, a preset mesh (``graph/static.py``, built
on the predictor's device with its ``n_max``/``e_max``) that replaces the
encoder's mesh for every sample, as the sea-ice experiments 9 and 10 run.
``remesh_input=True`` remeshes the encoder onto each input frame, and
``model_kwargs["remesh_every"]`` spaces the decoder's remeshes
(``models/seq2seq.py``). ``debug=True`` (``ModelConfig.debug_nan``) logs
the encoder's and decoder's gradient norms each step and, when a step's
loss comes back non-finite, replays its forward with the NaN checks on
before the update, from the step's generator state, so the error names
the module and decoder step that first went non-finite; it reads the loss
on the host every step, and without it ``train_step`` syncs nothing.
``test_threshold`` draws the mesh a threshold gives.

``shared_mesh`` (explicit argument, else ``train_config.shared_mesh``,
else off, as the JAX predictor resolves it) trains every batch on one mesh
a step, built from the max of the criterion over the batch, with one
scheduled-sampling coin a step for the batch (``models/seq2seq.py``);
``forecast``, ``predict`` and ``score`` stay per-sample. The loss is the
same mean over samples. ``graph_kwargs`` take every ``GraphConfig`` field
of the JAX package (``grid_attn``, ``message_dtype``, ``max_degree``,
``adjacency="csum"`` among them).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from quadtree_mpnnlstm_tpu_torch.config import NEG_INF, GraphConfig, ModelConfig, TrainConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.graph.state import unflatten
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import Seq2Seq
from quadtree_mpnnlstm_tpu_torch.train.losses import LOSSES
from quadtree_mpnnlstm_tpu_torch.train.metrics import MetricsLogger
from quadtree_mpnnlstm_tpu_torch.utils.dates import day_of_year
from quadtree_mpnnlstm_tpu_torch.utils.params import get_n_params
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding
from quadtree_mpnnlstm_tpu_torch.utils.weights import init_params, params_from_jax

CLIP_NORM = 10.0
LR_DECAY_EVERY_EPOCHS = 3


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by ``max_norm/‖g‖`` when their global
    norm ``‖g‖`` reaches ``max_norm``, as ``optax.clip_by_global_norm``
    (``torch.nn.utils.clip_grad_norm_`` divides by ``‖g‖ + 1e-6`` instead).
    Returns ``‖g‖`` as a device tensor; nothing syncs with the host."""
    norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class NextFramePredictorS2S:
    """Seq2Seq forecaster over quadtree meshes."""

    def __init__(
        self,
        image_shape,
        thresh: float,
        experiment_name: str = "experiment",
        decompose: bool = True,
        input_features: int = 1,
        input_timesteps: int = 3,
        output_timesteps: int = 3,
        device: str = "cuda",
        condition: str = "max_larger_than",
        binary: bool = False,
        transform_func=None,
        remesh_input: bool = False,
        debug: bool = False,
        teacher_forcing_ratio: float = 0.0,
        use_climatology: bool = False,
        seed: Optional[int] = None,
        model_kwargs: Optional[Dict[str, Any]] = None,
        graph_kwargs: Optional[Dict[str, Any]] = None,
        train_config: Optional[TrainConfig] = None,
        run_dir: str = "runs",
        tensorboard: bool = False,
        shared_mesh: Optional[bool] = None,
    ):
        self.experiment_name = experiment_name
        self.thresh = thresh if decompose else NEG_INF
        self.binary = binary
        self.debug = debug
        self.transform_func = transform_func
        self.output_timesteps = output_timesteps
        self.teacher_forcing_ratio = teacher_forcing_ratio
        self.use_climatology = use_climatology
        self.train_config = train_config
        self.run_dir = run_dir  # metrics: <run_dir>/<experiment_name>_<time>/
        self.tensorboard = tensorboard
        self.device = torch.device(device)
        if seed is None:  # explicit seed > train_config.seed > 21
            seed = train_config.seed if train_config is not None else 21
        if shared_mesh is None:  # explicit > train_config.shared_mesh > off
            shared_mesh = bool(train_config.shared_mesh) if train_config is not None else False
        self.shared_mesh = shared_mesh

        mk = dict(model_kwargs or {})
        self.cfg = ModelConfig(
            hidden_size=mk.pop("hidden_size", 32),
            dropout=mk.pop("dropout", 0.1),
            input_features=input_features,
            input_timesteps=input_timesteps,
            output_timesteps=output_timesteps,
            n_layers=mk.pop("n_layers", 4),
            n_conv_layers=mk.pop("n_conv_layers", 2),
            convolution_type=mk.pop("convolution_type", "ChebConv"),
            rnn_type=mk.pop("rnn_type", "LSTM"),
            binary=binary,
            dummy=mk.pop("dummy", False),
            remesh_input=remesh_input,
            remesh_every=mk.pop("remesh_every", 1),
            fused_gates=mk.pop("fused_gates", True),
            debug_nan=mk.pop("debug_nan", debug),
            compute_dtype=mk.pop(
                "compute_dtype", train_config.dtype if train_config is not None else "float32"),
        )
        # per-step remat of the training rollout (models/seq2seq.py), the
        # JAX package's default: full
        remat = mk.pop("remat", True)
        if mk:
            raise TypeError(f"unknown model_kwargs: {sorted(mk)}")

        gk = dict(graph_kwargs or {})
        carry_edges_explicit = "carry_edges" in gk
        self.gcfg = GraphConfig(
            image_shape=tuple(image_shape),
            max_grid_size=gk.pop("max_grid_size", 64),
            thresh=self.thresh,
            condition=condition,
            use_edge_attrs=self.cfg.uses_edge_attrs,
            **gk,
        )
        if (self.gcfg.aggregation == "grid"
                and self.cfg.convolution_type in ("GATConv", "GATv2Conv")):
            # GAT needs an edge-list mesh (self-loop insertion): the JAX
            # predictor's fallback
            print(f"{self.cfg.convolution_type} is unsupported on the dense grid stencil "
                  "backend; falling back to aggregation='xla'")
            self.gcfg = self.gcfg.replace(aggregation="xla")
        attention = ("TransformerConv", "MHTransformerConv")
        if self.gcfg.aggregation == "pallas" and self.cfg.convolution_type in attention:
            # attention convs ride the attention windows (ops/attn.py), not
            # the GCN/Cheb Â blocks
            self.gcfg = self.gcfg.replace(attn_windows=True)
        if (not carry_edges_explicit and self.gcfg.aggregation == "pallas"
                and self.gcfg.max_degree == 0
                and self.cfg.convolution_type in ("GCNConv", "ChebConv") + attention):
            # aggregation rides the Â blocks or attention windows; the edge
            # list is dead weight (the JAX predictor's list of such convs)
            self.gcfg = self.gcfg.replace(carry_edges=False)
        # aggregation="grid" (the pixelwise mesh) builds no edge list and no
        # windows: the stencil reads the identity-mapped node planes;
        # aggregation="xla" keeps the edge list (carry_edges)

        self.model = Seq2Seq(self.cfg, self.gcfg, use_climatology, remat=remat,
                             transform_func=transform_func).to(self.device).eval()
        # the NaN checks run only in the debug replay of a non-finite step
        self.model.check_finite = False
        init_params(self.model, torch.Generator().manual_seed(seed))
        # dropout masks and scheduled-sampling coins of train()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # worst capacity overflow of the last predict() (0 = nothing dropped)
        self.last_overflow = 0
        self.training_initiated = False
        self.train_loss: list = []
        self.test_loss: list = []
        self.loss = None  # {"train_loss", "test_loss"} after train()

    def load_jax_params(self, tree) -> None:
        """Load a flax parameter tree (numpy leaves) of the JAX package; a
        per-gate tree loads into a fused model stacked into its layout."""
        self.model.load_state_dict(params_from_jax(tree, fuse_gates=self.cfg.fused_gates))

    def get_n_params(self) -> int:
        return get_n_params(self.model)

    # ---------------------------------------------------------------- training

    def initiate_training(self, lr: float, lr_decay: float) -> None:
        """Adam (β 0.9/0.999, ε 1e-8) over the model's parameters, the loss
        (BCE for binary targets, else MSE) and the metrics writer."""
        self.loss_func_name = "BCE" if self.binary else "MSE"
        self.loss_func = LOSSES[self.loss_func_name]
        self._base_lr = lr
        self._lr_decay = lr_decay
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.writer = MetricsLogger(self.run_dir, self.experiment_name, self.tensorboard)
        self.train_loss, self.test_loss = [], []
        self._epoch = 0
        self.training_initiated = True

    def _current_lr(self) -> float:
        # StepLR: lr · γ^(epoch // 3)
        return self._base_lr * (self._lr_decay ** (self._epoch // LR_DECAY_EVERY_EPOCHS))

    def _set_lr(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self._current_lr()

    def _chunks(self, truncated_backprop: int):
        """(t0, n) decoder chunks: one for full BPTT, else chunks of
        ``truncated_backprop`` steps."""
        t = self.output_timesteps
        if truncated_backprop <= 0 or truncated_backprop >= t:
            return [(0, t)]
        out, t0 = [], 0
        while t0 < t:
            out.append((t0, min(truncated_backprop, t - t0)))
            t0 += out[-1][1]
        return out

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _mask(self, mask) -> Optional[torch.Tensor]:
        return None if mask is None else self._tensor(mask, torch.bool)

    def _clim_batch(self, climatology, launch_dates) -> Optional[np.ndarray]:
        """(B, T_out, rows, cols, 1) day-of-year normals of the forecast
        days of each launch date; zeros without a climatology, and None
        when the model reads none."""
        if not self.use_climatology:
            return None
        rows, cols = self.gcfg.image_shape
        b = len(launch_dates)
        if climatology is None:
            return np.zeros((b, self.output_timesteps, rows, cols, 1), np.float32)
        clim = np.asarray(climatology)
        if clim.ndim == 4:  # (1, 365, rows, cols)
            clim = clim[0]
        out = np.empty((b, self.output_timesteps, rows, cols, 1), np.float32)
        for i, ld in enumerate(np.asarray(launch_dates).reshape(-1)):
            doys = [day_of_year(int(ld), t) for t in range(self.output_timesteps)]
            out[i, ..., 0] = clim[doys]
        return out

    def _clim(self, clim) -> Optional[torch.Tensor]:
        """The batch's normals on the device, when the model reads them."""
        return self._tensor(clim) if self.use_climatology and clim is not None else None

    def _chunk_losses(self, model, x, y, m, clim, gen, truncated_backprop, hir, gs):
        """Yield (loss, final state) of each decoder chunk of a batch: one
        for full BPTT, else one a chunk of ``truncated_backprop`` steps,
        each re-encoding the inputs and decoding its steps from the encoder
        state, with its global step index ``t0``."""
        for t0, n in self._chunks(truncated_backprop):
            y_c = y[:, t0:t0 + n]
            state = model.encode(x, mask=m, generator=gen, high_interest_region=hir,
                                 graph_structure=gs, shared_mesh=self.shared_mesh)
            state, y_hat, _ = model.decode(state, n, y=y_c, mask=m,
                                           teacher_forcing_ratio=self.teacher_forcing_ratio,
                                           generator=gen,
                                           climatology=None if clim is None
                                           else clim[:, t0:t0 + n],
                                           t0=t0, high_interest_region=hir)
            yield self.loss_func(y_hat, y_c, m).mean(), state

    def train_step(self, x, y, mask=None, generator: Optional[torch.Generator] = None,
                   truncated_backprop: int = 0, climatology=None, high_interest_region=None,
                   graph_structure=None):
        """One forward, backward and clipped Adam update on a batch x
        (B, T_in, rows, cols, C), y (B, T_out, rows, cols, 1);
        ``climatology`` is the batch's (B, T_out, rows, cols, 1) normals
        (``_clim_batch``), read when the model uses them;
        ``high_interest_region`` and ``graph_structure`` as in ``train``.
        With ``shared_mesh`` the batch rides one mesh a step.

        With truncated BPTT every chunk re-encodes the inputs and decodes
        its own steps from the encoder state; the loss is the sum of the
        chunk means, and each chunk's backward runs as soon as its loss is
        known, so a chunk's activations are freed before the next chunk
        runs (the JAX package rematerialises each chunk for that). Under
        the model's per-step remat each step of a chunk is checkpointed.
        Returns (loss, mesh overflow) as device tensors, with no host
        sync unless the predictor was built with ``debug``. ``generator``
        defaults to the predictor's own."""
        if not self.training_initiated:
            raise RuntimeError("call initiate_training() before train_step()")
        model = self.model.train()
        gen = self.generator if generator is None else generator
        start = gen.get_state() if self.debug else None
        x, y, m = self._tensor(x), self._tensor(y), self._mask(mask)
        hir = self._mask(high_interest_region)
        clim = self._clim(climatology)
        self.optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=self.device)
        overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        rest = (truncated_backprop, hir, graph_structure)
        for loss, state in self._chunk_losses(model, x, y, m, clim, gen, *rest):
            loss.backward()
            total = total + loss.detach()
            overflow = torch.maximum(overflow, state.graph.overflow.max())
        if self.debug:
            # the encoder's and decoder's gradient norms before the clip
            self.last_grad_norms = {
                side: sum((p.grad.float().square().sum() for name, p in model.named_parameters()
                           if name.startswith(side + ".") and p.grad is not None),
                          torch.zeros((), device=self.device)).sqrt()
                for side in ("encoder", "decoder")}
            if not bool(torch.isfinite(total)):
                self._localise_nan(model, start, x, y, m, clim, *rest)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        # the global norm before the clip, a device tensor
        self.last_grad_norm = clip_by_global_norm_(grads, CLIP_NORM)
        self.optimizer.step()
        return total, overflow

    @torch.no_grad()
    def _localise_nan(self, model, gen_state, x, y, m, clim, truncated_backprop, hir, gs):
        """``debug``: replay a step whose loss was non-finite, forward only,
        from the generator state it started from (so it draws the same
        masks and coins) with the model's NaN checks on; the first check
        that fails raises, naming its module and step. The weights are the
        step's own: the update has not run."""
        gen = torch.Generator(device=self.device)
        gen.set_state(gen_state)
        model.check_finite = True
        try:
            for _ in self._chunk_losses(model, x, y, m, clim, gen, truncated_backprop, hir, gs):
                pass
        finally:
            model.check_finite = False
        raise ValueError("non-finite loss but all forward checks passed across 1 shard "
                         "replay(s) — the NaN arose in the backward pass or the optimizer "
                         "update")

    @torch.no_grad()
    def _eval_loss(self, x, y, mask, climatology=None, **mesh) -> torch.Tensor:
        y_hat, _, _ = self.forecast(x, mask=mask, climatology=climatology, **mesh)
        return self.loss_func(y_hat, self._tensor(y), self._mask(mask)).mean()

    def _drain_step_metrics(self, pending, running: float, epoch_overflow: int):
        """Fetch and log one train step's device scalars (with ``debug``
        the encoder's and decoder's gradient norms); called one step late
        so that the fetch waits on a step the device has finished while
        the next one is already queued."""
        loss_d, overflow_d, step_idx, grad_norms = pending
        loss = float(loss_d)
        self.writer.scalar("Loss/train", loss, step_idx)
        for side, norm in (grad_norms or {}).items():
            self.writer.scalar(f"Grad/{side}/grad_norms", float(norm), step_idx)
        return running + loss, max(epoch_overflow, int(overflow_d))

    def train(
        self,
        loader_train,
        loader_test,
        climatology=None,
        n_epochs: Optional[int] = None,
        lr: Optional[float] = None,
        lr_decay: Optional[float] = None,
        mask=None,
        high_interest_region=None,
        truncated_backprop: Optional[int] = None,
        graph_structure=None,
        divergence_threshold: float = 4.0,
    ) -> None:
        """Train for ``n_epochs`` over ``loader_train`` and score each epoch
        on ``loader_test`` (both yield (x, y, launch_date) numpy triplets);
        ``climatology`` (366 or 365, rows, cols) gives the decoder its
        normals by launch date when the model uses them;
        ``high_interest_region`` (rows, cols) bool always splits its cells
        in every mesh; ``graph_structure`` is a preset mesh
        (``graph/static.py``) for every sample.
        Optimisation arguments default to the constructor's
        ``train_config``, else to 200 epochs, lr 0.01, γ 0.95 and full BPTT.
        Raises ``ValueError("NaN loss :(")`` on a NaN test loss and
        ``ValueError("Diverged :(")`` when it exceeds
        ``divergence_threshold``."""
        tc = self.train_config or TrainConfig(n_epochs=200)
        n_epochs = tc.n_epochs if n_epochs is None else n_epochs
        lr = tc.lr if lr is None else lr
        lr_decay = tc.lr_decay if lr_decay is None else lr_decay
        if truncated_backprop is None:
            truncated_backprop = tc.truncated_backprop
        if mask is not None and tuple(np.asarray(mask).shape) != tuple(self.gcfg.image_shape):
            raise ValueError(f"Mask and image shapes do not match. Got {np.asarray(mask).shape} "
                             f"and {self.gcfg.image_shape}")
        if not self.training_initiated:
            self.initiate_training(lr, lr_decay)

        mesh = dict(high_interest_region=high_interest_region, graph_structure=graph_structure)
        st = time.time()
        batch_step = 0
        for epoch in range(n_epochs):
            self._set_lr()
            running, steps, epoch_overflow = 0.0, 0, 0
            pending = None
            for x, y, launch in loader_train:
                loss, overflow = self.train_step(
                    x, y, mask=mask, truncated_backprop=truncated_backprop,
                    climatology=self._clim_batch(climatology, launch), **mesh)
                if pending is not None:
                    running, epoch_overflow = self._drain_step_metrics(
                        pending, running, epoch_overflow)
                    steps += 1
                pending = (loss, overflow, batch_step,
                           self.last_grad_norms if self.debug else None)
                batch_step += 1
            if pending is not None:
                running, epoch_overflow = self._drain_step_metrics(
                    pending, running, epoch_overflow)
                steps += 1

            running_test, steps_test = 0.0, 0
            pending_test = None
            for x, y, launch in loader_test:
                loss = self._eval_loss(x, y, mask, self._clim_batch(climatology, launch), **mesh)
                if pending_test is not None:
                    running_test += float(pending_test)
                    steps_test += 1
                pending_test = loss
            if pending_test is not None:
                running_test += float(pending_test)
                steps_test += 1

            running /= max(steps, 1)
            running_test /= max(steps_test, 1)
            if np.isnan(running_test):
                raise ValueError("NaN loss :(")
            if running_test > divergence_threshold:
                raise ValueError("Diverged :(")

            self.writer.scalar("Loss/test", running_test, epoch)
            self.writer.scalar("Mesh/overflow_max", epoch_overflow, epoch)
            if epoch_overflow > 0:
                print(f"WARNING: mesh capacity overflow ({epoch_overflow} dropped slots at the "
                      "worst step) — raise n_max/e_max/agg_* (GraphConfig)")
            self._epoch += 1
            self.train_loss.append(running)
            self.test_loss.append(running_test)
            print(
                f"{self.experiment_name} | Epoch {epoch} train {self.loss_func_name}: "
                f"{running:.4f}, test {self.loss_func_name}: {running_test:.4f}, "
                f"lr: {self._current_lr():.4f}, "
                f"time_per_epoch: {(time.time() - st) / (epoch + 1):.1f}"
            )

        print(f"Finished in {(time.time() - st) / 60} minutes")
        self.writer.flush()
        self.loss = {"train_loss": list(self.train_loss), "test_loss": list(self.test_loss)}

    # ---------------------------------------------------------------- predict

    @torch.no_grad()
    def forecast(self, x, mask=None, climatology=None, high_interest_region=None,
                 graph_structure=None):
        """One batch in eval mode: x (B, T_in, rows, cols, C) array or
        tensor, ``climatology`` the batch's (B, T_out, rows, cols, 1)
        normals (``_clim_batch``), ``high_interest_region`` and
        ``graph_structure`` as in ``train`` → (y_hat (B, T_out, rows, cols,
        1) tensor, overflow (B,), per-step pixel_node maps (T_out, B, P))."""
        y_hat, state, meshes = self.model.eval().rollout(
            self._tensor(x), mask=self._mask(mask), climatology=self._clim(climatology),
            high_interest_region=self._mask(high_interest_region),
            graph_structure=graph_structure)
        return y_hat, state.graph.overflow, meshes

    def predict(self, loader, climatology=None, mask=None, high_interest_region=None,
                graph_structure=None) -> np.ndarray:
        """→ (N, T_out, rows, cols, 1) for every batch of ``loader``, which
        yields (x, y, launch_date) numpy triplets; ``climatology`` (366 or
        365, rows, cols), ``high_interest_region`` and ``graph_structure``
        as in ``train``."""
        outs, worst = [], 0
        for x, _y, launch in loader:
            y_hat, overflow, _ = self.forecast(
                x, mask=mask, climatology=self._clim_batch(climatology, launch),
                high_interest_region=high_interest_region, graph_structure=graph_structure)
            outs.append(y_hat.cpu().numpy())
            worst = max(worst, int(overflow.max()))
        self.last_overflow = worst
        if worst > 0:
            print(
                f"WARNING: mesh capacity overflow ({worst} dropped slots at the "
                "worst step) — raise n_max/e_max/agg_* (GraphConfig)"
            )
        return np.concatenate(outs, axis=0)

    def score(self, loader, climatology=None, mask=None, **kw) -> Dict[str, float]:
        """Masked MSE and RMSE of ``predict`` over a loader (``kw``:
        ``high_interest_region``, ``graph_structure``)."""
        y_hat = self.predict(loader, climatology=climatology, mask=mask, **kw)
        y = np.concatenate([y for _, y, _ in loader], axis=0)
        if mask is not None:
            diff = (y_hat - y)[:, :, ~np.asarray(mask, bool)]
        else:
            diff = y_hat - y
        mse = float(np.mean(diff**2))
        return {"MSE": mse, "RMSE": float(np.sqrt(mse))}

    # ------------------------------------------------------------ persistence

    def _path(self, directory: str, suffix: str) -> str:
        os.makedirs(directory, exist_ok=True)
        return os.path.join(directory, f"{self.experiment_name}{suffix}")

    def save(self, directory: str) -> str:
        """Weights only, ``<directory>/<experiment_name>.pt``."""
        path = self._path(directory, ".pt")
        torch.save(self.model.state_dict(), path)
        return path

    def load(self, directory: str) -> None:
        state = torch.load(self._path(directory, ".pt"), map_location=self.device,
                           weights_only=True)
        self.model.load_state_dict(state)

    def save_checkpoint(self, directory: str) -> str:
        """Resume state: weights, optimizer state and epoch,
        ``<directory>/<experiment_name>_ckpt.pt``."""
        path = self._path(directory, "_ckpt.pt")
        torch.save({"model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "epoch": self._epoch}, path)
        return path

    def restore_checkpoint(self, directory: str, lr: float = 0.01, lr_decay: float = 0.95) -> None:
        if not self.training_initiated:
            self.initiate_training(lr, lr_decay)
        state = torch.load(self._path(directory, "_ckpt.pt"), map_location=self.device,
                           weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self._epoch = int(state["epoch"])

    # ------------------------------------------------------------ diagnostics

    @torch.no_grad()
    def test_threshold(self, x, thresh, mask=None, high_interest_region=None, contours=True):
        """The mesh a split threshold gives: one graph built at ``thresh``
        from x (T, rows, cols, C) (criterion: channel 0, max over T), each
        frame painted back through it. Returns (fig, axes), one panel a
        frame with the cells' outlines, when matplotlib is there, else
        (reconstruction (T, rows, cols, 1), labels (rows, cols): each
        pixel's node, −1 where masked) as numpy arrays. The grid backend
        builds only the pixelwise mesh, so a quadtree threshold takes the
        edge list (``"xla"``), as the JAX package does."""
        x = self._tensor(x)
        shape = self.gcfg.image_shape
        kw = dict(thresh=float(thresh))
        if self.gcfg.aggregation == "grid" and float(thresh) != NEG_INF:
            kw.update(aggregation="xla", attn_windows=False)
        gcfg = self.gcfg.replace(**kw)
        graph, data = image_to_graph(add_positional_encoding(x)[None], gcfg,
                                     mask=self._mask(mask),
                                     high_interest_region=self._mask(high_interest_region),
                                     transform_func=self.transform_func)
        recon = torch.cat([unflatten(data[:, t, :, :1], graph, shape)
                           for t in range(x.shape[0])]).cpu().numpy()
        labels = graph.pixel_node[0].reshape(shape).cpu().numpy()
        labels = np.where(labels >= gcfg.n_max, -1, labels)
        num_nodes = int(graph.n_nodes[0])
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return recon, labels
        from quadtree_mpnnlstm_tpu_torch.eval.plotting import plot_contours

        n_sample = x.shape[0]
        fig, axs = plt.subplots(1, n_sample, figsize=(5 * n_sample, 4), squeeze=False)
        axs = axs[0]
        for i in range(n_sample):
            axs[i].imshow(recon[i, ..., 0])
            if contours:
                plot_contours(axs[i], labels)
        fig.suptitle(f"Threshold: {thresh} | Num. nodes: {num_nodes}")
        return fig, axs

