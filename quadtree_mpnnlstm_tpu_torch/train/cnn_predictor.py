"""Trainer and forecaster of the dense CNN-LSTM baseline:
``NextFramePredictorCNNLSTM``.

Counterpart of ``quadtree_mpnnlstm_tpu/train/cnn_predictor.py``, with the
graph predictor's surface (``train``, ``predict``, ``score``, ``save``,
``load``): Adam after a global-norm clip at 10, a learning rate of
``lr · lr_decay^(epoch // 3)`` set at each epoch, the masked MSE (the
clipped BCE with ``binary``) over the unmasked pixels of the batch,
scheduled sampling (``teacher_forcing_ratio``, 0.5 by default) while
training, and each step's loss fetched one step late. The BatchNorm
running statistics are buffers of the model, moved by every training
forward. Runs on ``device="cuda"`` unless the caller passes ``"cpu"``;
``compute_dtype="bfloat16"`` computes in bf16 with float32 masters.
Dropout masks and coins draw from the predictor's ``torch.Generator``,
seeded by ``seed``. On a card every forward and backward runs under
cuDNN's deterministic settings (no algorithm that sums with atomics), so
a step is bit-identical when repeated from the same state.

The JAX trainer fails with flax's ``ScopeParamShapeError`` at its own
defaults' ``input_features=4`` and with ``use_climatology=True``
(``quadtree_mpnnlstm_tpu/models/cnnlstm.py:197-207``,
``train/cnn_predictor.py:86-93``); the port raises a ``ValueError`` that
names the combination when it is built with either.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from quadtree_mpnnlstm_tpu_torch.models.cells import deterministic_cudnn
from quadtree_mpnnlstm_tpu_torch.models.cnnlstm import CNNLSTMSeq2Seq
from quadtree_mpnnlstm_tpu_torch.train.losses import LOSSES, masked_mse
from quadtree_mpnnlstm_tpu_torch.train.metrics import MetricsLogger
from quadtree_mpnnlstm_tpu_torch.train.predictor import (
    CLIP_NORM,
    LR_DECAY_EVERY_EPOCHS,
    clip_by_global_norm_,
)
from quadtree_mpnnlstm_tpu_torch.utils.params import get_n_params
from quadtree_mpnnlstm_tpu_torch.utils.weights import (
    cnnlstm_state_dict_from_jax,
    init_params,
)

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class NextFramePredictorCNNLSTM:
    def __init__(
        self,
        image_shape,
        experiment_name: str = "experiment",
        input_features: int = 4,
        hidden_size: int = 32,
        input_timesteps: int = 10,
        output_timesteps: int = 90,
        n_layers: int = 2,
        dropout: float = 0.1,
        kernel_size: int = 3,
        binary: bool = False,
        debug: bool = False,
        device: str = "cuda",
        use_climatology: bool = False,
        teacher_forcing_ratio: float = 0.5,
        seed: int = 21,
        compute_dtype: str = "float32",
        run_dir: str = "runs",
    ):
        if use_climatology:
            raise ValueError(
                "NextFramePredictorCNNLSTM with use_climatology=True: the JAX package's "
                "trainer initialises the decoder LSTM without the climatology channel and "
                "then feeds it hidden + 1 features, so its train and predict raise flax's "
                "ScopeParamShapeError on /decoder_lstm/scan(lstm0) "
                "(quadtree_mpnnlstm_tpu/train/cnn_predictor.py:86-93, "
                "models/cnnlstm.py:205-207); only use_climatology=False runs")
        self.experiment_name = experiment_name
        self.image_shape = tuple(image_shape)
        self.input_features = input_features
        self.input_timesteps = input_timesteps
        self.output_timesteps = output_timesteps
        self.binary = binary
        self.debug = debug
        self.use_climatology = use_climatology
        self.run_dir = run_dir  # metrics: <run_dir>/<experiment_name>_<time>/
        self.device = torch.device(device)
        self.model = CNNLSTMSeq2Seq(
            input_features=input_features, hidden_size=hidden_size, output_features=1,
            input_timesteps=input_timesteps, output_timesteps=output_timesteps,
            n_layers=n_layers, dropout=dropout, kernel_size=kernel_size, binary=binary,
            teacher_forcing_ratio=teacher_forcing_ratio, dtype=DTYPES[compute_dtype],
        ).to(self.device).eval()
        init_params(self.model, torch.Generator().manual_seed(seed))
        # dropout masks and scheduled-sampling coins of train()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.training_initiated = False
        self.train_loss: list = []
        self.test_loss: list = []
        self.loss = None  # {"train_loss", "test_loss"} after train()

    def load_jax_params(self, variables) -> None:
        """Load the JAX model's flax variables (``params`` and
        ``batch_stats``, numpy leaves)."""
        self.model.load_state_dict(cnnlstm_state_dict_from_jax(variables))

    def get_n_params(self) -> int:
        return get_n_params(self.model)

    # ---------------------------------------------------------------- training

    def initiate_training(self, lr: float, lr_decay: float) -> None:
        """Adam (β 0.9/0.999, ε 1e-8), the loss (BCE for binary targets,
        else MSE) and the metrics writer."""
        self.loss_func_name = "BCE" if self.binary else "MSE"
        self.loss_func = LOSSES[self.loss_func_name]
        self._base_lr = lr
        self._lr_decay = lr_decay
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.writer = MetricsLogger(self.run_dir, self.experiment_name)
        self._epoch = 0
        self.train_loss, self.test_loss = [], []
        self.training_initiated = True

    def _current_lr(self) -> float:
        return self._base_lr * (self._lr_decay ** (self._epoch // LR_DECAY_EVERY_EPOCHS))

    def _set_lr(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self._current_lr()

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _mask(self, mask) -> torch.Tensor:
        if mask is None:
            return torch.zeros(self.image_shape, dtype=torch.bool, device=self.device)
        return self._tensor(mask, torch.bool)

    def train_step(self, x, y, mask=None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One forward (training mode, scheduled sampling on ``y``),
        backward and clipped Adam update on a batch x (B, T_in, rows, cols,
        C), y (B, T_out, rows, cols, 1) (arrays or tensors); returns the
        loss as a device tensor, with no host sync. ``generator`` defaults
        to the predictor's own."""
        if not self.training_initiated:
            raise RuntimeError("call initiate_training() before train_step()")
        model = self.model.train()
        gen = self.generator if generator is None else generator
        x, y, m = self._tensor(x), self._tensor(y), self._mask(mask)
        self.optimizer.zero_grad(set_to_none=True)
        with deterministic_cudnn():
            y_hat = model(x, y, None, m, gen)
            loss = self.loss_func(y_hat, y, m).mean()
            loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        self.last_grad_norm = clip_by_global_norm_(grads, CLIP_NORM)
        self.optimizer.step()
        return loss.detach()

    def train(
        self,
        loader_train,
        loader_test,
        climatology=None,
        n_epochs: int = 200,
        lr: float = 0.01,
        lr_decay: float = 0.95,
        mask=None,
        high_interest_region=None,
        truncated_backprop: int = 0,
    ) -> None:
        """Train for ``n_epochs`` over ``loader_train`` and score each
        epoch's masked MSE on ``loader_test`` (both yield (x, y,
        launch_date) triplets). ``climatology``, ``high_interest_region``
        and ``truncated_backprop`` are accepted and not read, as in the
        JAX trainer (the model reads no climatology; full BPTT). Raises
        ``ValueError("NaN loss :(")`` on a NaN test loss."""
        if not self.training_initiated:
            self.initiate_training(lr, lr_decay)
        st = time.time()
        batch_step = 0
        for epoch in range(n_epochs):
            self._set_lr()
            running, steps = 0.0, 0
            pending = None  # the loss is fetched one step late
            for x, y, _launch in loader_train:
                loss = self.train_step(x, y, mask=mask)
                if pending is not None:
                    lv = float(pending[0])
                    self.writer.scalar("Loss/train", lv, pending[1])
                    running += lv
                    steps += 1
                pending = (loss, batch_step)
                batch_step += 1
            if pending is not None:
                lv = float(pending[0])
                self.writer.scalar("Loss/train", lv, pending[1])
                running += lv
                steps += 1

            running_test, steps_test = 0.0, 0
            pending_test = None
            for x, y, _launch in loader_test:
                _, loss = self._eval(x, y, mask)
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
            self.writer.scalar("Loss/test", running_test, epoch)
            self._epoch += 1
            self.train_loss.append(running)
            self.test_loss.append(running_test)
            print(f"{self.experiment_name} | Epoch {epoch} train {self.loss_func_name}: "
                  f"{running:.4f}, test {self.loss_func_name}: {running_test:.4f}, "
                  f"time_per_epoch: {(time.time() - st) / (epoch + 1):.1f}")
        print(f"Finished in {(time.time() - st) / 60} minutes")
        self.writer.flush()
        self.loss = {"train_loss": list(self.train_loss), "test_loss": list(self.test_loss)}

    # ---------------------------------------------------------------- predict

    def _eval(self, x, y, mask):
        """(y_hat, masked MSE) of one batch in eval mode."""
        y_hat = self.forecast(x, mask)
        return y_hat, masked_mse(y_hat, self._tensor(y), self._mask(mask)).mean()

    @torch.no_grad()
    def forecast(self, x, mask=None) -> torch.Tensor:
        """One batch x (B, T_in, rows, cols, C) in eval mode → y_hat
        (B, T_out, rows, cols, 1) float32 tensor on the device."""
        with deterministic_cudnn():
            return self.model.eval()(self._tensor(x), None, None, self._mask(mask))

    def predict(self, loader, climatology=None, mask=None, high_interest_region=None,
                graph_structure=None) -> np.ndarray:
        """→ (N, T_out, rows, cols, 1) for every batch of ``loader``;
        ``climatology``, ``high_interest_region`` and ``graph_structure``
        are accepted and not read, as in the JAX trainer."""
        return np.concatenate([self.forecast(x, mask).cpu().numpy() for x, _y, _ in loader],
                              axis=0)

    def score(self, loader, climatology=None, mask=None) -> Dict[str, float]:
        """MSE and RMSE of ``predict`` over the unmasked pixels."""
        y_hat = self.predict(loader, climatology=climatology, mask=mask)
        y = np.concatenate([y for _, y, _ in loader], axis=0)
        if mask is not None:
            diff = (y_hat - y)[:, :, ~np.asarray(mask, bool)]
        else:
            diff = y_hat - y
        mse = float(np.mean(diff**2))
        return {"MSE": mse, "RMSE": float(np.sqrt(mse))}

    # ------------------------------------------------------------ persistence

    def _path(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        return os.path.join(directory, f"{self.experiment_name}.pt")

    def save(self, directory: str) -> str:
        """Weights and BatchNorm running statistics,
        ``<directory>/<experiment_name>.pt``."""
        path = self._path(directory)
        torch.save(self.model.state_dict(), path)
        return path

    def load(self, directory: str) -> None:
        state = torch.load(self._path(directory), map_location=self.device, weights_only=True)
        self.model.load_state_dict(state)
