"""The dense CNN-LSTM baseline family: convolutions and position LSTMs,
no graph machinery.

Counterpart of ``quadtree_mpnnlstm_tpu/models/cnnlstm.py``:

* ``CNNEncoder``: 3 × (conv → BatchNorm → ReLU → dropout);
* ``CNNDecoder``: 2 × (conv → BatchNorm → ReLU → dropout), then an
  output conv;
* ``PositionLSTM``: LSTM layers over time with every spatial position of
  every sample a row of the batch (B·rows·cols rows, ``hidden`` features),
  each layer one ``torch.nn.LSTM`` in the flax ``OptimizedLSTMCell``'s
  layout (``models/cells.py`` ``flax_lstm``, cuDNN on a card);
* ``CNNLSTM``: one step, frames (T_in, B, rows, cols, C) time-major →
  the sigmoid of the decoder on the last LSTM output, (B, rows, cols, out);
* ``CNNLSTMSeq2Seq``: the encoder on every input frame, the encoder LSTM,
  then T_out autoregressive decoder steps, each feeding the previous
  prediction (or, while training with scheduled sampling, the previous
  true frame) back through the encoder and the decoder LSTM; (B, T_in,
  rows, cols, C) → (B, T_out, rows, cols, out) in float32, masked pixels
  0.

The JAX package computes all of it in XLA outside any Pallas kernel, so
the port's counterparts are ``torch.nn.functional.conv2d`` and the cuDNN
LSTM. Tensors are channels-last (B, rows, cols, C), as flax's NHWC; a
convolution sees them as NCHW views with channels-last strides, and its
weight is OIHW (``utils/weights.py`` maps flax's HWIO kernels). Padding is
flax's ``"SAME"``. ``dtype`` is the compute dtype (bf16 mixed precision:
float32 masters cast at use, float32 BatchNorm statistics, float32
predictions). Training mode (``module.train()``) draws dropout masks and
scheduled-sampling coins from the caller's ``torch.Generator``.

BatchNorm is flax's ``BatchNorm`` with running statistics
(:class:`RunningBatchNorm`): in training each call normalises by its batch's
statistics and moves the running ones, in call order, so the encoder's
T_in input frames and its T_out decoder frames chain one update after
another; in eval the running statistics normalise.

Two configurations fail in the JAX package with flax's
``ScopeParamShapeError``, and the port raises a ``ValueError`` on them
instead of inventing a behaviour:

* ``input_features != 1`` in ``CNNLSTMSeq2Seq``: the decoder sends its
  one-channel prediction back through the encoder built for C channels
  (``models/cnnlstm.py:197``, ``:204``);
* a climatology channel (``concat_layers``) on a decoder LSTM built
  without it, as the trainer builds it (``models/cnnlstm.py:205-207``,
  ``train/cnn_predictor.py:86-93``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from quadtree_mpnnlstm_tpu_torch.models.cells import flax_lstm, run_lstm
from quadtree_mpnnlstm_tpu_torch.models.mpnnlstm import BatchNorm
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import dropout


class RunningBatchNorm(BatchNorm):
    """flax ``BatchNorm`` over every axis but the last, with running
    statistics ``mean`` (from 0) and ``var`` (from 1), momentum 0.99 and
    eps 1e-5. Training: the batch's mean and fast variance E[x²] − E[x]²
    (clipped at 0) in float32 normalise, and each call moves the running
    statistics to ``0.99·running + 0.01·batch`` with the biased batch
    variance. Eval: the running statistics normalise. The result is in
    x's dtype."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__(features, eps)
        self.momentum = momentum
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = (x.float() - self.mean) * (torch.rsqrt(self.var + self.eps) * self.weight)
            return (y + self.bias).to(x.dtype)
        rows = x.reshape(-1, x.shape[-1])
        xf = rows.float()
        mean = xf.mean(dim=0)
        var = ((xf * xf).mean(dim=0) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
            self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype).reshape(x.shape)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Conv(padding="SAME")`` on channels-last x (B, rows, cols, C)
    in ``dtype``: the weight and bias cast at use."""
    out = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dtype), conv.bias.to(dtype),
                   padding="same")
    return out.permute(0, 2, 3, 1)


class _ConvStack(nn.Module):
    """conv{i} → bn{i} → ReLU → dropout blocks, then an optional plain
    output conv."""

    def __init__(self, in_channels: int, hidden_size: int, blocks: int, out_channels: int,
                 kernel_size: int, dropout: float, dtype: Optional[torch.dtype]):
        super().__init__()
        self.dtype = torch.float32 if dtype is None else dtype
        self.dropout = dropout
        self.blocks = blocks
        for i in range(1, blocks + 1):
            self.add_module(f"conv{i}", nn.Conv2d(in_channels if i == 1 else hidden_size,
                                                  hidden_size, kernel_size))
            self.add_module(f"bn{i}", RunningBatchNorm(hidden_size))
        if out_channels:
            self.add_module(f"conv{blocks + 1}", nn.Conv2d(hidden_size, out_channels,
                                                           kernel_size))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(1, self.blocks + 1):
            x = conv_nhwc(getattr(self, f"conv{i}"), x, self.dtype)
            x = torch.relu(getattr(self, f"bn{i}")(x))
            x = dropout(x, self.dropout, self.training, generator)
        out = getattr(self, f"conv{self.blocks + 1}", None)
        return x if out is None else conv_nhwc(out, x, self.dtype)


class CNNEncoder(_ConvStack):
    """3 × (conv → BatchNorm → ReLU → dropout): (B, rows, cols, C) →
    (B, rows, cols, hidden)."""

    def __init__(self, in_channels: int, hidden_size: int, kernel_size: int = 3,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, hidden_size, 3, 0, kernel_size, dropout, dtype)


class CNNDecoder(_ConvStack):
    """2 × (conv → BatchNorm → ReLU → dropout) and the output conv:
    (B, rows, cols, hidden) → (B, rows, cols, output_channels)."""

    def __init__(self, hidden_size: int, output_channels: int = 1, kernel_size: int = 3,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__(hidden_size, hidden_size, 2, output_channels, kernel_size, dropout,
                         dtype)


class PositionLSTM(nn.Module):
    """``n_layers`` LSTM layers ``lstm{layer}`` over time, every spatial
    position a row: seq (T, N, F) → (outputs (T, N, hidden), (h, c) each
    (n_layers, N, hidden)); layer 0 takes ``input_size`` features
    (default ``hidden_size``). Without ``carry`` each layer starts from
    zeros, with it from its own (h, c)."""

    def __init__(self, hidden_size: int, n_layers: int, input_size: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.dtype = dtype
        for layer in range(n_layers):
            self.add_module(f"lstm{layer}", flax_lstm(
                hidden_size, batch_first=False,
                input_size=input_size if layer == 0 else None))

    def forward(self, seq: torch.Tensor, carry=None):
        dt = seq.dtype if self.dtype is None else self.dtype
        outs = seq.to(dt)
        hs, cs = [], []
        for layer in range(self.n_layers):
            if carry is None:
                h0 = outs.new_zeros((1, outs.shape[1], self.hidden_size))
                c0 = h0
            else:
                h0 = carry[0][layer][None].to(dt).contiguous()
                c0 = carry[1][layer][None].to(dt).contiguous()
            outs, (h_f, c_f) = run_lstm(getattr(self, f"lstm{layer}"), outs, (h0, c0), dt)
            hs.append(h_f[0])
            cs.append(c_f[0])
        return outs, (torch.stack(hs), torch.stack(cs))


class CNNLSTM(nn.Module):
    """Single-step CNN → LSTM → CNN model: x (T_in, B, rows, cols, C) →
    (B, rows, cols, output_features) in float32."""

    def __init__(self, input_features: int, hidden_size: int, output_features: int = 1,
                 n_layers: int = 2, dropout: float = 0.1, kernel_size: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.encoder = CNNEncoder(input_features, hidden_size, kernel_size, dropout, dtype)
        self.lstm = PositionLSTM(hidden_size, n_layers, dtype=dtype)
        self.decoder = CNNDecoder(hidden_size, output_features, kernel_size, dropout, dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        t_in, b, rows, cols, _ = x.shape
        feats = torch.stack([self.encoder(x[t], generator) for t in range(t_in)])
        outs, _ = self.lstm(feats.reshape(t_in, b * rows * cols, self.hidden_size))
        last = outs[-1].reshape(b, rows, cols, self.hidden_size)
        return torch.sigmoid(self.decoder(last, generator)).float()


class CNNLSTMSeq2Seq(nn.Module):
    """Dense seq2seq baseline. ``use_climatology`` builds the decoder LSTM
    for the one extra climatology channel (``concat_layers``), as flax
    builds it when the model is initialised with one; the trainer never
    does. ``teacher_forcing_ratio`` is the scheduled-sampling probability
    of a training forward given ``y``."""

    def __init__(self, input_features: int, hidden_size: int, output_features: int = 1,
                 input_timesteps: int = 10, output_timesteps: int = 90, n_layers: int = 2,
                 dropout: float = 0.1, kernel_size: int = 3, binary: bool = False,
                 teacher_forcing_ratio: float = 0.5, dtype: Optional[torch.dtype] = None,
                 use_climatology: bool = False):
        super().__init__()
        if input_features != 1:
            raise ValueError(
                f"CNNLSTMSeq2Seq with input_features={input_features}: the decoder feeds its "
                "one-channel prediction back through the encoder built for "
                f"{input_features} channels, and the JAX package's model raises flax's "
                "ScopeParamShapeError on /encoder/conv1 for this combination "
                "(quadtree_mpnnlstm_tpu/models/cnnlstm.py:197, :204); only "
                "input_features=1 runs")
        self.hidden_size = hidden_size
        self.output_timesteps = output_timesteps
        self.binary = binary
        self.teacher_forcing_ratio = teacher_forcing_ratio
        self.use_climatology = use_climatology
        self.encoder = CNNEncoder(input_features, hidden_size, kernel_size, dropout, dtype)
        self.encoder_lstm = PositionLSTM(hidden_size, n_layers, dtype=dtype)
        self.decoder_lstm = PositionLSTM(hidden_size, n_layers,
                                         hidden_size + int(use_climatology), dtype=dtype)
        self.decoder = CNNDecoder(hidden_size, output_features, kernel_size, dropout, dtype)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                concat_layers: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T_in, rows, cols, C), y (B, T_out, rows, cols, 1) for
        scheduled sampling, ``concat_layers`` (B, T_out, rows, cols, 1)
        climatology, ``mask`` (rows, cols) bool (True = invalid) →
        (B, T_out, rows, cols, out) float32."""
        if (concat_layers is not None) != self.use_climatology:
            raise ValueError(
                f"CNNLSTMSeq2Seq built with use_climatology={self.use_climatology} was given "
                f"{'a' if concat_layers is not None else 'no'} climatology channel "
                "(concat_layers): its decoder LSTM takes "
                f"{self.hidden_size + int(self.use_climatology)} features, and the JAX "
                "package's model raises flax's ScopeParamShapeError on "
                "/decoder_lstm/scan(lstm0) for this combination "
                "(quadtree_mpnnlstm_tpu/models/cnnlstm.py:205-207, "
                "train/cnn_predictor.py:86-93)")
        b, t_in, rows, cols, _ = x.shape
        n_pos = b * rows * cols
        hid = self.hidden_size
        gen = generator
        feats = torch.stack([self.encoder(x[:, t], gen) for t in range(t_in)])
        _, (h, c) = self.encoder_lstm(feats.reshape(t_in, n_pos, hid))

        use_tf = self.training and y is not None and self.teacher_forcing_ratio > 0
        frame = x[:, -1, :, :, 0:1]  # the last input frame's value channel
        outputs = []
        for t in range(self.output_timesteps):
            if use_tf and t > 0:
                # one coin a step for the whole batch
                coin = torch.rand((), generator=gen, device=x.device) < self.teacher_forcing_ratio
                frame = torch.where(coin, y[:, t - 1, :, :, 0:1], frame)
            df = self.encoder(frame, gen).reshape(1, n_pos, hid)
            if concat_layers is not None:
                clim = concat_layers[:, t].reshape(1, n_pos, 1)
                df = torch.cat([df, clim.to(df.dtype)], dim=-1)
            outs, (h, c) = self.decoder_lstm(df, carry=(h, c))
            spatial = outs[0].reshape(b, rows, cols, hid)
            frame = torch.sigmoid(self.decoder(spatial, gen))
            outputs.append(frame)
        y_hat = torch.stack(outputs, dim=1)
        if mask is not None:
            y_hat = torch.where(mask.bool()[None, None, :, :, None], 0.0, y_hat)
        return y_hat.float()
