"""The non-seq2seq graph baselines: ``MPNNLSTM`` and ``MPNNLSTMI``.

Counterpart of ``quadtree_mpnnlstm_tpu/models/mpnnlstm.py``. Both take a
sample's node features over time, x (T, n_max, F), and one mesh (a graph
of batch 1), and return a per-node value (n_max, 1) in float32 through a
sigmoid. ``dtype`` is the compute dtype (bf16 mixed precision: float32
masters cast at use, float32 normalisation statistics, as the flax
modules' ``dtype``). Dropout draws from the caller's ``torch.Generator``
in training mode (``module.train()``) only.

* ``MPNNLSTM``: each frame through three GCN → ReLU → LayerNorm →
  dropout blocks, then 4 LSTM layers over time on all n_max rows (padding
  rows included), the last layer's final hidden state through a ReLU,
  the skip of the input value channel ``x[:, :, 0].T``, ``lin1`` → ReLU →
  ``lin2`` → dropout → sigmoid. The frames' GCN aggregations run as one
  Â·z over the frames side by side (Â acts on each column alone), so a
  block launches one aggregation for all T frames.
* ``MPNNLSTMI``: stacked GConvLSTMs unrolled over the frames, layer 0
  taking its own (H, C) (the JAX package's fix of the reference's
  ``C=hs[1]``), then ReLU, a BatchNorm without running statistics over
  all n_max rows (padding rows included), ``lin1`` → ReLU → ``lin2`` →
  dropout → sigmoid.

The LSTM is ``torch.nn.LSTM`` in the flax ``OptimizedLSTMCell``'s layout
(``models/cells.py`` ``flax_lstm``), as in the split cell.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.models.cells import GConvLSTM, flax_lstm, run_lstm
from quadtree_mpnnlstm_tpu_torch.models.conv import GCNConv, a_mul, dense
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import LayerNorm, dropout


class BatchNorm(nn.Module):
    """flax ``BatchNorm(use_running_average=False)`` over the rows of x
    (N, F): the statistics of the batch, with the fast variance E[x²] −
    E[x]² clipped at 0, in float32, the result in x's dtype. It keeps no
    running statistics."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=0)
        var = ((xf * xf).mean(dim=0) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


def _frames_gcn(conv: GCNConv, x: torch.Tensor, graph: GraphTensors) -> torch.Tensor:
    """``conv`` on every frame of x (T, n_max, F) over one mesh: each
    frame's x·W side by side as the columns of one Â·z."""
    t, n, _ = x.shape
    h = nn.functional.linear(x.to(conv.dtype), conv.lin.weight.to(conv.dtype))
    out = a_mul(h.permute(1, 0, 2).reshape(1, n, -1), graph)
    return out.reshape(n, t, -1).permute(1, 0, 2) + conv.bias.to(out.dtype)


def _check_one_mesh(x: torch.Tensor, graph: GraphTensors) -> None:
    if x.ndim != 3 or graph.counts.shape != (1, x.shape[1]):
        raise ValueError(f"expected x (T, n_max, F) and one mesh of n_max nodes; got x "
                         f"{tuple(x.shape)} and a graph of {tuple(graph.counts.shape)} counts")


class MPNNLSTM(nn.Module):
    """Per-frame GCN feature extractor, an LSTM over time, an MLP head.
    ``input_features`` is F of the node features."""

    def __init__(self, input_features: int, hidden_size: int, dropout: float = 0.1,
                 input_timesteps: int = 3, output_features: int = 1, lstm_layers: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = torch.float32 if dtype is None else dtype
        self.dropout = dropout
        self.lstm_layers = lstm_layers
        d = hidden_size
        for i in range(3):
            self.add_module(f"convolution{i + 1}",
                            GCNConv(input_features if i == 0 else d, d, dtype=self.dtype))
            self.add_module(f"bn{i + 1}", LayerNorm(d))
        for layer in range(lstm_layers):
            self.add_module(f"lstm{layer}", flax_lstm(d, batch_first=False))
        self.lin1 = nn.Linear(d + input_timesteps, d)
        self.lin2 = nn.Linear(d, output_features)

    def forward(self, x: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _check_one_mesh(x, graph)
        dt = self.dtype
        x = x.to(dt)
        h = x
        for i in range(1, 4):
            h = torch.relu(_frames_gcn(getattr(self, f"convolution{i}"), h, graph))
            h = dropout(getattr(self, f"bn{i}")(h), self.dropout, self.training, generator)
        zeros = h.new_zeros((1, h.shape[1], h.shape[2]))
        for layer in range(self.lstm_layers):
            # (T, N, hidden) time-major; the final carry of the last layer
            h, (h_last, _) = run_lstm(getattr(self, f"lstm{layer}"), h, (zeros, zeros), dt)
        h = torch.cat([torch.relu(h_last[0]), x[:, :, 0].T], dim=-1)
        h = torch.relu(dense(self.lin1, h, dt))
        h = dropout(dense(self.lin2, h, dt), self.dropout, self.training, generator)
        return torch.sigmoid(h).float()


class MPNNLSTMI(nn.Module):
    """Stacked GConvLSTMs unrolled over the frames, BatchNorm and an MLP
    head. ``attr_dim`` is the graph's edge-attribute width (attention
    convs)."""

    def __init__(self, input_features: int, hidden_size: int, dropout: float = 0.1,
                 n_layers: int = 2, convolution_type: str = "GCNConv",
                 output_features: int = 1, dtype: Optional[torch.dtype] = None,
                 attr_dim: int = 2):
        super().__init__()
        self.dtype = torch.float32 if dtype is None else dtype
        self.dropout = dropout
        self.n_layers = n_layers
        d = hidden_size
        for i in range(n_layers):
            self.add_module(f"recurrent{i}",
                            GConvLSTM(input_features if i == 0 else d, d, 1, convolution_type,
                                      dtype=self.dtype, attr_dim=attr_dim))
        self.bn1 = BatchNorm(d)
        self.lin1 = nn.Linear(d, d)
        self.lin2 = nn.Linear(d, output_features)

    def forward(self, x: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _check_one_mesh(x, graph)
        dt = self.dtype
        x = x.to(dt)
        zeros = x.new_zeros((1, x.shape[1], self.bn1.weight.shape[0]))
        hs, cs = [zeros] * self.n_layers, [zeros] * self.n_layers
        for t in range(x.shape[0]):
            inp = x[t][None]
            for i in range(self.n_layers):
                _, hs[i], cs[i] = getattr(self, f"recurrent{i}")(inp, graph, hs[i], cs[i],
                                                                 generator)
                inp = hs[i]
        h = self.bn1(torch.relu(hs[-1][0]))
        h = torch.relu(dense(self.lin1, h, dt))
        h = dropout(dense(self.lin2, h, dt), self.dropout, self.training, generator)
        return torch.sigmoid(h).float()
