"""Graph-convolutional recurrent cells.

Counterpart of ``GConvLSTM`` (fused path) in
``quadtree_mpnnlstm_tpu/models/cells.py``: a peephole graph-conv LSTM.
Gate g ∈ {i, f, c, o}: ``conv_x_g(X) + conv_h_g(H) (+ w_c_g ⊙ C) + b_g``,
peepholes and biases zero-initialised. Returns (O, H, C) — the output-gate
activation is the cell's "output", read by the decoder head.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.models.fused import FusedGateConvStack


class GConvLSTM(nn.Module):
    """Peephole graph-conv LSTM with the fused ChebConv gate stack."""

    def __init__(self, in_channels: int, out_channels: int, n_conv_layers: int = 1):
        super().__init__()
        d = out_channels
        self.gates = FusedGateConvStack(in_channels, d, d, n_conv_layers, 4)
        for name in ("w_c_i", "w_c_f", "w_c_o", "b_i", "b_f", "b_c", "b_o"):
            self.register_parameter(name, nn.Parameter(torch.zeros(1, d)))

    def forward(
        self, x: torch.Tensor, graph: GraphTensors, h: torch.Tensor, c: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        g = self.gates(x, h, graph)  # (4, B, N, d) — gates i, f, c, o
        i = torch.sigmoid(g[0] + self.w_c_i * c + self.b_i)
        f = torch.sigmoid(g[1] + self.w_c_f * c + self.b_f)
        t = torch.tanh(g[2] + self.b_c)
        c_new = f * c + i * t
        o = torch.sigmoid(g[3] + self.w_c_o * c_new + self.b_o)
        h_new = o * torch.tanh(c_new)
        return o, h_new, c_new
