"""Graph-convolutional recurrent cells.

Counterpart of ``GConvLSTM`` (fused path) in
``quadtree_mpnnlstm_tpu/models/cells.py``: a peephole graph-conv LSTM.
Gate g ∈ {i, f, c, o}: ``conv_x_g(X) + conv_h_g(H) (+ w_c_g ⊙ C) + b_g``,
peepholes and biases zero-initialised. Returns (O, H, C) — the output-gate
activation is the cell's "output", read by the decoder head.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.models.fused import FusedAttnGateStack, FusedGateConvStack

GATE_STACKS = {"ChebConv": FusedGateConvStack, "TransformerConv": FusedAttnGateStack}


class GConvLSTM(nn.Module):
    """Peephole graph-conv LSTM with the fused gate stack of its
    convolution type (ChebConv or TransformerConv). ``dtype`` is the gate
    stack's compute dtype; peepholes, biases and the cell state join the
    gates' dtype, as in the flax module."""

    def __init__(self, in_channels: int, out_channels: int, n_conv_layers: int = 1,
                 convolution_type: str = "ChebConv", dtype: torch.dtype = torch.float32):
        super().__init__()
        d = out_channels
        self.gates = GATE_STACKS[convolution_type](in_channels, d, d, n_conv_layers, 4,
                                                   dtype=dtype)
        for name in ("w_c_i", "w_c_f", "w_c_o", "b_i", "b_f", "b_c", "b_o"):
            self.register_parameter(name, nn.Parameter(torch.zeros(1, d)))

    def forward(
        self, x: torch.Tensor, graph: GraphTensors, h: torch.Tensor, c: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        g = self.gates(x, h, graph, generator)  # (4, B, N, d) — gates i, f, c, o
        dt = g.dtype
        w_ci, w_cf, w_co, b_i, b_f, b_c, b_o = (
            p.to(dt) for p in (self.w_c_i, self.w_c_f, self.w_c_o,
                               self.b_i, self.b_f, self.b_c, self.b_o))
        c = c.to(dt)
        i = torch.sigmoid(g[0] + w_ci * c + b_i)
        f = torch.sigmoid(g[1] + w_cf * c + b_f)
        t = torch.tanh(g[2] + b_c)
        c_new = f * c + i * t
        o = torch.sigmoid(g[3] + w_co * c_new + b_o)
        h_new = o * torch.tanh(c_new)
        return o, h_new, c_new
