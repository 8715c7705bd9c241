"""Graph-convolutional recurrent cells.

Counterpart of ``GConvLSTM`` in ``quadtree_mpnnlstm_tpu/models/cells.py``
(its fused gate stacks and, with ``fused_gates=False``, its per-gate
``conv_x``/``conv_h`` layout): a peephole graph-conv LSTM.
Gate g ∈ {i, f, c, o}: ``conv_x_g(X) + conv_h_g(H) (+ w_c_g ⊙ C) + b_g``,
peepholes and biases zero-initialised. Returns (O, H, C) — the output-gate
activation is the cell's "output", read by the decoder head.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.models.conv import CONVOLUTION_KWARGS
from quadtree_mpnnlstm_tpu_torch.models.fused import (
    FusedAttnGateStack,
    FusedGateConvStack,
    PerGateStack,
    attn_gate_streams,
    cheb_gate_streams,
    fused_from_per_gate,
    gcn_gate_streams,
)

GATE_STACKS = {"GCNConv": partial(FusedGateConvStack, convolution_type="GCNConv"),
               "ChebConv": FusedGateConvStack, "TransformerConv": FusedAttnGateStack}


class GConvLSTM(nn.Module):
    """Peephole graph-conv LSTM with the fused gate stack of its
    convolution type (GCNConv, ChebConv or TransformerConv), or with
    ``fused_gates=False`` the JAX package's per-gate parameters
    (``conv_x``/``conv_h``, :class:`PerGateStack`) run through the same
    fused arithmetic. ``dtype`` is the gate stack's compute dtype;
    peepholes, biases and the cell state join the gates' dtype, as in the
    flax module."""

    def __init__(self, in_channels: int, out_channels: int, n_conv_layers: int = 1,
                 convolution_type: str = "ChebConv", dtype: torch.dtype = torch.float32,
                 fused_gates: bool = True):
        super().__init__()
        d = out_channels
        self.convolution_type, self.n_conv_layers, self.dtype = (convolution_type,
                                                                 n_conv_layers, dtype)
        self.fused_gates = fused_gates
        if fused_gates:
            self.gates = GATE_STACKS[convolution_type](in_channels, d, d, n_conv_layers, 4,
                                                       dtype=dtype)
        else:
            self.conv_x = PerGateStack(convolution_type, in_channels, d, n_conv_layers)
            self.conv_h = PerGateStack(convolution_type, d, d, n_conv_layers)
            # the registry's attention dropout, read when built, as the fused
            # stack reads it
            self.attn_dropout = CONVOLUTION_KWARGS["TransformerConv"]["dropout"]
        for name in ("w_c_i", "w_c_f", "w_c_o", "b_i", "b_f", "b_c", "b_o"):
            self.register_parameter(name, nn.Parameter(torch.zeros(1, d)))

    def forward(
        self, x: torch.Tensor, graph: GraphTensors, h: torch.Tensor, c: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        g = self._gates(x, h, graph, generator)  # (4, B, N, d) — gates i, f, c, o
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

    def _gates(self, x, h, graph, generator):
        if self.fused_gates:
            return self.gates(x, h, graph, generator)
        params = fused_from_per_gate(self.conv_x, self.conv_h, self.convolution_type).__getitem__
        if self.convolution_type == "GCNConv":
            return gcn_gate_streams(x, h, graph, params, 4, self.n_conv_layers, self.dtype)
        if self.convolution_type == "ChebConv":
            kw = CONVOLUTION_KWARGS["ChebConv"]
            return cheb_gate_streams(x, h, graph, params, 4, kw["K"], 2.0,  # ChebConv's λmax
                                     self.n_conv_layers, self.dtype)
        return attn_gate_streams(x, h, graph, params, 4, self.n_conv_layers, self.attn_dropout,
                                 self.training, generator, self.dtype)
