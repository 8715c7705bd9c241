"""Graph-convolutional recurrent cells.

Counterpart of ``quadtree_mpnnlstm_tpu/models/cells.py``:

* ``GConvLSTM`` — a peephole graph-conv LSTM. Gate g ∈ {i, f, c, o}:
  ``conv_x_g(X) + conv_h_g(H) (+ w_c_g ⊙ C) + b_g``, peepholes and biases
  zero-initialised. Returns (O, H, C): the output-gate activation is the
  cell's "output", read by the decoder head.
* ``GConvGRU`` — a graph-conv GRU. Returns (H, H, C) with C passed
  through.
* ``GConvLSTMSimple`` — one ``conv_x``/``conv_h`` pair shared by the four
  gates, which differ only by their biases; no peepholes.
* ``SplitGConvLSTM`` — a graph conv, then a standard LSTM scanned along
  the node axis over all n_max rows.
* ``DummyLSTM`` — the identity.

The LSTM and GRU gate stacks run fused (:mod:`models/fused.py`) for GCN,
Chebyshev and attention convs, or with ``fused_gates=False`` in the JAX
package's per-gate layout (``conv_x``/``conv_h`` with a leading gate axis)
through the same arithmetic; GAT and GATv2 always take the per-gate layout
and run every gate stream of a conv layer as a head of one edge pass
(``gat_gate_streams``). ``dtype`` is the compute dtype of every cell.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.models.conv import GraphConv
from quadtree_mpnnlstm_tpu_torch.models.fused import (
    ATTN_FUSABLE,
    FUSABLE,
    FusedAttnGateStack,
    FusedGateConvStack,
    PerGateStack,
    gate_streams,
)

GATE_STACKS = {"GCNConv": partial(FusedGateConvStack, convolution_type="GCNConv"),
               "ChebConv": FusedGateConvStack,
               "TransformerConv": FusedAttnGateStack,
               "MHTransformerConv": partial(FusedAttnGateStack,
                                            convolution_type="MHTransformerConv")}


def _zeros(module: nn.Module, names, d: int) -> None:
    for name in names:
        module.register_parameter(name, nn.Parameter(torch.zeros(1, d)))


class GConvLSTM(nn.Module):
    """Peephole graph-conv LSTM with the fused gate stack of its
    convolution type (GCNConv, ChebConv, TransformerConv or
    MHTransformerConv), or with ``fused_gates=False`` (and always for
    GATConv, GATv2Conv and Dummy) the JAX package's per-gate parameters
    (``conv_x``/``conv_h``, :class:`PerGateStack`). ``dtype`` is the gate
    stack's compute dtype; peepholes, biases and the cell state join the
    gates' dtype, as in the flax module. ``attr_dim`` is the graph's
    edge-attribute width."""

    def __init__(self, in_channels: int, out_channels: int, n_conv_layers: int = 1,
                 convolution_type: str = "ChebConv", dtype: torch.dtype = torch.float32,
                 fused_gates: bool = True, attr_dim: int = 2):
        super().__init__()
        d = out_channels
        self.dtype = dtype
        self.fused_gates = fused_gates and convolution_type in FUSABLE + ATTN_FUSABLE
        if self.fused_gates:
            self.gates = GATE_STACKS[convolution_type](in_channels, d, d, n_conv_layers, 4,
                                                       dtype=dtype)
        else:
            self.conv_x = PerGateStack(convolution_type, in_channels, d, n_conv_layers, 4,
                                       attr_dim)
            self.conv_h = PerGateStack(convolution_type, d, d, n_conv_layers, 4, attr_dim)
        _zeros(self, ("w_c_i", "w_c_f", "w_c_o", "b_i", "b_f", "b_c", "b_o"), d)

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
        streams = gate_streams(x, h, graph, self.conv_x, self.conv_h, self.dtype, self.training,
                               generator)
        return streams[:4] + streams[4:]


class GConvGRU(nn.Module):
    """Graph-conv GRU. Fused (GCN, Chebyshev and attention convs):
    ``gates_zr`` (2 gates, z and r) and ``gate_candidate`` (1 gate, on
    ``h·r``), each a fused gate stack. Per-gate (``fused_gates=False``,
    and always for GAT, GATv2 and Dummy): ``conv_x`` (3 gates: z, r and the
    candidate), ``conv_h`` (2 gates) and ``conv_h_candidate``, a plain
    :class:`GraphConv` on ``h·r``. ``h' = z·h + (1 − z)·h̃``; returns
    (h', h', c) with c passed through."""

    def __init__(self, in_channels: int, out_channels: int, n_conv_layers: int = 1,
                 convolution_type: str = "ChebConv", dtype: torch.dtype = torch.float32,
                 fused_gates: bool = True, attr_dim: int = 2):
        super().__init__()
        d = out_channels
        self.dtype = dtype
        self.fused_gates = fused_gates and convolution_type in FUSABLE + ATTN_FUSABLE
        if self.fused_gates:
            stack = GATE_STACKS[convolution_type]
            self.gates_zr = stack(in_channels, d, d, n_conv_layers, 2, dtype=dtype)
            self.gate_candidate = stack(in_channels, d, d, n_conv_layers, 1, dtype=dtype)
        else:
            self.conv_x = PerGateStack(convolution_type, in_channels, d, n_conv_layers, 3,
                                       attr_dim)
            self.conv_h = PerGateStack(convolution_type, d, d, n_conv_layers, 2, attr_dim)
            self.conv_h_candidate = GraphConv(convolution_type, d, d, n_conv_layers, attr_dim,
                                              dtype)

    def forward(self, x, graph, h, c, generator=None):
        if self.fused_gates:
            zr = self.gates_zr(x, h, graph, generator)
            z, r = torch.sigmoid(zr[0]), torch.sigmoid(zr[1])
            h_tilde = torch.tanh(self.gate_candidate(x, h * r.to(h.dtype), graph, generator)[0])
        else:
            s = gate_streams(x, h, graph, self.conv_x, self.conv_h, self.dtype, self.training,
                             generator)  # x: z, r, candidate; h: z, r
            z, r = torch.sigmoid(s[0] + s[3]), torch.sigmoid(s[1] + s[4])
            h_cand = self.conv_h_candidate(h * r.to(h.dtype), graph, generator)
            h_tilde = torch.tanh(s[2] + h_cand)
        z = z.to(h_tilde.dtype)
        h_new = z * h.to(h_tilde.dtype) + (1.0 - z) * h_tilde
        return h_new, h_new, c


class GConvLSTMSimple(nn.Module):
    """LSTM whose four gates share one ``conv_x(X) + conv_h(H)`` value
    (two :class:`GraphConv` stacks, evaluated once) and differ only by
    their biases ``b_i``, ``b_f``, ``b_c``, ``b_o``; no peepholes."""

    def __init__(self, in_channels: int, out_channels: int, n_conv_layers: int = 1,
                 convolution_type: str = "ChebConv", dtype: torch.dtype = torch.float32,
                 attr_dim: int = 2):
        super().__init__()
        d = out_channels
        self.conv_x = GraphConv(convolution_type, in_channels, d, n_conv_layers, attr_dim, dtype)
        self.conv_h = GraphConv(convolution_type, d, d, n_conv_layers, attr_dim, dtype)
        _zeros(self, ("b_i", "b_f", "b_c", "b_o"), d)

    def forward(self, x, graph, h, c, generator=None):
        g = self.conv_x(x, graph, generator) + self.conv_h(h, graph, generator)
        dt = g.dtype
        c = c.to(dt)
        i = torch.sigmoid(g + self.b_i.to(dt))
        f = torch.sigmoid(g + self.b_f.to(dt))
        t = torch.tanh(g + self.b_c.to(dt))
        c_new = f * c + i * t
        o = torch.sigmoid(g + self.b_o.to(dt))
        return o, o * torch.tanh(c_new), c_new


def flax_lstm(d: int, batch_first: bool) -> nn.LSTM:
    """A one-layer ``torch.nn.LSTM`` of width ``d`` laid out as the flax
    ``OptimizedLSTMCell``: its ``bias_ih_l0`` is a zero buffer, not a
    parameter, the flax cell having only the recurrent bias."""
    lstm = nn.LSTM(d, d, batch_first=batch_first)
    del lstm.bias_ih_l0
    lstm.register_buffer("bias_ih_l0", torch.zeros(4 * d))
    lstm._init_flat_weights()
    return lstm


def run_lstm(lstm: nn.LSTM, x: torch.Tensor, carry, dtype: torch.dtype):
    """``lstm(x, carry)`` in ``dtype`` (its float32 weights cast at use in
    a bf16 model), with cuDNN's deterministic settings on a CUDA card."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                     allow_tf32=cudnn.allow_tf32):
        if dtype == torch.float32:
            return lstm(x, carry)
        weights = {name: t.to(dtype) for name, t in
                   [*lstm.named_parameters(), *lstm.named_buffers()]}
        return torch.func.functional_call(lstm, weights, (x, carry))


class SplitGConvLSTM(nn.Module):
    """A :class:`GraphConv` ``conv`` feeding a standard LSTM ``lstm`` (the
    flax ``OptimizedLSTMCell``, scanned) along the **node** axis: each
    sample's n_max rows, padding rows included, are one sequence in row
    order, from the carry in row 0 of its (H, C). The final carry is
    broadcast back over the rows; the cell's output is the per-row LSTM
    output. The LSTM is ``torch.nn.LSTM`` (no TPU kernel: the JAX package
    scans it in XLA); its ``bias_ih_l0`` is a zero buffer, not a
    parameter, the flax cell having only the recurrent bias. In a bf16
    model its weights are cast at use. On a CUDA card cuDNN runs it with
    its deterministic settings."""

    def __init__(self, in_channels: int, out_channels: int, n_conv_layers: int = 1,
                 convolution_type: str = "ChebConv", dtype: torch.dtype = torch.float32,
                 attr_dim: int = 2):
        super().__init__()
        d = out_channels
        self.dtype = dtype
        self.conv = GraphConv(convolution_type, in_channels, d, n_conv_layers, attr_dim, dtype)
        self.lstm = flax_lstm(d, batch_first=True)

    def forward(self, x, graph, h, c, generator=None):
        xc = self.conv(x, graph, generator).to(self.dtype)
        carry = (h[:, 0].to(self.dtype)[None].contiguous(),
                 c[:, 0].to(self.dtype)[None].contiguous())
        out, (h_fin, c_fin) = run_lstm(self.lstm, xc, carry, self.dtype)
        return (out, h_fin[0, :, None].expand_as(out).contiguous(),
                c_fin[0, :, None].expand_as(out).contiguous())


class DummyLSTM(nn.Module):
    """The identity cell: returns (x, h, c)."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x, graph, h, c, generator=None):
        return x, h, c


RNN_CELLS = {"LSTM": GConvLSTM, "GRU": GConvGRU, "SimpleLSTM": GConvLSTMSimple,
             "SplitLSTM": SplitGConvLSTM, "Dummy": DummyLSTM}
