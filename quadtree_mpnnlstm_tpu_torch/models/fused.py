"""Fused multi-gate Chebyshev convolutions.

Counterpart of ``FusedGateConvStack`` (ChebConv branch) in
``quadtree_mpnnlstm_tpu/models/fused.py``. A GConvLSTM evaluates
``conv_x_g(X) + conv_h_g(H)`` for four gates; the Chebyshev polynomials
depend only on the stack input, so layer 0 computes the K tensors once on
``[X ‖ H]`` for all gates and both sides and applies per-gate weights as
einsums, and deeper layers aggregate once per tap over all 2·G streams.
"""

from __future__ import annotations

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.models.conv import a_mul


class FusedGateConvStack(nn.Module):
    """``conv_x_g(X) + conv_h_g(H)`` for ``n_gates`` gates with shared
    aggregations. Returns (n_gates, B, N, out_channels). Parameter names
    and shapes follow the flax module (``w_x_0`` (g, K, fx, d), ``w_h_0``,
    ``b_x_0`` (g, d), ``b_h_0``, then ``w_l`` (2g, K, d, d), ``b_l``)."""

    def __init__(self, x_channels: int, h_channels: int, out_channels: int,
                 n_layers: int = 1, n_gates: int = 4, K: int = 3,
                 lambda_max: float = 2.0):
        super().__init__()
        g, d = n_gates, out_channels
        self.n_gates, self.K, self.n_layers = g, K, n_layers
        self.lambda_max = lambda_max
        self.w_x_0 = nn.Parameter(torch.zeros(g, K, x_channels, d))
        self.w_h_0 = nn.Parameter(torch.zeros(g, K, h_channels, d))
        self.b_x_0 = nn.Parameter(torch.zeros(g, d))
        self.b_h_0 = nn.Parameter(torch.zeros(g, d))
        for layer in range(1, n_layers):
            self.register_parameter(f"w_{layer}", nn.Parameter(torch.zeros(2 * g, K, d, d)))
            self.register_parameter(f"b_{layer}", nn.Parameter(torch.zeros(2 * g, d)))

    def forward(self, x: torch.Tensor, h: torch.Tensor, graph: GraphTensors) -> torch.Tensor:
        g = self.n_gates
        scale = 2.0 / self.lambda_max

        def l_hat(z):
            return scale * (z - a_mul(z, graph)) - z

        def cheb_t(z):
            """K Chebyshev tensors of z (B, N, W), stacked (K, B, N, W)."""
            ts = [z]
            if self.K > 1:
                ts.append(l_hat(z))
            for _ in range(2, self.K):
                ts.append(2.0 * l_hat(ts[-1]) - ts[-2])
            return torch.stack(ts)

        fx = x.shape[-1]
        # ---- layer 0: shared polynomials over [X ‖ H]
        t = cheb_t(torch.cat([x, h], dim=-1))  # (K, B, N, fx+fh)
        sx = torch.einsum("kbnf,gkfo->gbno", t[..., :fx], self.w_x_0) + self.b_x_0[:, None, None]
        sh = torch.einsum("kbnf,gkfo->gbno", t[..., fx:], self.w_h_0) + self.b_h_0[:, None, None]
        streams = torch.cat([sx, sh], dim=0)  # (2g, B, N, d)
        # ---- deeper layers: one aggregation per tap over all streams
        for layer in range(1, self.n_layers):
            s, b, n, d = streams.shape
            z = streams.permute(1, 2, 0, 3).reshape(b, n, s * d)
            t = cheb_t(z).reshape(self.K, b, n, s, d)
            w = getattr(self, f"w_{layer}")
            bias = getattr(self, f"b_{layer}")
            streams = torch.einsum("kbnsd,skdo->sbno", t, w) + bias[:, None, None]
        return streams[:g] + streams[g:]
