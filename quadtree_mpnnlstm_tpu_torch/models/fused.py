"""Fused multi-gate graph convolutions.

Counterpart of ``FusedGateConvStack`` (ChebConv branch) and
``FusedAttnGateStack`` (TransformerConv branch) in
``quadtree_mpnnlstm_tpu/models/fused.py``. A GConvLSTM evaluates
``conv_x_g(X) + conv_h_g(H)`` for four gates. The Chebyshev polynomials
depend only on the stack input, so layer 0 computes the K tensors once on
``[X ‖ H]`` for all gates and both sides and applies per-gate weights as
einsums, and deeper layers aggregate once per tap over all 2·G streams.
Attention coefficients depend on each stream, so there the 2·G streams run
as extra heads of one attention call per conv layer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.models.conv import (
    CONVOLUTION_KWARGS,
    a_mul,
    multi_stream_attention,
)


class FusedGateConvStack(nn.Module):
    """``conv_x_g(X) + conv_h_g(H)`` for ``n_gates`` gates with shared
    aggregations. Returns (n_gates, B, N, out_channels). Parameter names
    and shapes follow the flax module (``w_x_0`` (g, K, fx, d), ``w_h_0``,
    ``b_x_0`` (g, d), ``b_h_0``, then ``w_l`` (2g, K, d, d), ``b_l``).
    ``dtype`` is the compute dtype: x, h and each float32 master parameter
    are cast to it at use, as flax's ``dtype`` does."""

    def __init__(self, x_channels: int, h_channels: int, out_channels: int,
                 n_layers: int = 1, n_gates: int = 4, K: int = 3,
                 lambda_max: float = 2.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        g, d = n_gates, out_channels
        self.n_gates, self.K, self.n_layers = g, K, n_layers
        self.lambda_max = lambda_max
        self.dtype = dtype
        self.w_x_0 = nn.Parameter(torch.zeros(g, K, x_channels, d))
        self.w_h_0 = nn.Parameter(torch.zeros(g, K, h_channels, d))
        self.b_x_0 = nn.Parameter(torch.zeros(g, d))
        self.b_h_0 = nn.Parameter(torch.zeros(g, d))
        for layer in range(1, n_layers):
            self.register_parameter(f"w_{layer}", nn.Parameter(torch.zeros(2 * g, K, d, d)))
            self.register_parameter(f"b_{layer}", nn.Parameter(torch.zeros(2 * g, d)))

    def forward(self, x: torch.Tensor, h: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g = self.n_gates
        scale = 2.0 / self.lambda_max
        x, h = x.to(self.dtype), h.to(self.dtype)

        def p(w):  # a master parameter in the compute dtype
            return w.to(self.dtype)

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
        sx = torch.einsum("kbnf,gkfo->gbno", t[..., :fx], p(self.w_x_0)) \
            + p(self.b_x_0)[:, None, None]
        sh = torch.einsum("kbnf,gkfo->gbno", t[..., fx:], p(self.w_h_0)) \
            + p(self.b_h_0)[:, None, None]
        streams = torch.cat([sx, sh], dim=0)  # (2g, B, N, d)
        # ---- deeper layers: one aggregation per tap over all streams
        for layer in range(1, self.n_layers):
            s, b, n, d = streams.shape
            z = streams.permute(1, 2, 0, 3).reshape(b, n, s * d)
            t = cheb_t(z).reshape(self.K, b, n, s, d)
            w = p(getattr(self, f"w_{layer}"))
            bias = p(getattr(self, f"b_{layer}"))
            streams = torch.einsum("kbnsd,skdo->sbno", t, w) + bias[:, None, None]
        return streams[:g] + streams[g:]


class FusedAttnGateStack(nn.Module):
    """``conv_x_g(X) + conv_h_g(H)`` for ``n_gates`` gates where the conv
    is TransformerConv (heads 1, mean over heads, root-weight skip): the
    2·G per-gate streams run as extra heads of one
    :func:`~quadtree_mpnnlstm_tpu_torch.models.conv.multi_stream_attention`
    call per conv layer. Returns (n_gates, B, N, out_channels).

    Parameter names and shapes follow the flax module: layer 0 has
    ``w_{q,k,v}_{x,h}_0`` (g, f, d) with biases ``b_*`` (g, d), the edge
    projections ``w_e_x_0``/``w_e_h_0`` (g, A, d) and the skip
    ``w_s_{x,h}_0``/``b_s_{x,h}_0``; layer l ≥ 1 has ``w_{q,k,v,s}_l``
    (2g, d, d), ``b_{q,k,v,s}_l`` (2g, d) and ``w_e_l`` (2g, A, d).
    ``dtype`` is the compute dtype: x, h and each float32 master parameter
    are cast to it at use, as flax's ``dtype`` does.
    """

    def __init__(self, x_channels: int, h_channels: int, out_channels: int,
                 n_layers: int = 1, n_gates: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        kwargs = CONVOLUTION_KWARGS["TransformerConv"]
        g, d, a = n_gates, out_channels, kwargs["edge_dim"]
        self.n_gates, self.n_layers, self.dropout = g, n_layers, kwargs["dropout"]
        self.dtype = dtype
        for name in ("q", "k", "v", "s"):
            for side, f in (("x", x_channels), ("h", h_channels)):
                self.register_parameter(f"w_{name}_{side}_0", nn.Parameter(torch.zeros(g, f, d)))
                self.register_parameter(f"b_{name}_{side}_0", nn.Parameter(torch.zeros(g, d)))
        self.w_e_x_0 = nn.Parameter(torch.zeros(g, a, d))
        self.w_e_h_0 = nn.Parameter(torch.zeros(g, a, d))
        for layer in range(1, n_layers):
            for name in ("q", "k", "v", "s"):
                self.register_parameter(f"w_{name}_{layer}", nn.Parameter(torch.zeros(2 * g, d, d)))
                self.register_parameter(f"b_{name}_{layer}", nn.Parameter(torch.zeros(2 * g, d)))
            self.register_parameter(f"w_e_{layer}", nn.Parameter(torch.zeros(2 * g, a, d)))

    def forward(self, x: torch.Tensor, h: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g = self.n_gates
        s = 2 * g
        b, n = x.shape[:2]
        x, h = x.to(self.dtype), h.to(self.dtype)

        def param(name):  # a master parameter in the compute dtype
            return getattr(self, name).to(self.dtype)

        def proj0(name):  # per-gate projections of X and of H → (B, N, 2g, width)
            return torch.cat([
                torch.einsum("bnf,gfo->bngo", src, param(f"w_{name}_{side}_0"))
                + param(f"b_{name}_{side}_0")
                for side, src in (("x", x), ("h", h))
            ], dim=2)

        def proj(name, streams, layer):  # per-stream projection (B, N, 2g, ·)
            return (torch.einsum("bnsf,sfo->bnso", streams, param(f"w_{name}_{layer}"))
                    + param(f"b_{name}_{layer}"))

        def attend(q_all, k_all, v_all, we_all):  # streams as heads → (B, N, 2g, d)
            d = q_all.shape[-1]
            we = we_all.permute(1, 0, 2).reshape(we_all.shape[1], s * d)
            out = multi_stream_attention(
                q_all.reshape(b, n, s * d), k_all.reshape(b, n, s * d),
                v_all.reshape(b, n, s * d), we, graph, s, d,
                dropout=self.dropout, training=self.training, generator=generator,
            )
            return out  # heads = 1 per stream: the mean over heads is the identity

        we0 = torch.cat([param("w_e_x_0"), param("w_e_h_0")], dim=0)
        streams = attend(proj0("q"), proj0("k"), proj0("v"), we0) + proj0("s")
        for layer in range(1, self.n_layers):
            streams = attend(proj("q", streams, layer), proj("k", streams, layer),
                             proj("v", streams, layer), param(f"w_e_{layer}")) \
                + proj("s", streams, layer)
        streams = streams.permute(2, 0, 1, 3)  # (2g, B, N, d)
        return streams[:g] + streams[g:]
