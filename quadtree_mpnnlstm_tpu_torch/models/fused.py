"""Fused multi-gate graph convolutions.

Counterpart of ``FusedGateConvStack`` (GCNConv and ChebConv branches)
and ``FusedAttnGateStack`` (TransformerConv branch) in
``quadtree_mpnnlstm_tpu/models/fused.py``. A GConvLSTM evaluates
``conv_x_g(X) + conv_h_g(H)`` for four gates. The aggregation Â·z is
weight-free and feature-wise linear, so parallel streams share it by
feature concatenation. The Chebyshev polynomials depend only on the stack
input, so layer 0 computes the K tensors once on ``[X ‖ H]`` for all gates
and both sides and applies per-gate weights as einsums, and deeper layers
aggregate once per tap over all 2·G streams. GCN applies each stream's
weights first and then aggregates all 2·G streams in one Â·z per conv
layer. Attention coefficients depend on each stream, so there the 2·G
streams run as extra heads of one attention call per conv layer.

The per-gate layout (``fused_gates=False``: the JAX package's vmapped
``conv_x``/``conv_h`` stacks of ``models/cells.py`` ``gate_conv_module``,
each leaf with a leading gate axis) keeps its own parameters
(:class:`PerGateStack`) and runs through the same arithmetic: its weights
are stacked into the fused layout at every call (:func:`fused_from_per_gate`),
so a cell launches one Â·z per Chebyshev tap or GCN layer, or one
attention call per conv layer, for all gates, not one per gate. The JAX package's
``tests/test_fused.py`` proves the two layouts equal by transplanting
weights.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.models.conv import (
    CONVOLUTION_KWARGS,
    a_mul,
    multi_stream_attention,
)


def cheb_gate_streams(x: torch.Tensor, h: torch.Tensor, graph: GraphTensors,
                      param: Callable[[str], torch.Tensor], n_gates: int, K: int,
                      lambda_max: float, n_layers: int, dtype: torch.dtype) -> torch.Tensor:
    """``conv_x_g(X) + conv_h_g(H)`` for ``n_gates`` ChebConv gate stacks
    with shared aggregations, from the fused-layout parameters that
    ``param(name)`` returns (``w_x_0`` (g, K, fx, d), ``w_h_0``, ``b_x_0``
    (g, d), ``b_h_0``, then ``w_l`` (2g, K, d, d), ``b_l``). x, h and
    every parameter are cast to ``dtype`` at use. Returns (n_gates, B, N,
    d)."""
    g = n_gates
    scale = 2.0 / lambda_max
    x, h = x.to(dtype), h.to(dtype)

    def p(name):  # a master parameter in the compute dtype
        return param(name).to(dtype)

    def l_hat(z):
        return scale * (z - a_mul(z, graph)) - z

    def cheb_t(z):
        """K Chebyshev tensors of z (B, N, W), stacked (K, B, N, W)."""
        ts = [z]
        if K > 1:
            ts.append(l_hat(z))
        for _ in range(2, K):
            ts.append(2.0 * l_hat(ts[-1]) - ts[-2])
        return torch.stack(ts)

    fx = x.shape[-1]
    # ---- layer 0: shared polynomials over [X ‖ H]
    t = cheb_t(torch.cat([x, h], dim=-1))  # (K, B, N, fx+fh)
    sx = torch.einsum("kbnf,gkfo->gbno", t[..., :fx], p("w_x_0")) + p("b_x_0")[:, None, None]
    sh = torch.einsum("kbnf,gkfo->gbno", t[..., fx:], p("w_h_0")) + p("b_h_0")[:, None, None]
    streams = torch.cat([sx, sh], dim=0)  # (2g, B, N, d)
    # ---- deeper layers: one aggregation per tap over all streams
    for layer in range(1, n_layers):
        s, b, n, d = streams.shape
        z = streams.permute(1, 2, 0, 3).reshape(b, n, s * d)
        t = cheb_t(z).reshape(K, b, n, s, d)
        streams = (torch.einsum("kbnsd,skdo->sbno", t, p(f"w_{layer}"))
                   + p(f"b_{layer}")[:, None, None])
    return streams[:g] + streams[g:]


def gcn_gate_streams(x: torch.Tensor, h: torch.Tensor, graph: GraphTensors,
                     param: Callable[[str], torch.Tensor], n_gates: int, n_layers: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """``conv_x_g(X) + conv_h_g(H)`` for ``n_gates`` GCNConv gate stacks:
    each stream's weights first, then one Â·z over all 2·G streams side by
    side (width 2·G·d) per conv layer, from the fused-layout parameters
    that ``param(name)`` returns (``w_x_0`` (g, fx, d), ``w_h_0`` (g, fh,
    d), ``b_x_0`` (g, d), ``b_h_0``, then ``w_l`` (2g, d, d), ``b_l`` (2g,
    d)). x, h and every parameter are cast to ``dtype`` at use. Returns
    (n_gates, B, N, d)."""
    g = n_gates
    b, n = x.shape[:2]
    x, h = x.to(dtype), h.to(dtype)

    def p(name):  # a master parameter in the compute dtype
        return param(name).to(dtype)

    def aggregate(u, bias):  # (B, N, s, d) → Â per stream + bias, (s, B, N, d)
        s, d = u.shape[2:]
        return a_mul(u.reshape(b, n, s * d), graph).reshape(b, n, s, d).permute(2, 0, 1, 3) \
            + bias[:, None, None]

    u = torch.cat([torch.einsum("bnf,gfo->bngo", x, p("w_x_0")),
                   torch.einsum("bnf,gfo->bngo", h, p("w_h_0"))], dim=2)  # (B, N, 2g, d)
    streams = aggregate(u, torch.cat([p("b_x_0"), p("b_h_0")]))
    for layer in range(1, n_layers):
        u = torch.einsum("sbnd,sdo->bnso", streams, p(f"w_{layer}"))
        streams = aggregate(u, p(f"b_{layer}"))
    return streams[:g] + streams[g:]


def attn_gate_streams(x: torch.Tensor, h: torch.Tensor, graph: GraphTensors,
                      param: Callable[[str], torch.Tensor], n_gates: int, n_layers: int,
                      dropout: float, training: bool, generator: Optional[torch.Generator],
                      dtype: torch.dtype) -> torch.Tensor:
    """``conv_x_g(X) + conv_h_g(H)`` for ``n_gates`` TransformerConv gate
    stacks (heads 1, mean over heads, root-weight skip), the 2·G per-gate
    streams as extra heads of one attention call per conv layer, from the
    fused-layout parameters that ``param(name)`` returns (layer 0:
    ``w_{q,k,v,s}_{x,h}_0`` (g, f, d), ``b_*`` (g, d), ``w_e_x_0``/``w_e_h_0``
    (g, A, d); layer l ≥ 1: ``w_{q,k,v,s}_l`` (2g, d, d), ``b_*_l`` (2g, d),
    ``w_e_l`` (2g, A, d)). Attention dropout draws one keep value per
    (stream, slot or edge), so every gate of either side has a mask of its
    own, as the JAX package's per-gate ``split_rngs`` give it. Returns
    (n_gates, B, N, d)."""
    g = n_gates
    s = 2 * g
    b, n = x.shape[:2]
    x, h = x.to(dtype), h.to(dtype)

    def p(name):  # a master parameter in the compute dtype
        return param(name).to(dtype)

    def proj0(name):  # per-gate projections of X and of H → (B, N, 2g, width)
        return torch.cat([
            torch.einsum("bnf,gfo->bngo", src, p(f"w_{name}_{side}_0"))
            + p(f"b_{name}_{side}_0")
            for side, src in (("x", x), ("h", h))
        ], dim=2)

    def proj(name, streams, layer):  # per-stream projection (B, N, 2g, ·)
        return (torch.einsum("bnsf,sfo->bnso", streams, p(f"w_{name}_{layer}"))
                + p(f"b_{name}_{layer}"))

    def attend(q_all, k_all, v_all, we_all):  # streams as heads → (B, N, 2g, d)
        d = q_all.shape[-1]
        we = we_all.permute(1, 0, 2).reshape(we_all.shape[1], s * d)
        # heads = 1 per stream: the mean over heads is the identity
        return multi_stream_attention(
            q_all.reshape(b, n, s * d), k_all.reshape(b, n, s * d),
            v_all.reshape(b, n, s * d), we, graph, s, d,
            dropout=dropout, training=training, generator=generator,
        )

    we0 = torch.cat([p("w_e_x_0"), p("w_e_h_0")], dim=0)
    streams = attend(proj0("q"), proj0("k"), proj0("v"), we0) + proj0("s")
    for layer in range(1, n_layers):
        streams = attend(proj("q", streams, layer), proj("k", streams, layer),
                         proj("v", streams, layer), p(f"w_e_{layer}")) \
            + proj("s", streams, layer)
    streams = streams.permute(2, 0, 1, 3)  # (2g, B, N, d)
    return streams[:g] + streams[g:]


class FusedGateConvStack(nn.Module):
    """``conv_x_g(X) + conv_h_g(H)`` for ``n_gates`` gates with shared
    aggregations, ChebConv (:func:`cheb_gate_streams`) or GCNConv
    (:func:`gcn_gate_streams`, ``convolution_type="GCNConv"``). Returns
    (n_gates, B, N, out_channels). Parameter names and shapes follow the
    flax module: ChebConv ``w_x_0`` (g, K, fx, d), ``w_h_0``, ``b_x_0`` (g,
    d), ``b_h_0``, then ``w_l`` (2g, K, d, d), ``b_l``; GCNConv the same
    without the tap axis K. ``dtype`` is the compute dtype: x, h and each
    float32 master parameter are cast to it at use, as flax's ``dtype``
    does."""

    def __init__(self, x_channels: int, h_channels: int, out_channels: int,
                 n_layers: int = 1, n_gates: int = 4, K: int = 3,
                 lambda_max: float = 2.0, dtype: torch.dtype = torch.float32,
                 convolution_type: str = "ChebConv"):
        super().__init__()
        if convolution_type not in ("GCNConv", "ChebConv"):
            raise ValueError(f"FusedGateConvStack runs GCNConv or ChebConv, not "
                             f"{convolution_type!r}")
        g, d = n_gates, out_channels
        self.convolution_type = convolution_type
        self.n_gates, self.K, self.n_layers = g, K, n_layers
        self.lambda_max = lambda_max
        self.dtype = dtype
        taps = (K,) if convolution_type == "ChebConv" else ()
        self.w_x_0 = nn.Parameter(torch.zeros(g, *taps, x_channels, d))
        self.w_h_0 = nn.Parameter(torch.zeros(g, *taps, h_channels, d))
        self.b_x_0 = nn.Parameter(torch.zeros(g, d))
        self.b_h_0 = nn.Parameter(torch.zeros(g, d))
        for layer in range(1, n_layers):
            self.register_parameter(f"w_{layer}", nn.Parameter(torch.zeros(2 * g, *taps, d, d)))
            self.register_parameter(f"b_{layer}", nn.Parameter(torch.zeros(2 * g, d)))

    def forward(self, x: torch.Tensor, h: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.convolution_type == "GCNConv":
            return gcn_gate_streams(x, h, graph, partial(getattr, self), self.n_gates,
                                    self.n_layers, self.dtype)
        return cheb_gate_streams(x, h, graph, partial(getattr, self), self.n_gates, self.K,
                                 self.lambda_max, self.n_layers, self.dtype)


class FusedAttnGateStack(nn.Module):
    """``conv_x_g(X) + conv_h_g(H)`` for ``n_gates`` gates where the conv
    is TransformerConv (:func:`attn_gate_streams`). Returns (n_gates, B, N,
    out_channels).

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
        return attn_gate_streams(x, h, graph, partial(getattr, self), self.n_gates, self.n_layers,
                                 self.dropout, self.training, generator, self.dtype)


# ------------------------------------------------------------ per-gate layout


class GateLinear(nn.Module):
    """One Dense layer per gate: ``weight`` (g, out, in), each gate's slice
    in ``nn.Linear``'s layout (the flax kernel (g, in, out) transposed),
    and ``bias`` (g, out) unless ``bias=False``."""

    def __init__(self, n_gates: int, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_gates, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(n_gates, out_features)) if bias else None

    def kernel(self) -> torch.Tensor:
        """The flax layout (g, in, out)."""
        return self.weight.transpose(-1, -2)


class _PerGateLayer(nn.Module):
    """One conv layer of a per-gate stack: the flax conv's parameters with
    a leading gate axis. GCNConv: ``lin`` (no bias) and ``bias`` (g, d);
    ChebConv: ``lin_0`` … ``lin_{K-1}`` (no bias) and ``bias`` (g, d);
    TransformerConv: ``lin_query``, ``lin_key``, ``lin_value``,
    ``lin_skip`` (with bias) and ``lin_edge`` (A → d, no bias)."""

    def __init__(self, convolution_type: str, n_gates: int, in_channels: int, d: int):
        super().__init__()
        if convolution_type == "GCNConv":
            self.lin = GateLinear(n_gates, in_channels, d, bias=False)
            self.bias = nn.Parameter(torch.zeros(n_gates, d))
        elif convolution_type == "ChebConv":
            for k in range(CONVOLUTION_KWARGS["ChebConv"]["K"]):
                self.add_module(f"lin_{k}", GateLinear(n_gates, in_channels, d, bias=False))
            self.bias = nn.Parameter(torch.zeros(n_gates, d))
        else:
            for name in ("lin_query", "lin_key", "lin_value", "lin_skip"):
                self.add_module(name, GateLinear(n_gates, in_channels, d))
            a = CONVOLUTION_KWARGS["TransformerConv"]["edge_dim"]
            self.lin_edge = GateLinear(n_gates, a, d, bias=False)


class PerGateStack(nn.Module):
    """The per-gate ``conv_x`` or ``conv_h`` of a GConvLSTM: ``n_layers``
    conv layers ``conv_0`` … (no nonlinearity in between), each with a
    leading gate axis on every parameter, as the JAX package's vmapped
    ``GraphConv``. It holds parameters only: :func:`fused_from_per_gate`
    turns a pair of them into the fused stacks' parameters, which run the
    gates."""

    def __init__(self, convolution_type: str, in_channels: int, out_channels: int,
                 n_layers: int = 1, n_gates: int = 4):
        super().__init__()
        for layer in range(n_layers):
            self.add_module(f"conv_{layer}", _PerGateLayer(
                convolution_type, n_gates, in_channels if layer == 0 else out_channels,
                out_channels))
        self.n_layers = n_layers

    def conv(self, layer: int) -> _PerGateLayer:
        return getattr(self, f"conv_{layer}")


_ATTN_LINEARS = (("q", "lin_query"), ("k", "lin_key"), ("v", "lin_value"), ("s", "lin_skip"))


def fused_from_per_gate(conv_x: PerGateStack, conv_h: PerGateStack,
                        convolution_type: str) -> Dict[str, torch.Tensor]:
    """The fused stacks' parameters (``FusedGateConvStack``'s or
    ``FusedAttnGateStack``'s names) from a per-gate pair, by stacking and
    concatenation only, so their gradients flow back to the per-gate
    leaves: layer 0 keeps the X and H sides apart, deeper layers stack the
    X streams before the H streams (the JAX package's
    ``tests/test_fused.py`` transplant)."""
    out = {}
    sides = (("x", conv_x), ("h", conv_h))
    if convolution_type in ("GCNConv", "ChebConv"):
        k_taps = CONVOLUTION_KWARGS["ChebConv"]["K"]

        def weight(layer):  # GCN (g, in, d); Chebyshev (g, K, in, d)
            if convolution_type == "GCNConv":
                return layer.lin.kernel()
            return torch.stack([getattr(layer, f"lin_{k}").kernel() for k in range(k_taps)], 1)

        for side, stack in sides:
            out[f"w_{side}_0"] = weight(stack.conv(0))
            out[f"b_{side}_0"] = stack.conv(0).bias
        for layer in range(1, conv_x.n_layers):
            out[f"w_{layer}"] = torch.cat([weight(conv_x.conv(layer)),
                                           weight(conv_h.conv(layer))])
            out[f"b_{layer}"] = torch.cat([conv_x.conv(layer).bias, conv_h.conv(layer).bias])
        return out
    for short, lin in _ATTN_LINEARS:
        for side, stack in sides:
            out[f"w_{short}_{side}_0"] = getattr(stack.conv(0), lin).kernel()
            out[f"b_{short}_{side}_0"] = getattr(stack.conv(0), lin).bias
    for side, stack in sides:
        out[f"w_e_{side}_0"] = stack.conv(0).lin_edge.kernel()
    for layer in range(1, conv_x.n_layers):
        lx, lh = conv_x.conv(layer), conv_h.conv(layer)
        for short, lin in _ATTN_LINEARS:
            out[f"w_{short}_{layer}"] = torch.cat([getattr(lx, lin).kernel(),
                                                   getattr(lh, lin).kernel()])
            out[f"b_{short}_{layer}"] = torch.cat([getattr(lx, lin).bias, getattr(lh, lin).bias])
        out[f"w_e_{layer}"] = torch.cat([lx.lin_edge.kernel(), lh.lin_edge.kernel()])
    return out
