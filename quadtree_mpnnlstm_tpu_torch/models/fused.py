"""Fused multi-gate graph convolutions.

Counterpart of ``FusedGateConvStack`` (GCNConv and ChebConv branches)
and ``FusedAttnGateStack`` (TransformerConv and MHTransformerConv
branches) in ``quadtree_mpnnlstm_tpu/models/fused.py``. A GConvLSTM
evaluates ``conv_x_g(X) + conv_h_g(H)`` for four gates (a GConvGRU for
two, then one). The aggregation Â·z is
weight-free and feature-wise linear, so parallel streams share it by
feature concatenation. The Chebyshev polynomials depend only on the stack
input, so layer 0 computes the K tensors once on ``[X ‖ H]`` for all gates
and both sides and applies per-gate weights as einsums, and deeper layers
aggregate once per tap over all 2·G streams. GCN applies each stream's
weights first and then aggregates all 2·G streams in one Â·z per conv
layer. Attention coefficients depend on each stream, so there the 2·G
streams (each with its heads) run as extra heads of one attention call
per conv layer; MHTransformerConv concatenates each stream's heads and
mixes them back down per stream.

The per-gate layout (``fused_gates=False``: the JAX package's vmapped
``conv_x``/``conv_h`` stacks of ``models/cells.py`` ``gate_conv_module``,
each leaf with a leading gate axis) keeps its own parameters
(:class:`PerGateStack`) and runs through the same arithmetic: its weights
are stacked into the fused layout at every call (:func:`fused_from_per_gate`),
so a cell launches one Â·z per Chebyshev tap or GCN layer, or one
attention call per conv layer, for all gates, not one per gate. The two
sides may hold different gate counts (a per-gate GRU's ``conv_x`` has
three, its ``conv_h`` two). GAT and GATv2 have no fused stack in the JAX
package: they always take the per-gate layout, and their 2·G gate streams
run as heads of one self-loop edge pass per conv layer
(:func:`gat_gate_streams`). The JAX package's ``tests/test_fused.py``
proves the two layouts equal by transplanting weights.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.models.conv import (
    CONVOLUTION_KWARGS,
    a_mul,
    check_edge_mesh,
    gat_attend,
    gat_logits,
    multi_stream_attention,
    with_self_loops,
)

FUSABLE = ("GCNConv", "ChebConv")
ATTN_FUSABLE = ("TransformerConv", "MHTransformerConv")


def side_gates(param: Callable[[str], torch.Tensor], name: str) -> Tuple[int, int]:
    """The gate counts of the X and H sides, from the leading axis of the
    layer-0 parameters ``{name}_x_0`` and ``{name}_h_0``."""
    return param(f"{name}_x_0").shape[0], param(f"{name}_h_0").shape[0]


def cheb_gate_streams(x: torch.Tensor, h: torch.Tensor, graph: GraphTensors,
                      param: Callable[[str], torch.Tensor], K: int,
                      lambda_max: float, n_layers: int, dtype: torch.dtype) -> torch.Tensor:
    """The streams ``conv_x_g(X)`` and ``conv_h_g(H)`` of ChebConv gate
    stacks with shared aggregations, from the fused-layout parameters that
    ``param(name)`` returns (``w_x_0`` (gx, K, fx, d), ``w_h_0`` (gh, K,
    fh, d), ``b_x_0`` (gx, d), ``b_h_0``, then ``w_l`` (gx + gh, K, d, d),
    ``b_l``). x, h and every parameter are cast to ``dtype`` at use.
    Returns (gx + gh, B, N, d), the X streams first."""
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
    return streams


def gcn_gate_streams(x: torch.Tensor, h: torch.Tensor, graph: GraphTensors,
                     param: Callable[[str], torch.Tensor], n_layers: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """The streams of GCNConv gate stacks: each stream's weights first,
    then one Â·z over all streams side by side (width (gx + gh)·d) per conv
    layer, from the fused-layout parameters that ``param(name)`` returns
    (``w_x_0`` (gx, fx, d), ``w_h_0`` (gh, fh, d), ``b_x_0`` (gx, d),
    ``b_h_0``, then ``w_l`` (gx + gh, d, d), ``b_l``). x, h and every
    parameter are cast to ``dtype`` at use. Returns (gx + gh, B, N, d),
    the X streams first."""
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
    return streams


def attn_gate_streams(x: torch.Tensor, h: torch.Tensor, graph: GraphTensors,
                      param: Callable[[str], torch.Tensor], n_layers: int,
                      dropout: float, training: bool, generator: Optional[torch.Generator],
                      dtype: torch.dtype, heads: int = 1, mh: bool = False) -> torch.Tensor:
    """The streams of TransformerConv gate stacks (``heads`` heads, their
    mean, a root-weight skip of width d) or, with ``mh``, of
    MHTransformerConv gate stacks (``heads`` heads concatenated, a skip of
    width heads·d, then a per-stream head-mixing Dense ``w_mix_l`` (s, hd,
    d), ``b_mix_l``). Every stream's heads run as heads of one attention
    call per conv layer (s·heads heads), from the fused-layout parameters
    that ``param(name)`` returns (layer 0: ``w_{q,k,v,s}_{x,h}_0`` (g, f,
    width), ``b_*`` (g, width), ``w_e_x_0``/``w_e_h_0`` (g, A, hd); layer
    l ≥ 1: ``w_{q,k,v,s}_l`` (s, d, width), ``b_*_l``, ``w_e_l`` (s, A,
    hd)). Attention dropout draws one keep value per (stream, head, slot
    or edge), so every gate of either side has a mask of its own, as the
    JAX package's per-gate ``split_rngs`` give it. Returns (gx + gh, B, N,
    d), the X streams first."""
    s = sum(side_gates(param, "w_q"))
    b, n = x.shape[:2]
    x, h = x.to(dtype), h.to(dtype)

    def p(name):  # a master parameter in the compute dtype
        return param(name).to(dtype)

    def proj0(name):  # per-gate projections of X and of H → (B, N, s, width)
        return torch.cat([
            torch.einsum("bnf,gfo->bngo", src, p(f"w_{name}_{side}_0"))
            + p(f"b_{name}_{side}_0")
            for side, src in (("x", x), ("h", h))
        ], dim=2)

    def proj(name, streams, layer):  # per-stream projection (B, N, s, ·)
        return (torch.einsum("bnsf,sfo->bnso", streams, p(f"w_{name}_{layer}"))
                + p(f"b_{name}_{layer}"))

    def attend(q_all, k_all, v_all, we_all):  # streams' heads as heads → (B, N, s, ·)
        hd = q_all.shape[-1]
        d = hd // heads
        we = we_all.permute(1, 0, 2).reshape(we_all.shape[1], s * hd)
        out = multi_stream_attention(
            q_all.reshape(b, n, s * hd), k_all.reshape(b, n, s * hd),
            v_all.reshape(b, n, s * hd), we, graph, s * heads, d,
            dropout=dropout, training=training, generator=generator,
        ).reshape(b, n, s, heads, d)
        return out.reshape(b, n, s, hd) if mh else out.mean(dim=-2)

    def mix(streams, layer):
        return proj("mix", streams, layer) if mh else streams

    we0 = torch.cat([p("w_e_x_0"), p("w_e_h_0")], dim=0)
    streams = mix(attend(proj0("q"), proj0("k"), proj0("v"), we0) + proj0("s"), 0)
    for layer in range(1, n_layers):
        streams = mix(attend(proj("q", streams, layer), proj("k", streams, layer),
                             proj("v", streams, layer), p(f"w_e_{layer}"))
                      + proj("s", streams, layer), layer)
    return streams.permute(2, 0, 1, 3)  # (s, B, N, d)


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
            streams = gcn_gate_streams(x, h, graph, partial(getattr, self), self.n_layers,
                                       self.dtype)
        else:
            streams = cheb_gate_streams(x, h, graph, partial(getattr, self), self.K,
                                        self.lambda_max, self.n_layers, self.dtype)
        return streams[:self.n_gates] + streams[self.n_gates:]


class FusedAttnGateStack(nn.Module):
    """``conv_x_g(X) + conv_h_g(H)`` for ``n_gates`` gates where the conv
    is TransformerConv or MHTransformerConv (:func:`attn_gate_streams`).
    Returns (n_gates, B, N, out_channels).

    Parameter names and shapes follow the flax module, with hd = heads·d
    and the skip width hd for MHTransformerConv, d for TransformerConv:
    layer 0 has ``w_{q,k,v}_{x,h}_0`` (g, f, hd) with biases ``b_*`` (g,
    hd), the edge projections ``w_e_x_0``/``w_e_h_0`` (g, A, hd) and the
    skip ``w_s_{x,h}_0``/``b_s_{x,h}_0``; layer l ≥ 1 has
    ``w_{q,k,v}_l`` (2g, d, hd), ``w_s_l``, their biases and ``w_e_l``
    (2g, A, hd); MHTransformerConv adds ``w_mix_l`` (2g, hd, d) and
    ``b_mix_l`` (2g, d) to every layer. ``dtype`` is the compute dtype:
    x, h and each float32 master parameter are cast to it at use, as
    flax's ``dtype`` does.
    """

    def __init__(self, x_channels: int, h_channels: int, out_channels: int,
                 n_layers: int = 1, n_gates: int = 4, dtype: torch.dtype = torch.float32,
                 convolution_type: str = "TransformerConv"):
        super().__init__()
        if convolution_type not in ATTN_FUSABLE:
            raise ValueError(f"FusedAttnGateStack runs {ATTN_FUSABLE}, not {convolution_type!r}")
        kwargs = CONVOLUTION_KWARGS[convolution_type]
        self.mh = convolution_type == "MHTransformerConv"
        self.heads = kwargs["heads"]
        g, d, a = n_gates, out_channels, kwargs["edge_dim"]
        hd = self.heads * d
        skip = hd if self.mh else d
        self.n_gates, self.n_layers, self.dropout = g, n_layers, kwargs["dropout"]
        self.dtype = dtype

        def add(name, *shape):
            self.register_parameter(name, nn.Parameter(torch.zeros(*shape)))

        widths = (("q", hd), ("k", hd), ("v", hd), ("s", skip))
        for name, width in widths:
            for side, f in (("x", x_channels), ("h", h_channels)):
                add(f"w_{name}_{side}_0", g, f, width)
                add(f"b_{name}_{side}_0", g, width)
        add("w_e_x_0", g, a, hd)
        add("w_e_h_0", g, a, hd)
        for layer in range(n_layers):
            if layer:
                for name, width in widths:
                    add(f"w_{name}_{layer}", 2 * g, d, width)
                    add(f"b_{name}_{layer}", 2 * g, width)
                add(f"w_e_{layer}", 2 * g, a, hd)
            if self.mh:
                add(f"w_mix_{layer}", 2 * g, hd, d)
                add(f"b_mix_{layer}", 2 * g, d)

    def forward(self, x: torch.Tensor, h: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        streams = attn_gate_streams(x, h, graph, partial(getattr, self), self.n_layers,
                                    self.dropout, self.training, generator, self.dtype,
                                    self.heads, self.mh)
        return streams[:self.n_gates] + streams[self.n_gates:]


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


def _add_attn_linears(module: nn.Module, n_gates: int, in_channels: int, width: int,
                      skip: int, a: int) -> None:
    """A per-gate TransformerConv's leaves: ``lin_query``, ``lin_key``,
    ``lin_value`` (in → width), ``lin_skip`` (in → skip), with bias, and
    ``lin_edge`` (A → width, no bias)."""
    for name in ("lin_query", "lin_key", "lin_value"):
        module.add_module(name, GateLinear(n_gates, in_channels, width))
    module.lin_skip = GateLinear(n_gates, in_channels, skip)
    module.lin_edge = GateLinear(n_gates, a, width, bias=False)


class _PerGateLayer(nn.Module):
    """One conv layer of a per-gate stack: the flax conv's parameters with
    a leading gate axis. GCNConv: ``lin`` (no bias) and ``bias`` (g, d);
    ChebConv: ``lin_0`` … ``lin_{K-1}`` (no bias) and ``bias`` (g, d);
    TransformerConv: ``lin_query``, ``lin_key``, ``lin_value``,
    ``lin_skip`` (with bias) and ``lin_edge`` (A → d, no bias);
    MHTransformerConv: ``conv`` holding those at width hd = heads·d (the
    skip too) and ``lin`` (hd → d, with bias); GATConv: ``lin`` (no bias),
    ``att_src``, ``att_dst`` (g, 1, heads, d), ``lin_edge`` (A → hd, no
    bias), ``att_edge`` and ``bias`` (g, hd); GATv2Conv: ``lin_l``,
    ``lin_r`` (with bias), ``lin_edge``, ``att`` and ``bias``. ``a`` is the
    graph's edge-attribute width."""

    def __init__(self, convolution_type: str, n_gates: int, in_channels: int, d: int, a: int):
        super().__init__()
        g = n_gates
        heads = CONVOLUTION_KWARGS[convolution_type].get("heads", 1)
        hd = heads * d

        def att():
            return nn.Parameter(torch.zeros(g, 1, heads, d))

        if convolution_type == "GCNConv":
            self.lin = GateLinear(g, in_channels, d, bias=False)
            self.bias = nn.Parameter(torch.zeros(g, d))
        elif convolution_type == "ChebConv":
            for k in range(CONVOLUTION_KWARGS["ChebConv"]["K"]):
                self.add_module(f"lin_{k}", GateLinear(g, in_channels, d, bias=False))
            self.bias = nn.Parameter(torch.zeros(g, d))
        elif convolution_type == "TransformerConv":
            _add_attn_linears(self, g, in_channels, d, d, a)
        elif convolution_type == "MHTransformerConv":
            self.conv = nn.Module()
            _add_attn_linears(self.conv, g, in_channels, hd, hd, a)
            self.lin = GateLinear(g, hd, d)
        elif convolution_type == "GATConv":
            self.lin = GateLinear(g, in_channels, hd, bias=False)
            self.att_src, self.att_dst = att(), att()
            self.lin_edge = GateLinear(g, a, hd, bias=False)
            self.att_edge = att()
            self.bias = nn.Parameter(torch.zeros(g, hd))
        elif convolution_type == "GATv2Conv":
            self.lin_l = GateLinear(g, in_channels, hd)
            self.lin_r = GateLinear(g, in_channels, hd)
            self.lin_edge = GateLinear(g, a, hd, bias=False)
            self.att = att()
            self.bias = nn.Parameter(torch.zeros(g, hd))
        else:
            raise ValueError(f"no per-gate layer of {convolution_type!r}")


class PerGateStack(nn.Module):
    """The per-gate ``conv_x`` or ``conv_h`` of a cell: ``n_layers`` conv
    layers ``conv_0`` … (no nonlinearity in between), each with a leading
    gate axis on every parameter, as the JAX package's vmapped
    ``GraphConv``; ``"Dummy"`` has none (the identity on every gate). It
    holds parameters only: :func:`gate_streams` runs a pair of them. The
    registry's attention dropout is read when the stack is built, as the
    fused stacks read it. ``attr_dim`` is the graph's edge-attribute
    width."""

    def __init__(self, convolution_type: str, in_channels: int, out_channels: int,
                 n_layers: int = 1, n_gates: int = 4, attr_dim: int = 2):
        super().__init__()
        self.convolution_type, self.n_gates = convolution_type, n_gates
        self.n_layers = 0 if convolution_type == "Dummy" else n_layers
        self.dropout = CONVOLUTION_KWARGS[convolution_type].get("dropout", 0.0)
        for layer in range(self.n_layers):
            self.add_module(f"conv_{layer}", _PerGateLayer(
                convolution_type, n_gates, in_channels if layer == 0 else out_channels,
                out_channels, attr_dim))

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
    if convolution_type in FUSABLE:
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
    mh = convolution_type == "MHTransformerConv"

    def attn(stack, layer):  # the TransformerConv leaves of a layer
        return stack.conv(layer).conv if mh else stack.conv(layer)

    for short, lin in _ATTN_LINEARS:
        for side, stack in sides:
            out[f"w_{short}_{side}_0"] = getattr(attn(stack, 0), lin).kernel()
            out[f"b_{short}_{side}_0"] = getattr(attn(stack, 0), lin).bias
    for side, stack in sides:
        out[f"w_e_{side}_0"] = attn(stack, 0).lin_edge.kernel()
    for layer in range(conv_x.n_layers):
        lx, lh = attn(conv_x, layer), attn(conv_h, layer)
        if layer:
            for short, lin in _ATTN_LINEARS:
                out[f"w_{short}_{layer}"] = torch.cat([getattr(lx, lin).kernel(),
                                                       getattr(lh, lin).kernel()])
                out[f"b_{short}_{layer}"] = torch.cat([getattr(lx, lin).bias,
                                                       getattr(lh, lin).bias])
            out[f"w_e_{layer}"] = torch.cat([lx.lin_edge.kernel(), lh.lin_edge.kernel()])
        if mh:
            mx, mh_ = conv_x.conv(layer).lin, conv_h.conv(layer).lin
            out[f"w_mix_{layer}"] = torch.cat([mx.kernel(), mh_.kernel()])
            out[f"b_mix_{layer}"] = torch.cat([mx.bias, mh_.bias])
    return out


def gat_gate_streams(x: torch.Tensor, h: torch.Tensor, graph: GraphTensors,
                     conv_x: PerGateStack, conv_h: PerGateStack, dtype: torch.dtype
                     ) -> torch.Tensor:
    """The streams of a per-gate pair of GATConv or GATv2Conv stacks: every
    head of every gate of both sides runs as a head of one pass over the
    mesh's self-loop list per conv layer (one edge softmax, one K7 sum),
    each stream with its gate's projections, att vectors, edge projection
    and bias. Layer 0 projects X for the X gates and H for the H gates;
    deeper layers project each stream's own output. Returns (gx + gh, B,
    N, heads·d), the X streams first."""
    check_edge_mesh(graph)
    v2 = conv_x.convolution_type == "GATv2Conv"
    loops = graph.self_loops if graph.self_loops is not None else with_self_loops(graph)
    b, n = x.shape[:2]
    x, h = x.to(dtype), h.to(dtype)
    attr = loops.attr.to(dtype)
    d = conv_x.conv(0).att.shape[-1] if v2 else conv_x.conv(0).att_src.shape[-1]
    streams = None

    def both(layer, get):  # a leaf of every stream: X gates, then H gates
        return torch.cat([get(conv_x.conv(layer)), get(conv_h.conv(layer))]).to(dtype)

    def proj(layer, name):  # (B, N, S, hd)
        def bias(lin):
            return 0.0 if lin.bias is None else lin.bias.to(dtype)

        if layer == 0:
            return torch.cat([
                torch.einsum("bnf,gfo->bngo", src, getattr(stack.conv(0), name).kernel().to(dtype))
                + bias(getattr(stack.conv(0), name))
                for src, stack in ((x, conv_x), (h, conv_h))], dim=2)
        lins = (getattr(conv_x.conv(layer), name), getattr(conv_h.conv(layer), name))
        w = torch.cat([lin.kernel() for lin in lins]).to(dtype)
        out = torch.einsum("bnsf,sfo->bnso", streams, w)
        if lins[0].bias is not None:
            out = out + torch.cat([lin.bias for lin in lins]).to(dtype)
        return out

    for layer in range(conv_x.n_layers):
        x_l = proj(layer, "lin_l" if v2 else "lin")
        s, hd = x_l.shape[2:]
        heads = hd // d

        def heads_view(t):
            return t.reshape(t.shape[:-2] + (s * heads, d))

        def att(name):
            return both(layer, lambda lay: getattr(lay, name)).reshape(s * heads, d)

        e = heads_view(torch.einsum("blf,sfo->blso", attr,
                                    both(layer, lambda lay: lay.lin_edge.kernel())))
        if v2:
            logits = gat_logits(loops, n, True, 0.2, heads_view(x_l),
                                heads_view(proj(layer, "lin_r")), e, att("att"), None, None)
        else:
            logits = gat_logits(loops, n, False, 0.2, heads_view(x_l), None, e, att("att_src"),
                                att("att_dst"), att("att_edge"))
        out = gat_attend(loops, n, heads_view(x_l), logits).reshape(b, n, s, hd)
        streams = out + both(layer, lambda lay: lay.bias)
    return streams.permute(2, 0, 1, 3)


def gate_streams(x: torch.Tensor, h: torch.Tensor, graph: GraphTensors, conv_x: PerGateStack,
                 conv_h: PerGateStack, dtype: torch.dtype, training: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The streams ``conv_x_g(X)`` and ``conv_h_g(H)`` of a per-gate pair,
    (gx + gh, B, N, d), the X streams first: GCN, Chebyshev and attention
    stacks through the fused arithmetic on their weights stacked by
    :func:`fused_from_per_gate`, GAT stacks by :func:`gat_gate_streams`,
    ``Dummy`` as X and H themselves on every gate."""
    conv = conv_x.convolution_type
    if conv == "Dummy":
        return torch.stack([x.to(dtype)] * conv_x.n_gates + [h.to(dtype)] * conv_h.n_gates)
    if conv in ("GATConv", "GATv2Conv"):
        return gat_gate_streams(x, h, graph, conv_x, conv_h, dtype)
    params = fused_from_per_gate(conv_x, conv_h, conv).__getitem__
    layers = conv_x.n_layers
    if conv == "GCNConv":
        return gcn_gate_streams(x, h, graph, params, layers, dtype)
    if conv == "ChebConv":
        return cheb_gate_streams(x, h, graph, params, CONVOLUTION_KWARGS["ChebConv"]["K"],
                                 2.0, layers, dtype)  # ChebConv's λmax
    return attn_gate_streams(x, h, graph, params, layers, conv_x.dropout, training, generator,
                             dtype, CONVOLUTION_KWARGS[conv]["heads"],
                             conv == "MHTransformerConv")
