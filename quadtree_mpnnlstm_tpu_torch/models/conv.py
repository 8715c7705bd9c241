"""Graph convolutions over per-sample padded meshes.

Counterpart of ``quadtree_mpnnlstm_tpu/models/conv.py``: the symmetric
normalisation, the ``Â z`` dispatch, ``GCNConv`` (no self-loops, the
symmetric degree norm with the distance column as edge weight),
``ChebConv`` (K=3, 'sym' laplacian, lambda_max=2), the attention-window,
grid and edge-list branches of ``multi_stream_attention``,
``TransformerConv`` (heads=1, edge_dim=2, attention dropout 0.1, concat
off in the registry), ``MHTransformerConv`` (3 concatenated heads mixed
back down by a Dense layer), ``GATConv``/``GATv2Conv`` (one head, edge
features, a self-loop per valid node with the mean edge attributes, on
edge lists only), ``GraphConv`` (a stack of one conv type; ``Dummy`` is
the identity) and the α side channel (``attention_map``,
``dump_attention_map``). Node tensors are (B, n_max, F). Every conv
takes ``(x, graph, generator)``; attention dropout draws its keep windows
(or planes, or per-edge hashes) from ``generator`` in training mode
(``module.train()``) only. Every conv and every branch runs in the
compute dtype it is given (f32 or bf16).

A shared mesh (``TrainConfig.shared_mesh``) keeps this (B, n_max, F)
layout: its graph holds one mesh for the batch (``graph/static.py``
``expand_graph``), whose Â blocks and attention windows the kernels read
for every sample, so each conv runs as on per-sample meshes. The JAX
package folds the batch into the feature axis (Â) or the heads
(attention) instead; each sample's columns add the same terms in the same
order either way. The edge-list ``Â z`` honours the graph's message dtype
and degree cap (``GraphConfig.message_dtype``, ``max_degree``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.ops import attn, grid_attn, spmm
from quadtree_mpnnlstm_tpu_torch.ops.grid import grid_a_mul
from quadtree_mpnnlstm_tpu_torch.ops.segment import (
    aggregate_to_dst,
    edge_softmax,
    edge_softmax_graph,
    gather_dst,
    gather_nodes,
    gather_src,
    safe_div,
    segment_sum_nodes,
)
from quadtree_mpnnlstm_tpu_torch.ops.segment_sum import SegmentView, segment_view
from quadtree_mpnnlstm_tpu_torch.utils.draws import sample_offset, uniform


def compute_sym_norm(graph: GraphTensors) -> torch.Tensor:
    """D^{-1/2} A D^{-1/2} coefficient per edge (B, e_max); the scalar edge
    weight is the last edge-attribute column (distance), 0 where invalid.
    With a degree cap the degree sums each node's first ``max_degree``
    edges, as the JAX package's CSR sum does.

    ``dinv`` is indexed with the clamped edge ids: the sentinel ``n_max``
    would be out of range (JAX clamps it silently; torch raises), and its
    weight is 0 either way.
    """
    n = graph.n_max
    w = graph.edge_attr[..., -1] * graph.edge_valid
    if graph.max_degree > 0:
        deg = segment_sum_nodes(w, graph.edge_dst_cap, n, graph.dst_cap_view)
    else:
        deg = segment_sum_nodes(w, graph.edge_dst, n, graph.dst_view)
    dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), 0.0)
    d_dst = torch.gather(dinv, 1, graph.edge_dst.clamp_max(n - 1))
    d_src = torch.gather(dinv, 1, graph.edge_src.clamp_max(n - 1))
    return d_dst * w * d_src


def a_mul(z: torch.Tensor, graph: GraphTensors) -> torch.Tensor:
    """``Â z`` for z (B, n_max, F), dispatched by the graph's backend:

      * ``pallas`` — the per-tile Â blocks (ops/spmm.py, kernel K2 on a CUDA
        tensor);
      * ``grid`` — the shift stencil of the pixelwise mesh (ops/grid.py);
      * otherwise — gather → scale → scatter-add over the edge list
        (ops/segment.py; kernel K7 on a CUDA tensor). With
        ``msg_dtype="bfloat16"`` (``GraphConfig.message_dtype``) the
        messages are cast to bf16, summed (K7's bf16 instance on a card)
        and the sum cast back to z's dtype.
    """
    if graph.agg[0] == "grid":
        return grid_a_mul(z, graph)
    if graph.agg[0] == "pallas":
        _, nt, _eb, sw = graph.agg
        return spmm.spmm_apply(z, graph.agg_meta, graph.n_max, nt, sw)
    msg = graph.sym_coeff[..., None].to(z.dtype) * gather_src(z, graph)
    if graph.msg_dtype == "bfloat16":
        return aggregate_to_dst(msg.to(torch.bfloat16), graph).to(z.dtype)
    return aggregate_to_dst(msg, graph)


class GCNConv(nn.Module):
    """Kipf-Welling GCN layer without self-loop insertion: ``Â (x W) +
    b``, with Â the symmetric-normalised adjacency of :func:`a_mul` (the
    Â blocks, the grid's stencil or the edge list). Parameters follow the
    flax module: ``lin`` (no bias) and ``bias``. ``dtype`` is the compute
    dtype: the input and each float32 master parameter are cast to it at
    use, as flax's ``dtype`` does."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.lin = nn.Linear(in_channels, out_channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = nn.functional.linear(x.to(self.dtype), self.lin.weight.to(self.dtype))
        out = a_mul(h, graph)
        return out + self.bias.to(out.dtype)


class ChebConv(nn.Module):
    """Chebyshev spectral conv, 'sym' normalisation. Parameters follow the
    flax module: ``lin_k`` (no bias) per tap and one ``bias``. ``dtype``
    is the compute dtype: the input and each float32 master parameter are
    cast to it at use, as flax's ``dtype`` does."""

    def __init__(self, in_channels: int, out_channels: int, K: int = 3,
                 lambda_max: float = 2.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.K = K
        self.lambda_max = lambda_max
        self.dtype = dtype
        for k in range(K):
            self.add_module(f"lin_{k}", nn.Linear(in_channels, out_channels, bias=False))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def lin(self, k: int) -> nn.Linear:
        return getattr(self, f"lin_{k}")

    def forward(self, x: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        scale = 2.0 / self.lambda_max
        x = x.to(self.dtype)

        def l_hat(z):
            # (2/λmax)(I - Â) - I applied to z
            return scale * (z - a_mul(z, graph)) - z

        def lin(k, z):
            return nn.functional.linear(z, self.lin(k).weight.to(self.dtype))

        tx_prev = x
        out = lin(0, tx_prev)
        if self.K > 1:
            tx = l_hat(x)
            out = out + lin(1, tx)
            for k in range(2, self.K):
                tx, tx_prev = 2.0 * l_hat(tx) - tx_prev, tx
                out = out + lin(k, tx)
        return out + self.bias.to(out.dtype)


def attr_dim(graph: GraphTensors) -> int:
    """Edge-attribute feature count of the mesh representation the graph
    carries (edge list, grid constants or attention windows)."""
    if graph.edge_attr is not None:
        return graph.edge_attr.shape[-1]
    if graph.grid_attr is not None:
        return graph.grid_attr.shape[-1]
    if graph.attn_meta is not None:
        return graph.attn_meta.attr.shape[-1]
    raise ValueError("graph carries no edge attributes")


_HASH_MASK = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit xor-shift-multiply finaliser on int64 tensors holding
    values in [0, 2**32); its multipliers stay below 2**31, so no product
    leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _HASH_MASK
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _HASH_MASK
    return x ^ (x >> 16)


def edge_keep(graph: GraphTensors, heads: int, rate: float,
              generator: torch.Generator) -> torch.Tensor:
    """Dropout keep-scales (B, E, heads) of the edge-list attention: 0, or
    1/(1 − rate) with probability 1 − rate. One seed per call comes from
    ``generator``; each value is a counter-based hash of (seed, sample,
    src, dst, head), keyed by the edge's node ids and not by its slot, so
    the mask does not depend on the order of the slots (as the JAX
    package keys it, with its own random bits). The sample is its index
    in the global batch under data parallelism (``utils/draws.py``)."""
    dev = graph.edge_src.device
    seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                         device=generator.device).to(dev)
    b = graph.edge_src.shape[0]
    h = _mix32(seed + (torch.arange(b, device=dev) + sample_offset(b))[:, None])
    h = _mix32(h ^ graph.edge_src)
    h = _mix32(h ^ graph.edge_dst)
    h = _mix32(h[..., None] ^ torch.arange(heads, device=dev))
    u = (h >> 8).to(torch.float32) * 2.0**-24  # uniform on [0, 1)
    return (u < 1.0 - rate).to(torch.float32) / (1.0 - rate)


def edge_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, we: torch.Tensor,
                   graph: GraphTensors, heads: int, d: int,
                   keep: Optional[torch.Tensor] = None,
                   intermediates: Optional[Dict] = None) -> torch.Tensor:
    """The edge-list branch of :func:`multi_stream_attention`: gather k
    and v at the sources and q at the destinations, add the edge term
    ``edge_attr · Wₑ`` to keys and values, take per-head logits ``q·(k +
    e)/√d``, the masked edge softmax, the keep-scales (B, E, heads) when
    given, and sum ``α·(v + e)`` at the destinations (kernel K7 on a CUDA
    tensor). Everything runs in q's dtype: the keep-scales are cast to it,
    as the JAX package casts them to α's, so a bf16 call keeps its
    messages and their sum in bf16. With ``intermediates`` (a dict) α
    (B, E, heads) is appended to its ``"alpha"`` list, detached. Returns
    (B, n_max, heads, d)."""
    b, n = q.shape[:2]
    qh, kh, vh = (x.reshape(b, n, heads, d) for x in (q, k, v))
    e = (graph.edge_attr.to(q.dtype) @ we).reshape(b, -1, heads, d)
    kj = gather_src(kh, graph) + e
    vj = gather_src(vh, graph) + e
    # √d in q's dtype, as the JAX branch takes it (jnp.sqrt of d in that dtype)
    root_d = float(torch.tensor(float(d), dtype=q.dtype).sqrt())
    logits = (gather_dst(qh, graph) * kj).sum(dim=-1) / root_d
    alpha = edge_softmax_graph(logits, graph)
    sow(intermediates, alpha)
    used = alpha if keep is None else alpha * keep.to(alpha.dtype)
    return aggregate_to_dst(used[..., None] * vj, graph)


def sow(intermediates: Optional[Dict], alpha: torch.Tensor) -> None:
    """Append α, detached, to ``intermediates["alpha"]`` when the caller
    passed a dict (the JAX package's ``sow("intermediates", "alpha")``)."""
    if intermediates is not None:
        intermediates.setdefault("alpha", []).append(alpha.detach())


def multi_stream_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, we: Optional[torch.Tensor],
    graph: GraphTensors, heads: int, d: int, dropout: float = 0.0,
    training: bool = False, generator: Optional[torch.Generator] = None,
    intermediates: Optional[Dict] = None,
) -> torch.Tensor:
    """Destination-aggregated edge attention for ``heads`` independent
    streams packed on the feature axis: the implementation behind
    TransformerConv and the fused attention gate stacks (models/fused.py),
    where the 2·G gate convolutions of a cell run as extra heads of one
    call. Runs on the graph's attention windows (``agg = "pallas_attn"``;
    kernels K3/K4 on a CUDA tensor), on the pixelwise grid (``agg =
    "grid"``; kernels K5/K6) or on the edge list (:func:`edge_attention`).

    Dropout, in training mode only, keeps an entry with probability
    1 − rate and scales it by 1/(1 − rate), drawn from ``generator``: one
    value per window slot and head, a (B, T, heads, EB) keep window, as the
    JAX package's window path draws it; on the grid one per direction,
    pixel and head, (B, D, P, heads) planes, as its grid path does; on the
    edge list one per edge and head, keyed by the edge's (src, dst) node
    ids (:func:`edge_keep`).

    Args:
      q/k/v: (B, n_max, heads·d) projected node features.
      we: (A, heads·d) edge-projection weights, or None for no edge term.
      intermediates: a dict that receives α in its ``"alpha"`` list
        (:func:`sow`): (B, E, heads) on the edge list, (B, D, rows, cols,
        heads) on the grid, where K5 returns none and the plain stencil
        softmax computes it for this debug channel; the attention windows
        give none, as in the JAX package.
    Returns:
      (B, n_max, heads, d).
    """
    b, n = q.shape[:2]
    if we is None:
        we = q.new_zeros((attr_dim(graph), heads * d))
    drop = training and dropout > 0.0
    if drop and generator is None:
        raise ValueError("attention dropout in training mode needs an explicit torch.Generator")

    def keep_planes(shape):
        u = uniform(shape, generator, q.device)
        return (u < 1.0 - dropout).float() / (1.0 - dropout)

    if graph.agg[0] == "grid":
        _, rows, cols, ndirs = graph.agg
        # every direction's edges share one edge term (grid_attr @ Wₑ)
        e_dir = graph.grid_attr.to(q.dtype) @ we  # (D, heads·d)
        valid = graph.node_valid[0].to(q.dtype)   # the mask every sample shares
        keep = keep_planes((b, ndirs, n, heads)) if drop else None
        dims = grid_attn.GridAttnDims(rows, cols, heads, d, ndirs)
        if intermediates is not None:
            with torch.no_grad():
                sow(intermediates, grid_attn.grid_alpha(q, k, e_dir, valid, dims))
        return grid_attn.grid_attn_apply(q, k, v, e_dir, valid, keep, dims).reshape(
            b, n, heads, d)
    if graph.agg[0] == "pallas_attn":
        _, nt, eb, sw = graph.agg
        meta = graph.attn_meta
        keep = keep_planes((b, meta.s0.shape[1], heads, eb)) if drop else None
        dims = attn.AttnDims(n, nt, eb, sw, heads, d)
        return attn.attn_apply(q, k, v, we, keep, meta, dims, graph.slot_view).reshape(
            b, n, heads, d)
    if graph.edge_src is None:
        raise ValueError("attention needs attention windows, the pixelwise grid or an edge "
                         "list; this graph dropped its edge list (carry_edges=False)")
    keep = edge_keep(graph, heads, dropout, generator) if drop else None
    return edge_attention(q, k, v, we, graph, heads, d, keep, intermediates)


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``lin`` applied to x with its f32 master weight and bias cast to
    ``dtype`` at use, as flax's ``Dense(dtype=…)``."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return nn.functional.linear(x.to(dtype), lin.weight.to(dtype), bias)


class TransformerConv(nn.Module):
    """Graph transformer (UniMP-style) attention conv. Parameters follow
    the flax module: ``lin_query``, ``lin_key``, ``lin_value`` (with
    bias), ``lin_edge`` (no bias; the edge projection Wₑ is its kernel, what
    the flax module gets by applying it to the identity) and ``lin_skip``.
    ``dtype`` is the compute dtype: the input and each float32 master
    parameter (Wₑ included) are cast to it at use, as flax's ``dtype``
    does; the attention then runs on q, k, v and Wₑ in that dtype."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 concat: bool = True, dropout: float = 0.0, edge_dim: Optional[int] = None,
                 root_weight: bool = True, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.concat, self.dropout = concat, dropout
        self.dtype = dtype
        hd = heads * out_channels
        self.lin_query = nn.Linear(in_channels, hd)
        self.lin_key = nn.Linear(in_channels, hd)
        self.lin_value = nn.Linear(in_channels, hd)
        self.lin_edge = nn.Linear(edge_dim, hd, bias=False) if edge_dim is not None else None
        self.lin_skip = (nn.Linear(in_channels, hd if concat else out_channels, bias=use_bias)
                         if root_weight else None)

    def forward(self, x: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None,
                intermediates: Optional[Dict] = None) -> torch.Tensor:
        """``intermediates``: a dict that receives this call's α
        (:func:`multi_stream_attention`)."""
        h, d = self.heads, self.out_channels
        x = x.to(self.dtype)
        we = None if self.lin_edge is None else self.lin_edge.weight.t().to(self.dtype)  # (A, h·d)
        out = multi_stream_attention(
            dense(self.lin_query, x, self.dtype), dense(self.lin_key, x, self.dtype),
            dense(self.lin_value, x, self.dtype), we, graph, h, d,
            dropout=self.dropout, training=self.training, generator=generator,
            intermediates=intermediates,
        )
        out = out.reshape(out.shape[:-2] + (h * d,)) if self.concat else out.mean(dim=-2)
        if self.lin_skip is not None:
            out = out + dense(self.lin_skip, x, self.dtype)
        return out


class MHTransformerConv(nn.Module):
    """TransformerConv with concatenated heads mixed back down by a Dense
    layer: a :class:`TransformerConv` named ``conv`` (``heads`` heads,
    ``concat=True``) and ``lin`` (heads·d → d, with bias), as the flax
    module. ``dtype`` is the compute dtype."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 3,
                 dropout: float = 0.0, edge_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = TransformerConv(in_channels, out_channels, heads=heads, concat=True,
                                    dropout=dropout, edge_dim=edge_dim, dtype=dtype)
        self.lin = nn.Linear(heads * out_channels, out_channels)

    def forward(self, x: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None,
                intermediates: Optional[Dict] = None) -> torch.Tensor:
        return dense(self.lin, self.conv(x, graph, generator, intermediates), self.dtype)


class SelfLoops(NamedTuple):
    """A mesh's edge list with one self-edge per node appended (B, e_max +
    n_max): the GAT convolutions' index set. An invalid node's self-edge
    carries the sentinel ``n_max`` and is dropped. The CSR views of src and
    dst (the list is not sorted by dst) are built on a CUDA card, for K7."""

    src: torch.Tensor    # (B, L) int64
    dst: torch.Tensor    # (B, L) int64
    valid: torch.Tensor  # (B, L) bool
    attr: torch.Tensor   # (B, L, A) f32
    src_view: Optional[SegmentView] = None
    dst_view: Optional[SegmentView] = None


def with_self_loops(graph: GraphTensors) -> SelfLoops:
    """Append one self-edge per valid node (PyG's ``add_self_loops`` with
    ``fill_value='mean'``, the JAX package's ``_with_self_loops``): its
    attributes are the mean of the sample's valid edge attributes, their
    sum (rounded once to f32) divided by ``max(n_edges, 1)``. Detached: the list is a constant of
    the mesh, built once per mesh (``models/seq2seq.py``)."""
    if graph.edge_src is None:
        raise ValueError("GAT convolutions need the mesh's edge list; this graph dropped it "
                         "(carry_edges=False)")
    n = graph.n_max
    idx = torch.arange(n, device=graph.edge_src.device)
    self_idx = torch.where(graph.node_valid, idx, n)
    src = torch.cat([graph.edge_src, self_idx], dim=1)
    dst = torch.cat([graph.edge_dst, self_idx], dim=1)
    valid = torch.cat([graph.edge_valid, graph.node_valid], dim=1)
    attr = graph.edge_attr.detach()
    # summed in f64 and rounded once: the correctly rounded sum, which XLA's
    # reduction gives on the meshes the tests compare
    attr_sum = (attr.double() * graph.edge_valid[..., None]).sum(dim=1).float()  # (B, A)
    mean = safe_div(attr_sum, graph.n_edges.clamp_min(1)[:, None].to(attr_sum.dtype))
    attr = torch.cat([attr, mean[:, None].expand(-1, n, -1)], dim=1)
    views = (segment_view(src, n), segment_view(dst, n)) if src.is_cuda else (None, None)
    return SelfLoops(src, dst, valid, attr, *views)


def gat_attend(loops: SelfLoops, n_max: int, src_feat: torch.Tensor, logits: torch.Tensor
               ) -> torch.Tensor:
    """Σ α · src_feat[src] into dst over the self-loop list: α is the
    masked edge softmax of ``logits`` (B, L, H) (its segment max and sum
    plain), the sum K7 on a CUDA tensor over the list's dst view. src_feat:
    (B, n_max, H, d). Returns (B, n_max, H, d)."""
    alpha = edge_softmax(logits, loops.dst, loops.valid, n_max)
    msg = alpha[..., None] * gather_nodes(src_feat, loops.src, n_max, loops.src_view)
    return segment_sum_nodes(msg, loops.dst, n_max, loops.dst_view)


def gat_logits(loops: SelfLoops, n_max: int, v2: bool, slope: float, x_l: torch.Tensor,
               x_r: Optional[torch.Tensor], e: Optional[torch.Tensor], att: torch.Tensor,
               att_dst: Optional[torch.Tensor], att_edge: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """Per-edge logits (B, L, H) over the self-loop list for H heads of d
    features. GATConv: ``leaky_relu(x_l·att_src [src] + x_l·att_dst [dst]
    + e·att_edge)``; GATv2Conv: ``Σ att · leaky_relu(x_l[src] + x_r[dst] +
    e)``. x_l, x_r: (B, n_max, H, d); e: (B, L, H, d) edge terms or None;
    att, att_dst, att_edge: (H, d)."""
    def gather(t, ids, view):
        return gather_nodes(t, ids, n_max, view)

    if v2:
        feat = gather(x_l, loops.src, loops.src_view) + gather(x_r, loops.dst, loops.dst_view)
        if e is not None:
            feat = feat + e
        return (att * nn.functional.leaky_relu(feat, slope)).sum(dim=-1)
    a = (gather((x_l * att).sum(dim=-1), loops.src, loops.src_view)
         + gather((x_l * att_dst).sum(dim=-1), loops.dst, loops.dst_view))
    if e is not None:
        a = a + (e * att_edge).sum(dim=-1)
    return nn.functional.leaky_relu(a, slope)


def check_edge_mesh(graph: GraphTensors) -> None:
    """Raise the JAX package's error for a GAT conv on the grid, which has
    no edge list."""
    if graph.agg[0] == "grid":
        raise ValueError("GAT convolutions need an edge-list mesh (self-loop insertion); build "
                         "the pixelwise graph with aggregation='xla' instead of 'grid'")


class GATConv(nn.Module):
    """Graph attention (GAT, and with ``v2`` GATv2) over the mesh's edge
    list with a self-loop per valid node (:func:`with_self_loops`).
    Parameters follow the flax modules: GATConv ``lin`` (no bias),
    ``att_src`` and ``att_dst`` (1, heads, d), with edge features
    ``lin_edge`` (no bias) and ``att_edge``; GATv2Conv ``lin_l`` and
    ``lin_r`` (with bias), ``lin_edge`` and ``att``; both ``bias``. Logits
    are ``leaky_relu(…, 0.2)`` (:func:`gat_logits`), α their edge softmax,
    and the output ``Σ α · x[src]`` (K7 on a CUDA tensor) concatenated over
    heads (or their mean) plus ``bias``. ``edge_dim`` is the graph's
    attribute width (2, or 1 where the config uses no edge attributes).
    The grid has no edge list: a grid graph raises, as in the JAX
    package. ``dtype`` is the compute dtype."""

    v2 = False

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 edge_dim: Optional[int] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.out_channels, self.concat = heads, out_channels, concat
        self.negative_slope, self.dtype = negative_slope, dtype
        hd = heads * out_channels
        if self.v2:
            self.lin_l = nn.Linear(in_channels, hd)
            self.lin_r = nn.Linear(in_channels, hd)
            self.att = nn.Parameter(torch.zeros(1, heads, out_channels))
        else:
            self.lin = nn.Linear(in_channels, hd, bias=False)
            self.att_src = nn.Parameter(torch.zeros(1, heads, out_channels))
            self.att_dst = nn.Parameter(torch.zeros(1, heads, out_channels))
        self.lin_edge = nn.Linear(edge_dim, hd, bias=False) if edge_dim is not None else None
        if edge_dim is not None and not self.v2:
            self.att_edge = nn.Parameter(torch.zeros(1, heads, out_channels))
        self.bias = nn.Parameter(torch.zeros(hd if concat else out_channels))

    def forward(self, x: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        check_edge_mesh(graph)
        h, d, dt = self.heads, self.out_channels, self.dtype
        b, n = x.shape[:2]
        loops = graph.self_loops if graph.self_loops is not None else with_self_loops(graph)

        def heads_view(t):
            return t.reshape(t.shape[:-1] + (h, d))

        def param(p):
            return p.to(dt)[0]

        e = None
        if self.lin_edge is not None:
            e = heads_view(dense(self.lin_edge, loops.attr, dt))
        if self.v2:
            x_l = heads_view(dense(self.lin_l, x, dt))
            logits = gat_logits(loops, n, True, self.negative_slope, x_l,
                                heads_view(dense(self.lin_r, x, dt)), e, param(self.att),
                                None, None)
        else:
            x_l = heads_view(dense(self.lin, x, dt))
            logits = gat_logits(loops, n, False, self.negative_slope, x_l, None, e,
                                param(self.att_src), param(self.att_dst),
                                None if e is None else param(self.att_edge))
        out = gat_attend(loops, n, x_l, logits)
        out = out.reshape(b, n, h * d) if self.concat else out.mean(dim=-2)
        return out + self.bias.to(out.dtype)


class GATv2Conv(GATConv):
    """GATv2 (:class:`GATConv` with ``v2``): dynamic attention with
    ``lin_l``/``lin_r`` and one ``att`` vector."""

    v2 = True


# registry (parity: the JAX package's CONVOLUTIONS / CONVOLUTION_KWARGS);
# "Dummy" is the identity (GraphConv)
CONVOLUTIONS = {"GCNConv": GCNConv, "ChebConv": ChebConv, "TransformerConv": TransformerConv,
                "MHTransformerConv": MHTransformerConv, "GATConv": GATConv,
                "GATv2Conv": GATv2Conv, "Dummy": None}
CONVOLUTION_KWARGS = {
    "GCNConv": {},
    "ChebConv": dict(K=3),
    "TransformerConv": dict(heads=1, edge_dim=2, dropout=0.1, concat=False),
    "MHTransformerConv": dict(heads=3, edge_dim=2, dropout=0.1),
    "GATConv": dict(heads=1, edge_dim=2),
    "GATv2Conv": dict(heads=1, edge_dim=2),
    "Dummy": {},
}


def conv_kwargs(convolution_type: str, attr_dim: int) -> dict:
    """The registry's kwargs of a conv with ``edge_dim`` set to the graph's
    attribute width ``attr_dim`` (the flax modules infer it from the graph:
    2, or 1 for GATv2Conv, whose config uses no edge attributes)."""
    kw = dict(CONVOLUTION_KWARGS[convolution_type])
    if "edge_dim" in kw:
        kw["edge_dim"] = attr_dim
    return kw


def make_conv(convolution_type: str, in_channels: int, out_channels: int, attr_dim: int,
              dtype: torch.dtype = torch.float32) -> nn.Module:
    """One conv of the registry with its kwargs (:func:`conv_kwargs`)."""
    return CONVOLUTIONS[convolution_type](in_channels, out_channels,
                                          **conv_kwargs(convolution_type, attr_dim), dtype=dtype)


_SOWS = (TransformerConv, MHTransformerConv)


class GraphConv(nn.Module):
    """A stack of ``n_layers`` convolutions of one type, ``conv_0`` …, with
    no nonlinearity between them; ``"Dummy"`` is the identity, with no
    parameters. ``attr_dim`` is the graph's edge-attribute width."""

    def __init__(self, convolution_type: str, in_channels: int, out_channels: int,
                 n_layers: int = 1, attr_dim: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = 0 if convolution_type == "Dummy" else n_layers
        for i in range(self.n_layers):
            self.add_module(f"conv_{i}", make_conv(convolution_type,
                                                   in_channels if i == 0 else out_channels,
                                                   out_channels, attr_dim, dtype))

    def forward(self, x: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None,
                intermediates: Optional[Dict] = None) -> torch.Tensor:
        """``intermediates``: a dict that receives the α of every attention
        conv of the stack, in order (:func:`multi_stream_attention`)."""
        for i in range(self.n_layers):
            conv = getattr(self, f"conv_{i}")
            kw = dict(intermediates=intermediates) if isinstance(conv, _SOWS) else {}
            x = conv(x, graph, generator, **kw)
        return x


def attention_map(intermediates: Dict, graph: GraphTensors) -> torch.Tensor:
    """The first sown α reduced to a per-node map (B, n_max, 1): the max
    over each node's incoming edges and heads (on the grid, over its
    directions and heads), 0 at invalid nodes and nodes with no incoming
    edge. ``intermediates`` is the dict passed to an attention conv
    (:func:`multi_stream_attention`)."""
    alphas = intermediates.get("alpha")
    if not alphas:
        raise ValueError("no sown 'alpha' — run an attention conv on an edge list or the grid "
                         "with an intermediates dict")
    alpha = alphas[0]
    if alpha.dim() == 5:  # the grid: (B, D, rows, cols, heads)
        att = alpha.amax(dim=(1, -1)).reshape(alpha.shape[0], -1)
        return torch.where(graph.node_valid, att, 0.0)[..., None]
    b = alpha.shape[0]
    n = graph.n_max
    per_edge = torch.where(graph.edge_valid, alpha.amax(dim=-1), float("-inf"))
    att = per_edge.new_full((b, n + 1), float("-inf")).scatter_reduce(
        1, graph.edge_dst.clamp(0, n), per_edge, "amax")[:, :n]
    return torch.where(torch.isfinite(att), att, 0.0)[..., None]


def dump_attention_map(path, x, att_map) -> None:
    """Write (x, att_map) as two stacked ``np.save`` records (the JAX
    package's format)."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    with open(path, "wb") as f:
        np.save(f, host(x))
        np.save(f, host(att_map))
