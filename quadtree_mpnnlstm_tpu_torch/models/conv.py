"""Graph convolutions over per-sample padded meshes.

Counterpart of ``quadtree_mpnnlstm_tpu/models/conv.py``: the symmetric
normalisation, the ``Â z`` dispatch, ``GCNConv`` (no self-loops, the
symmetric degree norm with the distance column as edge weight),
``ChebConv`` (K=3, 'sym' laplacian, lambda_max=2), the attention-window,
grid and edge-list branches of ``multi_stream_attention`` and
``TransformerConv`` (heads=1, edge_dim=2, attention dropout 0.1, concat
off in the registry). Node tensors are (B, n_max, F). Every conv takes
``(x, graph, generator)``; attention dropout draws its keep windows (or
planes, or per-edge hashes) from ``generator`` in training mode
(``module.train()``) only. Every conv and every branch runs in the
compute dtype it is given (f32 or bf16).

Not ported yet: the batch-middle (shared-mesh) layout, the α side channel
(``sow``), ``MHTransformerConv`` and the GAT family.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.ops import attn, grid_attn, spmm
from quadtree_mpnnlstm_tpu_torch.ops.grid import grid_a_mul
from quadtree_mpnnlstm_tpu_torch.ops.segment import (
    aggregate_to_dst,
    edge_softmax,
    gather_dst,
    gather_src,
    segment_sum_nodes,
)


def compute_sym_norm(graph: GraphTensors) -> torch.Tensor:
    """D^{-1/2} A D^{-1/2} coefficient per edge (B, e_max); the scalar edge
    weight is the last edge-attribute column (distance), 0 where invalid.

    ``dinv`` is indexed with the clamped edge ids: the sentinel ``n_max``
    would be out of range (JAX clamps it silently; torch raises), and its
    weight is 0 either way.
    """
    n = graph.n_max
    w = graph.edge_attr[..., -1] * graph.edge_valid
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
        (ops/segment.py; kernel K7 on a CUDA tensor).
    """
    if graph.agg[0] == "grid":
        return grid_a_mul(z, graph)
    if graph.agg[0] == "pallas":
        _, nt, _eb, sw = graph.agg
        return spmm.spmm_apply(z, graph.agg_meta, graph.n_max, nt, sw)
    return aggregate_to_dst(graph.sym_coeff[..., None].to(z.dtype) * gather_src(z, graph), graph)


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
    package keys it, with its own random bits)."""
    dev = graph.edge_src.device
    seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                         device=generator.device).to(dev)
    b = graph.edge_src.shape[0]
    h = _mix32(seed + torch.arange(b, device=dev)[:, None])
    h = _mix32(h ^ graph.edge_src)
    h = _mix32(h ^ graph.edge_dst)
    h = _mix32(h[..., None] ^ torch.arange(heads, device=dev))
    u = (h >> 8).to(torch.float32) * 2.0**-24  # uniform on [0, 1)
    return (u < 1.0 - rate).to(torch.float32) / (1.0 - rate)


def edge_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, we: torch.Tensor,
                   graph: GraphTensors, heads: int, d: int,
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The edge-list branch of :func:`multi_stream_attention`: gather k
    and v at the sources and q at the destinations, add the edge term
    ``edge_attr · Wₑ`` to keys and values, take per-head logits ``q·(k +
    e)/√d``, the masked edge softmax, the keep-scales (B, E, heads) when
    given, and sum ``α·(v + e)`` at the destinations (kernel K7 on a CUDA
    tensor). Everything runs in q's dtype: the keep-scales are cast to it,
    as the JAX package casts them to α's, so a bf16 call keeps its
    messages and their sum in bf16. Returns (B, n_max, heads, d)."""
    b, n = q.shape[:2]
    qh, kh, vh = (x.reshape(b, n, heads, d) for x in (q, k, v))
    e = (graph.edge_attr.to(q.dtype) @ we).reshape(b, -1, heads, d)
    kj = gather_src(kh, graph) + e
    vj = gather_src(vh, graph) + e
    # √d in q's dtype, as the JAX branch takes it (jnp.sqrt of d in that dtype)
    root_d = float(torch.tensor(float(d), dtype=q.dtype).sqrt())
    logits = (gather_dst(qh, graph) * kj).sum(dim=-1) / root_d
    alpha = edge_softmax(logits, graph.edge_dst, graph.edge_valid, n)
    used = alpha if keep is None else alpha * keep.to(alpha.dtype)
    return aggregate_to_dst(used[..., None] * vj, graph)


def multi_stream_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, we: Optional[torch.Tensor],
    graph: GraphTensors, heads: int, d: int, dropout: float = 0.0,
    training: bool = False, generator: Optional[torch.Generator] = None,
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
        u = torch.rand(shape, generator=generator, device=q.device)
        return (u < 1.0 - dropout).float() / (1.0 - dropout)

    if graph.agg[0] == "grid":
        _, rows, cols, ndirs = graph.agg
        # every direction's edges share one edge term (grid_attr @ Wₑ)
        e_dir = graph.grid_attr.to(q.dtype) @ we  # (D, heads·d)
        valid = graph.node_valid[0].to(q.dtype)   # the mask every sample shares
        keep = keep_planes((b, ndirs, n, heads)) if drop else None
        dims = grid_attn.GridAttnDims(rows, cols, heads, d, ndirs)
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
    return edge_attention(q, k, v, we, graph, heads, d, keep)


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

    def _dense(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        bias = None if lin.bias is None else lin.bias.to(self.dtype)
        return nn.functional.linear(x, lin.weight.to(self.dtype), bias)

    def forward(self, x: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, d = self.heads, self.out_channels
        x = x.to(self.dtype)
        we = None if self.lin_edge is None else self.lin_edge.weight.t().to(self.dtype)  # (A, h·d)
        out = multi_stream_attention(
            self._dense(self.lin_query, x), self._dense(self.lin_key, x),
            self._dense(self.lin_value, x), we, graph, h, d,
            dropout=self.dropout, training=self.training, generator=generator,
        )
        out = out.reshape(out.shape[:-2] + (h * d,)) if self.concat else out.mean(dim=-2)
        if self.lin_skip is not None:
            out = out + self._dense(self.lin_skip, x)
        return out


# registry (parity: the JAX package's CONVOLUTIONS / CONVOLUTION_KWARGS)
CONVOLUTIONS = {"GCNConv": GCNConv, "ChebConv": ChebConv, "TransformerConv": TransformerConv}
CONVOLUTION_KWARGS = {
    "GCNConv": {},
    "ChebConv": dict(K=3),
    "TransformerConv": dict(heads=1, edge_dim=2, dropout=0.1, concat=False),
}
