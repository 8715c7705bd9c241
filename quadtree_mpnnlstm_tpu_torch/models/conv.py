"""Graph convolutions over per-sample padded meshes.

Counterpart of ``quadtree_mpnnlstm_tpu/models/conv.py``: the symmetric
normalisation, the ``Â z`` dispatch, ``ChebConv`` (K=3, 'sym' laplacian,
lambda_max=2), the attention-window and grid branches of
``multi_stream_attention`` and ``TransformerConv`` (heads=1, edge_dim=2,
attention dropout 0.1, concat off in the registry). Node tensors are
(B, n_max, F). Every conv takes ``(x, graph, generator)``; attention
dropout draws its keep windows (or planes) from ``generator`` in training
mode (``module.train()``) only.

Not ported yet: the edge-list branch of the attention, the batch-middle
(shared-mesh) layout, the α side channel (``sow``), ``MHTransformerConv``,
GCN and the GAT family.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.ops import attn, grid_attn, spmm
from quadtree_mpnnlstm_tpu_torch.ops.grid import grid_a_mul
from quadtree_mpnnlstm_tpu_torch.ops.segment import gather_nodes, segment_sum_nodes


def compute_sym_norm(graph: GraphTensors) -> torch.Tensor:
    """D^{-1/2} A D^{-1/2} coefficient per edge (B, e_max); the scalar edge
    weight is the last edge-attribute column (distance), 0 where invalid.

    ``dinv`` is indexed with the clamped edge ids: the sentinel ``n_max``
    would be out of range (JAX clamps it silently; torch raises), and its
    weight is 0 either way.
    """
    n = graph.n_max
    w = graph.edge_attr[..., -1] * graph.edge_valid
    deg = segment_sum_nodes(w, graph.edge_dst, n)
    dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), 0.0)
    d_dst = torch.gather(dinv, 1, graph.edge_dst.clamp_max(n - 1))
    d_src = torch.gather(dinv, 1, graph.edge_src.clamp_max(n - 1))
    return d_dst * w * d_src


def a_mul(z: torch.Tensor, graph: GraphTensors) -> torch.Tensor:
    """``Â z`` for z (B, n_max, F), dispatched by the graph's backend:

      * ``pallas`` — the per-tile Â blocks (ops/spmm.py, kernel K2 on a CUDA
        tensor);
      * ``grid`` — the shift stencil of the pixelwise mesh (ops/grid.py);
      * otherwise — gather → scale → scatter-add over the edge list.
    """
    if graph.agg[0] == "grid":
        return grid_a_mul(z, graph)
    if graph.agg[0] == "pallas":
        _, nt, _eb, sw = graph.agg
        return spmm.spmm_apply(z, graph.agg_meta, graph.n_max, nt, sw)
    n = z.shape[1]
    zs = gather_nodes(z, graph.edge_src, n)
    return segment_sum_nodes(graph.sym_coeff[..., None].to(z.dtype) * zs, graph.edge_dst, n)


class ChebConv(nn.Module):
    """Chebyshev spectral conv, 'sym' normalisation. Parameters follow the
    flax module: ``lin_k`` (no bias) per tap and one ``bias``."""

    def __init__(self, in_channels: int, out_channels: int, K: int = 3,
                 lambda_max: float = 2.0):
        super().__init__()
        self.K = K
        self.lambda_max = lambda_max
        for k in range(K):
            self.add_module(f"lin_{k}", nn.Linear(in_channels, out_channels, bias=False))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def lin(self, k: int) -> nn.Linear:
        return getattr(self, f"lin_{k}")

    def forward(self, x: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        scale = 2.0 / self.lambda_max

        def l_hat(z):
            # (2/λmax)(I - Â) - I applied to z
            return scale * (z - a_mul(z, graph)) - z

        tx_prev = x
        out = self.lin(0)(tx_prev)
        if self.K > 1:
            tx = l_hat(x)
            out = out + self.lin(1)(tx)
            for k in range(2, self.K):
                tx, tx_prev = 2.0 * l_hat(tx) - tx_prev, tx
                out = out + self.lin(k)(tx)
        return out + self.bias


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
    kernels K3/K4 on a CUDA tensor) or on the pixelwise grid (``agg =
    "grid"``; kernels K5/K6).

    Dropout, in training mode only, keeps an entry with probability
    1 − rate and scales it by 1/(1 − rate), drawn from ``generator``: one
    value per window slot and head, a (B, T, heads, EB) keep window, as the
    JAX package's window path draws it; on the grid one per direction,
    pixel and head, (B, D, P, heads) planes, as its grid path does.

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
    if graph.agg[0] != "pallas_attn":
        raise ValueError(
            "attention runs on the attention windows (GraphConfig.attn_windows with "
            "aggregation='pallas') or the pixelwise grid (aggregation='grid') only; the "
            "edge-list attention is not ported"
        )
    _, nt, eb, sw = graph.agg
    meta = graph.attn_meta
    keep = keep_planes((b, meta.s0.shape[1], heads, eb)) if drop else None
    dims = attn.AttnDims(n, nt, eb, sw, heads, d)
    return attn.attn_apply(q, k, v, we, keep, meta, dims).reshape(b, n, heads, d)


class TransformerConv(nn.Module):
    """Graph transformer (UniMP-style) attention conv. Parameters follow
    the flax module: ``lin_query``, ``lin_key``, ``lin_value`` (with
    bias), ``lin_edge`` (no bias; the edge projection Wₑ is its kernel, what
    the flax module gets by applying it to the identity) and ``lin_skip``."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 concat: bool = True, dropout: float = 0.0, edge_dim: Optional[int] = None,
                 root_weight: bool = True, use_bias: bool = True):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.concat, self.dropout = concat, dropout
        hd = heads * out_channels
        self.lin_query = nn.Linear(in_channels, hd)
        self.lin_key = nn.Linear(in_channels, hd)
        self.lin_value = nn.Linear(in_channels, hd)
        self.lin_edge = nn.Linear(edge_dim, hd, bias=False) if edge_dim is not None else None
        self.lin_skip = (nn.Linear(in_channels, hd if concat else out_channels, bias=use_bias)
                         if root_weight else None)

    def forward(self, x: torch.Tensor, graph: GraphTensors,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, d = self.heads, self.out_channels
        we = None if self.lin_edge is None else self.lin_edge.weight.t()  # (A, h·d)
        out = multi_stream_attention(
            self.lin_query(x), self.lin_key(x), self.lin_value(x), we, graph, h, d,
            dropout=self.dropout, training=self.training, generator=generator,
        )
        out = out.reshape(out.shape[:-2] + (h * d,)) if self.concat else out.mean(dim=-2)
        if self.lin_skip is not None:
            out = out + self.lin_skip(x)
        return out


# registry (parity: the JAX package's CONVOLUTIONS / CONVOLUTION_KWARGS)
CONVOLUTIONS = {"ChebConv": ChebConv, "TransformerConv": TransformerConv}
CONVOLUTION_KWARGS = {
    "ChebConv": dict(K=3),
    "TransformerConv": dict(heads=1, edge_dim=2, dropout=0.1, concat=False),
}
