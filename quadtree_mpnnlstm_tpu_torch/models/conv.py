"""Graph convolutions over per-sample padded meshes (ChebConv slice).

Counterpart of ``quadtree_mpnnlstm_tpu/models/conv.py``: the symmetric
normalisation, the ``Â z`` dispatch and ``ChebConv`` (K=3, 'sym'
laplacian, lambda_max=2). Node tensors are (B, n_max, F).
"""

from __future__ import annotations

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.ops import spmm
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
      * otherwise — gather → scale → scatter-add over the edge list.
    """
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

    def forward(self, x: torch.Tensor, graph: GraphTensors) -> torch.Tensor:
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
