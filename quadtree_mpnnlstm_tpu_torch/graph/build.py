"""Image stacks → padded quadtree graphs, one mesh per sample.

Counterpart of ``quadtree_mpnnlstm_tpu/graph/build.py`` (quadtree path).
Incoming image stacks already carry the two positional-encoding channels
as their last two channels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.adjacency import build_adjacency
from quadtree_mpnnlstm_tpu_torch.graph.quadtree import (
    decompose_levels,
    pixel_nodes_from_levels,
)
from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors, flatten
from quadtree_mpnnlstm_tpu_torch.models.conv import compute_sym_norm
from quadtree_mpnnlstm_tpu_torch.ops import spmm


def _node_positions(data0: torch.Tensor, cfg: GraphConfig) -> torch.Tensor:
    """Node centroid (x, y) from the pooled positional-encoding channels."""
    rows, cols = cfg.image_shape
    xx = data0[..., -2] * cols * cfg.resolution
    yy = data0[..., -1] * rows * cfg.resolution
    return torch.stack([xx, yy], dim=-1)


def _assemble(
    pixel_node: torch.Tensor,
    n_nodes: torch.Tensor,
    counts: torch.Tensor,
    img: torch.Tensor,
    cfg: GraphConfig,
    cell_size_feature: torch.Tensor,
) -> Tuple[GraphTensors, torch.Tensor]:
    b, t = img.shape[:2]
    n_max = cfg.n_max
    dev = img.device
    node_valid = torch.arange(n_max, device=dev)[None, :] < n_nodes.clamp_max(n_max)[:, None]
    graph = GraphTensors(
        pixel_node=pixel_node,
        counts=counts,
        n_nodes=n_nodes,
        node_valid=node_valid,
        overflow=torch.zeros(b, dtype=torch.int64, device=dev),
    )

    data = flatten(img, graph)  # (B, T, n_max, C)
    # positions pool the constant positional-encoding channels, so Â and
    # the edge attributes carry no gradient
    node_xy = _node_positions(data[:, 0].detach(), cfg)
    node_img = pixel_node.reshape((b,) + tuple(cfg.image_shape))
    edge_src, edge_dst, edge_valid, edge_attr, n_edges, n_edges_raw = build_adjacency(
        node_img, node_xy, cfg
    )

    # Append the normalised cell-size channel.
    sizes = cell_size_feature[:, None, :, None].expand(b, t, n_max, 1)
    data = torch.cat([data, sizes.to(data.dtype)], dim=-1)

    graph = graph.replace(
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_valid=edge_valid,
        edge_attr=edge_attr,
        n_edges=n_edges,
        node_xy=node_xy,
    )
    graph = graph.replace(sym_coeff=compute_sym_norm(graph))

    # -- capacity-overflow accounting (dropped nodes/edges/window misses)
    overflow = (n_nodes - n_max).clamp_min(0) + (n_edges_raw - cfg.e_max).clamp_min(0)
    if cfg.aggregation == "pallas":
        windows, window_overflow = spmm.spmm_tile_meta(
            edge_src, edge_dst, graph.sym_coeff, n_max,
            cfg.agg_nt, cfg.agg_eb, cfg.agg_sw,
        )
        overflow = overflow + window_overflow
        graph = graph.replace(
            agg_meta=spmm.spmm_build_blocks(windows, cfg.agg_nt, cfg.agg_sw, n_nodes),
            agg=("pallas", cfg.agg_nt, cfg.agg_eb, cfg.agg_sw),
        )
    graph = graph.replace(overflow=overflow)
    if not cfg.carry_edges:
        # convolutions read only the Â blocks once they exist
        graph = graph.replace(
            edge_src=None, edge_dst=None, edge_valid=None, edge_attr=None,
            sym_coeff=None, node_xy=None,
        )
    return graph, data


def image_to_graph(
    img: torch.Tensor,
    cfg: GraphConfig,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[GraphTensors, torch.Tensor]:
    """Quadtree-decompose image stacks into padded graphs.

    Args:
      img: (B, T, rows, cols, C) with positional encoding in the last two
        channels; channel 0, max over T, drives each sample's
        decomposition.
      mask: optional (rows, cols) bool, True = invalid pixel.

    Returns:
      (GraphTensors, data (B, T, n_max, C+1)); the last data channel is the
      normalised cell size ``n_pixels / (max_grid_size/2)**2``.
    """
    if img.ndim != 5:
        raise ValueError(f"expected (B, T, rows, cols, C); got {tuple(img.shape)}")
    crit = img[..., 0].amax(dim=1)
    level = decompose_levels(crit, cfg, mask=mask)
    pixel_node, n_nodes, counts = pixel_nodes_from_levels(level, cfg, mask=mask)
    half_base = (cfg.max_grid_size / 2.0) ** 2
    return _assemble(pixel_node, n_nodes, counts, img, cfg, counts / half_base)
