"""Image stacks → padded quadtree graphs, one mesh per sample.

Counterpart of ``quadtree_mpnnlstm_tpu/graph/build.py``: the quadtree path,
the pixelwise edge list (``thresh=-inf``; compact raster node ids) and the
pixelwise grid (``thresh=-inf`` with ``aggregation="grid"``). Incoming
image stacks already carry the two positional-encoding channels as their
last two channels. A graph built on a CUDA card carries the CSR views of
its id vectors that the segment-sum kernel K7 reads, and with attention
windows the source-sorted view of their slots that K4 reads. With
``GraphConfig.debug_overflow`` a build that dropped content raises.

``GraphConfig.adjacency="csum"`` builds quadtree edge lists with the
sort-free builder (``graph/adjacency.py`` ``build_adjacency_canonical``),
as the JAX package does: not with ``edges_at_corners`` and not on the
pixelwise mesh, which take the sort. ``GraphConfig.max_degree`` > 0 gives
the graph its capped id vectors and their CSR views (:func:`degree_cap`)
and counts the edges past the cap into ``overflow``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.adjacency import (
    build_adjacency,
    build_adjacency_canonical,
)
from quadtree_mpnnlstm_tpu_torch.graph.quadtree import (
    decompose_levels,
    pixel_nodes_from_levels,
)
from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors, flatten
from quadtree_mpnnlstm_tpu_torch.models.conv import compute_sym_norm
from quadtree_mpnnlstm_tpu_torch.ops import attn, spmm
from quadtree_mpnnlstm_tpu_torch.ops.grid import dir_attrs, grid_sym_coeff
from quadtree_mpnnlstm_tpu_torch.ops.segment import segment_sum_nodes
from quadtree_mpnnlstm_tpu_torch.ops.segment_sum import segment_view


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
    dedup: bool = True,
    pixel_view=None,
    level: Optional[torch.Tensor] = None,
) -> Tuple[GraphTensors, torch.Tensor]:
    b, t = img.shape[:2]
    n_max = cfg.n_max
    dev = img.device
    if img.is_cuda and pixel_view is None:
        pixel_view = segment_view(pixel_node, n_max)
    node_valid = torch.arange(n_max, device=dev)[None, :] < n_nodes.clamp_max(n_max)[:, None]
    graph = GraphTensors(
        pixel_node=pixel_node,
        counts=counts,
        n_nodes=n_nodes,
        node_valid=node_valid,
        overflow=torch.zeros(b, dtype=torch.int64, device=dev),
        pixel_view=pixel_view,
        msg_dtype=cfg.message_dtype,
    )

    data = flatten(img, graph)  # (B, T, n_max, C)
    # positions pool the constant positional-encoding channels, so Â and
    # the edge attributes carry no gradient
    node_xy = _node_positions(data[:, 0].detach(), cfg)
    node_img = pixel_node.reshape((b,) + tuple(cfg.image_shape))
    if cfg.adjacency == "csum" and dedup and level is not None and not cfg.edges_at_corners:
        adjacency = build_adjacency_canonical(node_img, level, node_xy, cfg)
    else:
        adjacency = build_adjacency(node_img, node_xy, cfg, dedup=dedup)
    edge_src, edge_dst, edge_valid, edge_attr, n_edges, n_edges_raw = adjacency

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
    if img.is_cuda:
        graph = graph.replace(dst_view=segment_view(edge_dst, n_max, sorted_ids=True))
        if cfg.carry_edges:
            graph = graph.replace(src_view=segment_view(edge_src, n_max))
    dropped = 0  # edges past the degree cap, on the worse side
    if cfg.max_degree > 0:
        graph, dropped = degree_cap(graph, cfg.max_degree)
    # attention windows read the edge attributes, not Â: skip the
    # normalisation when the edge list is dropped after the build
    if cfg.carry_edges or not cfg.attn_windows:
        graph = graph.replace(sym_coeff=compute_sym_norm(graph))

    # -- capacity-overflow accounting (dropped nodes/edges/window misses)
    overflow = ((n_nodes - n_max).clamp_min(0) + (n_edges_raw - cfg.e_max).clamp_min(0)
                + dropped)
    if cfg.attn_windows:
        meta, window_overflow = attn.attn_tile_meta(
            edge_src, edge_dst, edge_attr, n_max,
            cfg.agg_nt, cfg.agg_eb, cfg.agg_sw, n_nodes,
        )
        overflow = overflow + window_overflow
        graph = graph.replace(
            attn_meta=meta,
            agg=("pallas_attn", cfg.agg_nt, cfg.agg_eb, cfg.agg_sw),
        )
        if img.is_cuda and torch.is_grad_enabled():
            # K4's view, for the backward a gradient-recording forward can
            # run (a no-grad forecast never does); it depends on the
            # windows alone, not on the heads
            dims = attn.AttnDims(n_max, cfg.agg_nt, cfg.agg_eb, cfg.agg_sw, 1, 1)
            graph = graph.replace(slot_view=attn.slot_view(meta, dims))
    elif cfg.aggregation == "pallas":
        windows, window_overflow = spmm.spmm_tile_meta(
            edge_src, edge_dst, graph.sym_coeff, n_max,
            cfg.agg_nt, cfg.agg_eb, cfg.agg_sw,
        )
        overflow = overflow + window_overflow
        graph = graph.replace(
            agg_meta=spmm.spmm_build_blocks(windows, cfg.agg_nt, cfg.agg_sw, n_nodes,
                                            block_dtype=data.dtype),
            agg=("pallas", cfg.agg_nt, cfg.agg_eb, cfg.agg_sw),
        )
    graph = graph.replace(overflow=overflow)
    if cfg.debug_overflow:
        raise_on_overflow(overflow)
    if not cfg.carry_edges:
        # convolutions read only the Â blocks or attention windows once
        # they exist
        graph = graph.replace(
            edge_src=None, edge_dst=None, edge_valid=None, edge_attr=None,
            sym_coeff=None, node_xy=None, dst_view=None, max_degree=0, edge_dst_cap=None,
            edge_src_cap=None, dst_cap_view=None, src_cap_view=None,
        )
    return graph, data


def degree_cap(graph: GraphTensors, cap: int) -> Tuple[GraphTensors, torch.Tensor]:
    """The CSR degree cap of the JAX package's ``ops/csr.py`` backend
    (``GraphConfig.max_degree``) on a dst-sorted edge list: each edge's
    rank among its destination's edges (their order in the list) and among
    its source's edges (their order in the stable source-sorted view, the
    JAX package's ``src_perm``). Returns the graph with ``max_degree`` set,
    the capped id vectors ``edge_dst_cap`` / ``edge_src_cap`` (the
    sentinel ``n_max`` where the rank reaches the cap) and, on a CUDA card,
    their CSR views, which kernel K7 reads as it reads any view; and the
    edges ranked past the cap, on the worse of the two sides, (B,), which
    the build counts into ``overflow``. Integer work, no host sync."""
    src, dst, n_max = graph.edge_src, graph.edge_dst, graph.n_max
    iota = torch.arange(dst.shape[1], device=dst.device).expand_as(dst)
    rank_dst = iota - torch.searchsorted(dst.contiguous(), dst.contiguous())
    src_sorted, src_perm = torch.sort(src, dim=1, stable=True)
    rank_sorted = iota - torch.searchsorted(src_sorted, src_sorted)
    rank_src = torch.empty_like(rank_sorted).scatter_(1, src_perm, rank_sorted)
    drop_dst = (graph.edge_valid & (rank_dst >= cap)).sum(dim=1)
    drop_src = ((src_sorted < n_max) & (rank_sorted >= cap)).sum(dim=1)
    dst_cap = torch.where(rank_dst < cap, dst, n_max)
    src_cap = torch.where(rank_src < cap, src, n_max)
    graph = graph.replace(max_degree=cap, edge_dst_cap=dst_cap, edge_src_cap=src_cap)
    if dst.is_cuda:
        graph = graph.replace(dst_cap_view=segment_view(dst_cap, n_max),
                              src_cap_view=segment_view(src_cap, n_max))
    return graph, torch.maximum(drop_dst, drop_src)


def raise_on_overflow(overflow: torch.Tensor) -> None:
    """``GraphConfig.debug_overflow``: raise when any mesh of the batch
    dropped content. It reads the counter on the host (a sync)."""
    worst = int(overflow.max())
    if worst > 0:
        raise RuntimeError(
            f"graph capacity overflow: {worst} dropped "
            "nodes/edges/window slots — raise n_max/e_max/agg_* caps "
            "(GraphConfig.debug_overflow=True turns this check on)"
        )


def image_to_graph(
    img: torch.Tensor,
    cfg: GraphConfig,
    mask: Optional[torch.Tensor] = None,
    high_interest_region: Optional[torch.Tensor] = None,
    transform_func: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[GraphTensors, torch.Tensor]:
    """Quadtree-decompose image stacks into padded graphs (or, on the
    pixelwise mesh, build its edge list or the identity-mapped grid).

    Args:
      img: (B, T, rows, cols, C) with positional encoding in the last two
        channels; channel 0, max over T, drives each sample's
        decomposition.
      mask: optional (rows, cols) bool, True = invalid pixel.
      high_interest_region: optional (rows, cols) bool, True = always
        split; quadtree meshes only, as in the JAX package.
      transform_func: the split criterion's transform
        (:func:`~quadtree_mpnnlstm_tpu_torch.graph.quadtree.decompose_levels`);
        quadtree meshes only.

    Returns:
      (GraphTensors, data (B, T, n_max, C+1)); the last data channel is the
      normalised cell size ``n_pixels / (max_grid_size/2)**2``
      (``resolution**2`` on the pixelwise mesh).
    """
    if img.ndim != 5:
        raise ValueError(f"expected (B, T, rows, cols, C); got {tuple(img.shape)}")
    if cfg.pixelwise:
        if cfg.aggregation == "grid":
            return grid_graph(img, cfg, mask=mask)
        return pixelwise_graph(img, cfg, mask=mask)
    crit = img[..., 0].amax(dim=1)
    level = decompose_levels(crit, cfg, mask=mask, high_interest_region=high_interest_region,
                             transform_func=transform_func)
    pixel_node, n_nodes, counts = pixel_nodes_from_levels(level, cfg, mask=mask)
    half_base = (cfg.max_grid_size / 2.0) ** 2
    return _assemble(pixel_node, n_nodes, counts, img, cfg, counts / half_base, level=level)


def _keep_mask(mask: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    """(rows, cols) bool, True at the pixels the mesh keeps."""
    if mask is None:
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)
    return ~mask.to(device=device, dtype=torch.bool)


def pixelwise_graph(
    img: torch.Tensor,
    cfg: GraphConfig,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[GraphTensors, torch.Tensor]:
    """Every unmasked pixel is a node, as an edge list (``thresh=-inf``
    with ``aggregation="xla"``): node ids are the kept pixels in raster
    order (``cumsum(keep) − 1``, the sentinel ``n_max`` elsewhere), counts
    come from a segment sum, the size channel is the constant
    ``resolution**2``, and the candidate pairs are unique, so the
    adjacency skips deduplication. ``mask`` (rows, cols) is shared by every
    sample, and so is the mesh."""
    b = img.shape[0]
    rows, cols = cfg.image_shape
    n_max = cfg.n_max
    dev = img.device
    keep = _keep_mask(mask, (rows, cols), dev).reshape(-1)
    cum = torch.cumsum(keep.long(), dim=0)
    pixel_node = torch.where(keep, cum - 1, n_max).clamp_max(n_max)
    pixel_node = pixel_node.expand(b, rows * cols).contiguous()
    view = segment_view(pixel_node, n_max) if img.is_cuda else None
    counts = segment_sum_nodes(torch.ones(pixel_node.shape, device=dev), pixel_node, n_max,
                               view)
    cell_sizes = torch.full((b, n_max), cfg.resolution**2, device=dev)
    return _assemble(pixel_node, cum[-1].expand(b), counts, img, cfg, cell_sizes,
                     dedup=False, pixel_view=view)


def grid_graph(
    img: torch.Tensor,
    cfg: GraphConfig,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[GraphTensors, torch.Tensor]:
    """Pixelwise mesh in identity-mapping stencil form
    (``aggregation="grid"``): node id = raster pixel index, masked pixels
    invalid, one node per kept pixel (counts 1.0), no edge list, nothing
    to overflow. Message passing is the shift stencil of ops/grid.py; the
    size channel is the constant ``resolution**2``, masked pixels included,
    as in the JAX package. ``mask`` (rows, cols) is shared by every sample,
    and so are ``grid_coeff`` and ``grid_attr``."""
    b, t, rows, cols, _ = img.shape
    p = rows * cols
    dev = img.device
    keep2d = _keep_mask(mask, (rows, cols), dev)
    keep = keep2d.reshape(-1)
    pixel_node = torch.where(keep, torch.arange(p, device=dev), p)
    attrs = torch.from_numpy(dir_attrs(cfg.edges_at_corners, cfg.resolution)).to(dev)
    if not cfg.use_edge_attrs:
        attrs = attrs[:, 1:]  # distance only
    graph = GraphTensors(
        pixel_node=pixel_node.expand(b, p),
        counts=keep.float().expand(b, p),
        n_nodes=keep.sum().expand(b),
        node_valid=keep.expand(b, p),
        overflow=torch.zeros(b, dtype=torch.int64, device=dev),
        grid_coeff=grid_sym_coeff(keep2d, cfg.edges_at_corners, cfg.resolution),
        grid_attr=attrs,
        agg=("grid", rows, cols, cfg.num_dirs),
        mapping_identity=True,
    )
    data = flatten(img, graph)  # (B, T, P, C): reshape + mask
    sizes = torch.full((b, t, p, 1), cfg.resolution**2, dtype=data.dtype, device=dev)
    return graph, torch.cat([data, sizes], dim=-1)
