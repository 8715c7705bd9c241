"""Preset (static) meshes, built once and reused by every sample.

Counterpart of ``quadtree_mpnnlstm_tpu/graph/static.py``: the sea-ice
experiments 9 and 10 (``cli/ice_exp.py``) build one mesh from the land
mask (and a high-interest region) before training and hand it to
``train``/``predict`` as ``graph_structure``. A preset graph holds one
mesh (batch axis 1); :func:`expand_graph` stands it in for a batch of B
samples as views of its tensors, with the CSR views that K7 reads
rebased once for B. The shared meshes of batched training
(``TrainConfig.shared_mesh``, ``models/seq2seq.py``) ride their batch the
same way.
"""

from __future__ import annotations

from typing import Optional

import torch

from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.adjacency import edge_attributes
from quadtree_mpnnlstm_tpu_torch.graph.build import degree_cap, image_to_graph
from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors
from quadtree_mpnnlstm_tpu_torch.models.conv import SelfLoops, compute_sym_norm
from quadtree_mpnnlstm_tpu_torch.ops.segment import segment_sum_nodes
from quadtree_mpnnlstm_tpu_torch.ops.segment_sum import SegmentView, segment_view
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding


def preset_device(device, *tensors) -> torch.device:
    """The device a preset mesh is built on: ``device`` when given, else
    that of the first torch tensor among ``tensors`` (the mask, the
    high-interest region), else the card."""
    if device is not None:
        return torch.device(device)
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cuda")


def create_static_heterogeneous_graph(
    cfg: GraphConfig,
    mask: Optional[torch.Tensor] = None,
    high_interest_region: Optional[torch.Tensor] = None,
    device=None,
) -> GraphTensors:
    """A fixed quadtree, dense where cells overlap the mask or the
    high-interest region: the builder at ``thresh=+inf`` on a zero image,
    so only those two force splits. ``mask``/``high_interest_region``
    (rows, cols) bool, True = invalid / always split. One mesh (batch axis
    1) on ``device`` (:func:`preset_device`: by default the mask's or the
    region's device, else the card)."""
    device = preset_device(device, mask, high_interest_region)
    cfg = cfg.replace(thresh=float("inf"))
    arr = add_positional_encoding(
        torch.zeros((1, 1) + tuple(cfg.image_shape) + (1,), device=device))
    graph, _ = image_to_graph(
        arr, cfg,
        mask=None if mask is None else torch.as_tensor(mask, dtype=torch.bool, device=device),
        high_interest_region=None if high_interest_region is None
        else torch.as_tensor(high_interest_region, dtype=torch.bool, device=device),
    )
    return graph


def create_static_homogeneous_graph(
    cfg: GraphConfig,
    mask: torch.Tensor,
    device=None,
) -> GraphTensors:
    """A uniform mesh (cells of ``max_grid_size``) without its fully
    masked cells: the unmasked heterogeneous mesh, with every node whose
    pixels are all masked deleted and the survivors renumbered 0..n in
    order. As in the JAX package, a partly masked cell keeps its masked
    pixels mapped to its node. One mesh (batch axis 1) on ``device``
    (:func:`preset_device`: by default the mask's device, else the card),
    its edge list sorted by (dst, src) with the sentinels last; no Â
    blocks. With ``cfg.max_degree`` its edge list carries the degree cap
    (``graph/build.py`` ``degree_cap``; the JAX package counts no
    overflow for it here) and, as in the JAX package, f32 messages."""
    device = preset_device(device, mask)
    base = create_static_heterogeneous_graph(cfg, mask=None, device=device)
    n_max = cfg.n_max
    dev = base.counts.device
    pn = base.pixel_node[0]

    # unmasked pixels a node; none ⇒ delete
    keep_pix = (~torch.as_tensor(mask, dtype=torch.bool, device=dev)).reshape(1, -1).float()
    unmasked = segment_sum_nodes(keep_pix, base.pixel_node, n_max, base.pixel_view)[0]
    keep = (unmasked > 0) & base.node_valid[0]
    new_of_old = torch.cumsum(keep.long(), dim=0) - 1  # monotone relabel
    n_nodes = keep.sum()

    # old id → new id, with the sentinel n_max (and every deleted node)
    # mapped to n_max: the padded tables are indexed by ids in [0, n_max]
    keep_pad = torch.cat([keep, keep.new_zeros(1)])
    new_pad = torch.cat([new_of_old, new_of_old.new_full((1,), n_max)])
    pixel_node = torch.where(keep_pad[pn], new_pad[pn], n_max)

    # per-node arrays compacted into the new numbering; deleted nodes land
    # in a scratch row n_max that is sliced off
    slot = torch.where(keep, new_of_old, n_max)

    def compact(values):
        out = values.new_zeros((n_max + 1,) + values.shape[1:])
        return out.index_copy(0, slot, values)[:n_max]

    counts = compact(base.counts[0])
    node_xy = compact(base.node_xy[0])
    node_valid = torch.arange(n_max, device=dev) < n_nodes

    # edges touching a deleted node take the sentinel; one int64 key sorts
    # them by (dst, src) with the sentinels (n_max, n_max) last
    src, dst = base.edge_src[0], base.edge_dst[0]
    e_keep = base.edge_valid[0] & keep_pad[src] & keep_pad[dst]
    src = torch.where(e_keep, new_pad[src], n_max)
    dst = torch.where(e_keep, new_pad[dst], n_max)
    key, _ = torch.sort(dst * (n_max + 1) + src)
    dst = torch.div(key, n_max + 1, rounding_mode="floor")
    src = key - dst * (n_max + 1)
    e_keep = dst < n_max

    one = lambda t: t[None]  # noqa: E731 — the preset's batch axis of 1
    graph = GraphTensors(
        pixel_node=one(pixel_node),
        counts=one(counts),
        n_nodes=one(n_nodes),
        node_valid=one(node_valid),
        overflow=torch.zeros(1, dtype=torch.int64, device=dev),
        edge_src=one(src),
        edge_dst=one(dst),
        edge_valid=one(e_keep),
        edge_attr=edge_attributes(one(src), one(dst), one(e_keep), one(node_xy), cfg),
        n_edges=one(e_keep.sum()),
        node_xy=one(node_xy),
    )
    if counts.is_cuda:
        graph = graph.replace(
            pixel_view=segment_view(graph.pixel_node, n_max),
            dst_view=segment_view(graph.edge_dst, n_max, sorted_ids=True),
            src_view=segment_view(graph.edge_src, n_max),
        )
    if cfg.max_degree > 0:
        graph, _ = degree_cap(graph, cfg.max_degree)
    return graph.replace(sym_coeff=compute_sym_norm(graph))


def _expand_view(view: Optional[SegmentView], b: int, length: int) -> Optional[SegmentView]:
    """A one-sample CSR view rebased for B copies of its id vector: entry
    positions and offsets are global over B·L."""
    if view is None:
        return None
    base = torch.arange(b, dtype=torch.int32, device=view.offsets.device)[:, None] * length
    order = None if view.order is None else (view.order[None] + base).reshape(-1)
    return SegmentView(order, view.offsets + base)


# per-sample tensors of a graph, and the CSR views with the ids they index
_TENSORS = ("pixel_node", "counts", "n_nodes", "node_valid", "overflow", "edge_src",
            "edge_dst", "edge_valid", "edge_attr", "n_edges", "node_xy", "sym_coeff",
            "edge_dst_cap", "edge_src_cap")
_VIEWS = (("pixel_view", "pixel_node"), ("dst_view", "edge_dst"), ("src_view", "edge_src"),
          ("dst_cap_view", "edge_dst_cap"), ("src_cap_view", "edge_src_cap"))


def _expand(t: Optional[torch.Tensor], b: int) -> Optional[torch.Tensor]:
    return None if t is None else t.expand((b,) + t.shape[1:])


def expand_graph(graph: GraphTensors, b: int) -> GraphTensors:
    """A one-mesh graph (batch axis 1) as the graph of a batch of ``b``
    samples that all ride it: every per-sample tensor an expanded view, the
    CSR views rebased for ``b`` (``order`` and ``offsets`` are global over
    the batch), the GAT self-loop list likewise. The Â blocks, the
    attention windows and their slot view keep their batch axis of 1: the
    kernels (K2/K2b, K3/K4) and their plain versions read one mesh's
    metadata for every sample. A graph of batch ``b`` is returned as it
    is."""
    n = graph.counts.shape[0]
    if n == b:
        return graph
    if n != 1:
        raise ValueError(f"a graph of {n} meshes cannot ride a batch of {b}; a preset or "
                         "shared graph holds one mesh")
    fields = {name: _expand(getattr(graph, name), b) for name in _TENSORS}
    for name, ids in _VIEWS:
        ids = getattr(graph, ids)
        if getattr(graph, name) is not None:
            fields[name] = _expand_view(getattr(graph, name), b, ids.shape[1])
    loops = graph.self_loops
    if loops is not None:
        length = loops.src.shape[1]
        fields["self_loops"] = SelfLoops(
            *(_expand(t, b) for t in (loops.src, loops.dst, loops.valid, loops.attr)),
            _expand_view(loops.src_view, b, length), _expand_view(loops.dst_view, b, length))
    return graph.replace(**fields)
