"""Padded, statically-shaped graph state with a leading batch axis.

Counterpart of ``quadtree_mpnnlstm_tpu/graph/state.py``. The JAX package
vmaps one mesh per sample; here every field carries the batch axis
explicitly, so each sample of a batch keeps its own mesh:

* ``pixel_node`` — (B, P) node id per pixel; ``n_max`` is the invalid
  sentinel.
* ``counts`` — (B, n_max) pixels per node.
* the edge list, padded to ``e_max`` and sorted by destination, with the
  sentinel ``n_max`` in unused slots (None once dropped, see
  ``GraphConfig.carry_edges``).

``flatten`` (pixel→node mean pooling) is one segment sum; ``unflatten``
(node→pixel painting) is its adjoint gather. Both backwards sum in a fixed
order, so a training step on the card is bit-reproducible. On the
pixelwise grid (``mapping_identity``: node id = raster pixel index) both
are a reshape and a mask. Index tensors are int64, torch's index type.
A graph built on a CUDA card carries the CSR views of its id vectors
(``pixel_view``, ``dst_view``, ``src_view``) that the segment-sum kernel
K7 reads, and of its attention-window slots by source (``slot_view``)
that K4 reads, each built once per mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from quadtree_mpnnlstm_tpu_torch.ops.segment import gather_nodes, segment_sum_nodes
from quadtree_mpnnlstm_tpu_torch.ops.segment_sum import SegmentView


@dataclasses.dataclass
class GraphTensors:
    """Fixed-capacity meshes of a batch: node mapping + adjacency."""

    pixel_node: torch.Tensor  # (B, P) int64 in [0, n_max]; n_max = invalid
    counts: torch.Tensor      # (B, n_max) f32 pixels per node
    n_nodes: torch.Tensor     # (B,) int64 true node count (may exceed n_max)
    node_valid: torch.Tensor  # (B, n_max) bool
    # capacity-overflow counter: nodes past n_max + edges past e_max + SpMM
    # or attention window misses (zero when nothing was dropped)
    overflow: torch.Tensor    # (B,) int64
    edge_src: Optional[torch.Tensor] = None   # (B, e_max) int64, sentinel n_max
    edge_dst: Optional[torch.Tensor] = None   # (B, e_max) int64, sorted
    edge_valid: Optional[torch.Tensor] = None  # (B, e_max) bool
    edge_attr: Optional[torch.Tensor] = None  # (B, e_max, edge_dim) f32
    n_edges: Optional[torch.Tensor] = None    # (B,) int64
    node_xy: Optional[torch.Tensor] = None    # (B, n_max, 2) f32
    sym_coeff: Optional[torch.Tensor] = None  # (B, e_max) f32 D^-1/2 A D^-1/2
    # per-tile Â blocks for the SpMM kernels (ops/spmm.py SpmmBlocks)
    agg_meta: Optional[object] = None
    # per-tile attention windows for the attention kernels (ops/attn.py AttnMeta)
    attn_meta: Optional[object] = None
    # per-direction D^-1/2 A D^-1/2 stencil planes of the grid backend
    # (ops/grid.py), shared by every sample
    grid_coeff: Optional[torch.Tensor] = None  # (D, rows, cols) f32
    # per-direction constant (bearing, distance) edge attributes (grid)
    grid_attr: Optional[torch.Tensor] = None   # (D, edge_dim) f32
    # aggregation backend descriptor: (name, nt, eb, sw), or
    # ("grid", rows, cols, D)
    agg: tuple = ("xla", 0, 0, 0)
    # identity pixel↔node mapping (grid): flatten/unflatten are reshapes
    mapping_identity: bool = False
    # CSR views of pixel_node, edge_dst and edge_src for the segment-sum
    # kernel (ops/segment_sum.py), built on a CUDA card
    pixel_view: Optional[SegmentView] = None
    dst_view: Optional[SegmentView] = None
    src_view: Optional[SegmentView] = None
    # the source-sorted view of the attention-window slots for K4's dk/dv
    # gather (ops/attn.py slot_view), built on a CUDA card
    slot_view: Optional[SegmentView] = None

    @property
    def n_max(self) -> int:
        return self.counts.shape[-1]

    def replace(self, **kw) -> "GraphTensors":
        return dataclasses.replace(self, **kw)


def flatten(img: torch.Tensor, graph: GraphTensors) -> torch.Tensor:
    """Pixel→node mean pooling.

    Args:
      img: (B, T, rows, cols, C) image stacks.
    Returns:
      (B, T, n_max, C) node features in img's dtype; padded node rows are
      exactly zero. A bf16 image is summed in f32 (rounded once) and
      divided by the f32 counts before the cast back, as the JAX package
      divides in the promoted dtype.
    """
    b, t, rows, cols, c = img.shape
    p = rows * cols
    n_max = graph.n_max
    if graph.mapping_identity:
        # each valid node is its pixel (count 1): a reshape and a mask
        return torch.where(graph.node_valid[:, None, :, None], img.reshape(b, t, p, c), 0.0)
    flat = img.reshape(b, t, p, c).permute(0, 2, 1, 3).reshape(b, p, t * c)
    summed = segment_sum_nodes(flat, graph.pixel_node, n_max, graph.pixel_view)
    mean = summed / graph.counts.clamp_min(1.0)[..., None]
    return mean.to(img.dtype).reshape(b, n_max, t, c).permute(0, 2, 1, 3)


def unflatten(
    data: torch.Tensor,
    graph: GraphTensors,
    image_shape: Tuple[int, int],
    fill: float = 0.0,
) -> torch.Tensor:
    """Node→pixel scatter: paint each pixel with its node's value.

    Args:
      data: (B, n_max, C) node features.
    Returns:
      (B, rows, cols, C); invalid (masked) pixels get ``fill``.
    """
    rows, cols = image_shape
    b, n_max, c = data.shape
    fill_t = torch.full((), fill, dtype=data.dtype, device=data.device)
    if graph.mapping_identity:
        return torch.where(graph.node_valid[..., None], data, fill_t).reshape(b, rows, cols, c)
    img = gather_nodes(data, graph.pixel_node, n_max, graph.pixel_view)
    valid = (graph.pixel_node < n_max)[..., None]
    img = torch.where(valid, img, fill_t)
    return img.reshape(b, rows, cols, c)
