"""Vectorised adjacency extraction with padded edge capacity (batched).

Counterpart of ``quadtree_mpnnlstm_tpu/graph/adjacency.py``: the sort path
(:func:`build_adjacency`) and the sort-free "csum" path
(:func:`build_adjacency_canonical`). All candidate directed pairs come from 4 or 8 array shifts, are
deduplicated after one sort per sample, and are compacted into a fixed
``e_max``-slot edge list:

  * the two-key ``lax.sort((dst, src), num_keys=2)`` becomes one int64 sort
    of ``dst * (n_max + 2) + src`` (invalid pairs carry ``n_max + 1`` in
    both, so they sort last);
  * ``.at[slot].set(..., mode="drop")`` becomes a scatter into an
    ``e_max + 1``-slot buffer whose scratch slot is sliced off.

The output stays sorted by (dst, src) with sentinel ``n_max`` padding: the
SpMM windows (ops/spmm.py) depend on that order. A multi-pixel cell keeps
its self-loop; a singleton cell has none. The pixelwise mesh's pairs are
unique (``dedup=False``): there the pairs are stable-sorted by dst alone,
as the JAX package sorts them, so within a destination the slots keep the
shift order and the edge list is the JAX package's bit for bit. The csum
list holds the same edge set in another order within each destination
(self-loop first, then the shifts' groups), element for element the JAX
package's csum list.
"""

from __future__ import annotations

import math

import torch

from quadtree_mpnnlstm_tpu_torch.config import GraphConfig

_SHIFTS_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
_SHIFTS_8 = _SHIFTS_4 + ((-1, -1), (1, -1), (-1, 1), (1, 1))


def _shifted(nid: torch.Tensor, dr: int, dc: int, sentinel: int) -> torch.Tensor:
    """Neighbour id images (B, rows, cols); out-of-bounds become ``sentinel``."""
    out = torch.roll(nid, shifts=(-dr, -dc), dims=(1, 2))
    rows, cols = nid.shape[1:]
    r = torch.arange(rows, device=nid.device)[:, None]
    c = torch.arange(cols, device=nid.device)[None, :]
    ok = (r + dr >= 0) & (r + dr < rows) & (c + dc >= 0) & (c + dc < cols)
    return torch.where(ok, out, sentinel)


def build_adjacency(node_img: torch.Tensor, node_xy: torch.Tensor, cfg: GraphConfig,
                    dedup: bool = True):
    """Edges from (B, rows, cols) node-id images (sentinel = cfg.n_max);
    ``dedup=False`` for meshes whose pairs are unique (pixelwise).

    Returns:
      (edge_src, edge_dst, edge_valid, edge_attr, n_edges, n_edges_raw),
      capacity e_max; ``n_edges_raw`` counts edges before the capacity
      clamp so the builder can report overflow.
    """
    b = node_img.shape[0]
    n_max, e_max = cfg.n_max, cfg.e_max
    shifts = _SHIFTS_8 if cfg.edges_at_corners else _SHIFTS_4

    src = torch.cat([node_img.reshape(b, -1)] * len(shifts), dim=1)
    dst = torch.cat(
        [_shifted(node_img, dr, dc, n_max).reshape(b, -1) for dr, dc in shifts],
        dim=1,
    )
    valid = (src < n_max) & (dst < n_max)
    if dedup:
        # Invalid pairs sort to the end.
        key = torch.where(valid, dst * (n_max + 2) + src, (n_max + 1) * (n_max + 3))
        key, _ = torch.sort(key, dim=1)
        dst_s = torch.div(key, n_max + 2, rounding_mode="floor")
        src_s = key - dst_s * (n_max + 2)
        prev = torch.cat([torch.full_like(key[:, :1], -1), key[:, :-1]], dim=1)
        keep = (key != prev) & (dst_s < n_max)
    else:
        dst_s, perm = torch.sort(torch.where(valid, dst, n_max + 1), dim=1, stable=True)
        src_s = torch.gather(src, 1, perm)
        keep = dst_s < n_max
    pos = torch.cumsum(keep.long(), dim=1) - 1
    n_edges_raw = keep.sum(dim=1)

    # Invalid slots carry the sentinel node id n_max; slot e_max is scratch.
    slot = torch.where(keep & (pos < e_max), pos, e_max)
    fill = torch.full((b, e_max + 1), n_max, dtype=torch.int64, device=node_img.device)
    edge_src = fill.scatter(1, slot, src_s)[:, :e_max]
    edge_dst = fill.scatter(1, slot, dst_s)[:, :e_max]
    edge_valid = torch.zeros_like(fill, dtype=torch.bool).scatter(1, slot, keep)[:, :e_max]

    edge_attr = edge_attributes(edge_src, edge_dst, edge_valid, node_xy, cfg)
    n_edges = n_edges_raw.clamp_max(e_max)
    return edge_src, edge_dst, edge_valid, edge_attr, n_edges, n_edges_raw


def edge_attributes(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_valid: torch.Tensor,
    node_xy: torch.Tensor,
    cfg: GraphConfig,
) -> torch.Tensor:
    """(bearing, distance) or (distance,) per edge, zero where invalid."""
    b = node_xy.shape[0]
    xy = torch.cat([node_xy, node_xy.new_zeros((b, 1, 2))], dim=1)

    def take(idx, k):
        return torch.gather(xy[..., k], 1, idx)

    ddx = take(edge_src, 0) - take(edge_dst, 0)
    ddy = take(edge_src, 1) - take(edge_dst, 1)
    dist = torch.sqrt(ddx * ddx + ddy * ddy)
    if cfg.use_edge_attrs:
        two_pi = 2.0 * math.pi
        bearing = torch.remainder(torch.atan2(ddx, ddy), two_pi) / two_pi
        attr = torch.stack([bearing, dist], dim=-1)
    else:
        attr = dist[..., None]
    return attr * edge_valid[..., None].to(attr.dtype)


def build_adjacency_canonical(node_img: torch.Tensor, level: torch.Tensor,
                              node_xy: torch.Tensor, cfg: GraphConfig):
    """The sort-free adjacency of quadtree meshes (``GraphConfig.adjacency
    = "csum"``), the JAX package's ``build_adjacency_canonical`` batched,
    element for element: the same edges as :func:`build_adjacency` in
    another order within each destination.

    * Canonical emission: two distinct cells that share a boundary emit
      their directed pair once, from the boundary pixel at the start of the
      shared span (horizontal neighbours: the row ``max`` of the two cells'
      top rows; vertical ones: the column ``max`` of their left columns). A
      multi-pixel cell emits one self-loop from its anchor pixel (width-1
      cells, clipped at the right edge, from the vertical pair); a
      singleton emits none.
    * Counting scatter: the per-destination degree of each group (self,
      then the shifts in ``_SHIFTS_4`` order) comes from an integer
      segment sum, exclusive cumsums give each destination a contiguous
      slot range, and each edge's rank within its (destination, group)
      comes from a column or row prefix sum, so the edges land grouped by
      destination, group-major, with no sort.

    Integer work only (cumsums, a scatter-add of counts and a scatter into
    unique slots; the sentinel slot ``e_max`` is scratch). 4-neighbour
    meshes only. Args: node_img (B, rows, cols) node ids (sentinel
    ``n_max``), level (B, rows, cols) quadtree levels
    (``graph/quadtree.py`` ``decompose_levels``). Returns what
    :func:`build_adjacency` returns."""
    if cfg.edges_at_corners:
        raise ValueError("the csum adjacency is 4-neighbour only")
    b, rows, cols = node_img.shape
    n_max, e_max = cfg.n_max, cfg.e_max
    dev = node_img.device
    size = cfg.max_grid_size >> level
    r = torch.arange(rows, device=dev)[:, None]
    c = torch.arange(cols, device=dev)[None, :]
    ar = r & ~(size - 1)
    ac = c & ~(size - 1)
    width = (ac + size).clamp_max(cols) - ac  # the cell's width, clipped at the edge
    valid = node_img < n_max

    def excl_cumsum(x, dim):
        x = x.long()
        return torch.cumsum(x, dim=dim) - x

    same_right = _shifted(node_img, 0, 1, n_max) == node_img
    same_down = _shifted(node_img, 1, 0, n_max) == node_img
    at_anchor = (r == ar) & (c == ac)
    self_canon = valid & at_anchor & (same_right | ((width == 1) & same_down))
    groups = [(self_canon, node_img, torch.zeros_like(node_img))]
    for dr, dc in _SHIFTS_4:
        nq = _shifted(node_img, dr, dc, n_max)
        pair_ok = valid & (nq < n_max) & (nq != node_img)
        if dr == 0:  # a horizontal neighbour: the span starts at the lower top row
            arq = _shifted(ar, dr, dc, 0)
            canon = pair_ok & (r == torch.maximum(ar, arq))
            cum = excl_cumsum(canon, 1)
            rank = cum - torch.gather(cum, 1, arq)
        else:  # a vertical one: the span starts at the righter left column
            acq = _shifted(ac, dr, dc, 0)
            canon = pair_ok & (c == torch.maximum(ac, acq))
            cum = excl_cumsum(canon, 2)
            rank = cum - torch.gather(cum, 2, acq)
        groups.append((canon, nq, rank))

    def degree(canon, dst):
        ids = torch.where(canon, dst, n_max).reshape(b, -1)
        deg = torch.zeros((b, n_max + 1), dtype=torch.int64, device=dev)
        return deg.scatter_add_(1, ids, canon.reshape(b, -1).long())[:, :n_max]

    degs = [degree(canon, dst) for canon, dst, _ in groups]
    deg_total = sum(degs)
    base = torch.cumsum(deg_total, dim=1) - deg_total  # each destination's first slot
    n_edges_raw = deg_total.sum(dim=1)

    fill = torch.full((b, e_max + 1), n_max, dtype=torch.int64, device=dev)
    edge_src, edge_dst = fill, fill
    edge_valid = torch.zeros((b, e_max + 1), dtype=torch.bool, device=dev)
    src_flat = node_img.reshape(b, -1)
    for (canon, dst, rank), deg in zip(groups, degs):
        dst_flat = dst.reshape(b, -1)
        canon_flat = canon.reshape(b, -1)
        slot = torch.gather(base, 1, dst_flat.clamp_max(n_max - 1)) + rank.reshape(b, -1)
        slot = torch.where(canon_flat & (slot < e_max), slot, e_max)
        edge_src = edge_src.scatter(1, slot, src_flat)
        edge_dst = edge_dst.scatter(1, slot, dst_flat)
        edge_valid = edge_valid.scatter(1, slot, canon_flat)
        base = base + deg
    edge_src, edge_dst, edge_valid = (x[:, :e_max] for x in (edge_src, edge_dst, edge_valid))
    edge_attr = edge_attributes(edge_src, edge_dst, edge_valid, node_xy, cfg)
    return (edge_src, edge_dst, edge_valid, edge_attr, n_edges_raw.clamp_max(e_max),
            n_edges_raw)
