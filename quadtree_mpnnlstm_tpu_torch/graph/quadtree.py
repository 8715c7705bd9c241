"""Quadtree decomposition as a fixed-depth tensor program (batched).

Counterpart of ``quadtree_mpnnlstm_tpu/graph/quadtree.py``. For every
level ℓ (cell size ``max_grid_size >> ℓ``) the split decision of all cells
comes from one pooled window reduction, and each pixel's level is the
smallest non-splitting level on its ancestor chain:

    level(p) = min{ℓ : not split[ℓ][cell_ℓ(p)]}

Node ids are numbered in raster order of cell anchors by a cumulative sum.
The criterion window of a cell spans ``[x-padding, x+size+1+padding)`` —
``lax.reduce_window`` with window ``size+1+2p``, stride ``size`` and
padding ``(p, p+1)`` there; here ``F.pad`` with the reduction identity
followed by ``max_pool2d`` (``min`` is ``-max(-x)``). Integer outputs are
bit-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.ops.segment import segment_sum_nodes


def _window_max(arr: torch.Tensor, size: int, padding: int, fill: float) -> torch.Tensor:
    """Per-cell max over the [anchor-p, anchor+size+1+p) window of a
    (B, H, W) float array; out-of-range parts contribute ``fill``."""
    w = size + 1 + 2 * padding
    x = F.pad(arr[:, None], (padding, padding + 1, padding, padding + 1), value=fill)
    return F.max_pool2d(x, kernel_size=w, stride=size)[:, 0]


def _window_reduce(arr: torch.Tensor, size: int, padding: int, op: str) -> torch.Tensor:
    if op == "max":
        return _window_max(arr, size, padding, float("-inf"))
    if op == "min":
        return -_window_max(-arr, size, padding, float("-inf"))
    if op == "any":
        return _window_max(arr.float(), size, padding, 0.0) > 0
    raise ValueError(op)


def _split_criterion(cell_max, cell_min, thresh: float, condition: str):
    if condition == "max_larger_than":
        return cell_max > thresh
    if condition == "max_smaller_than":
        return cell_max < thresh
    if condition == "min_larger_than":
        return cell_min > thresh
    if condition == "min_smaller_than":
        return cell_min < thresh
    raise ValueError(condition)


def _upsample(cells: torch.Tensor, size: int) -> torch.Tensor:
    return cells.repeat_interleave(size, dim=-2).repeat_interleave(size, dim=-1)


def dist_from_05(arr: torch.Tensor) -> torch.Tensor:
    """Split-criterion transform of the sea-ice quadtree meshes,
    ``|(|arr − 0.5|) − 0.5|``: 0 at fields of 0 and 1, largest at 0.5, so
    cells where the ice fraction is neither 0 nor 1 split. The port's copy
    of the JAX package's ``cli/ice_exp.py`` ``dist_from_05``."""
    return abs(abs(arr - 0.5) - 0.5)


def decompose_levels(
    img: torch.Tensor,
    cfg: GraphConfig,
    mask: Optional[torch.Tensor] = None,
    high_interest_region: Optional[torch.Tensor] = None,
    transform_func: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Per-pixel quadtree level.

    Args:
      img: (B, rows, cols) float field driving the split criterion.
      mask: (rows, cols) bool, True = invalid pixel (always split to 1).
      high_interest_region: (rows, cols) bool, True = always split.
      transform_func: applied to the edge-padded criterion image in its
        own dtype, before the cast to float32, as in the JAX package.

    Returns:
      (B, rows, cols) int64 in [0, depth]; ``depth`` means a 1-pixel cell.
    """
    b = img.shape[0]
    rows, cols = cfg.image_shape
    hp, wp = cfg.padded_shape
    g = cfg.max_grid_size

    # replicate-padding is exact in float32, so padding there and casting
    # back gives the padded image in its own dtype
    imgp = F.pad(img[:, None].float(), (0, wp - cols, 0, hp - rows), mode="replicate")[:, 0]
    if transform_func is not None:
        imgp = transform_func(imgp.to(img.dtype)).float()
    maskp = None
    if mask is not None:
        maskp = F.pad(mask.float(), (0, wp - cols, 0, hp - rows))[None]
    hirp = None
    if high_interest_region is not None:
        hirp = F.pad(high_interest_region.float(), (0, wp - cols, 0, hp - rows))[None]

    depth = cfg.depth
    level = torch.full((b, hp, wp), depth, dtype=torch.int64, device=img.device)
    needs_max = cfg.condition.startswith("max")
    # Deepest→shallowest so the final value is the *smallest* non-splitting
    # level on each pixel's ancestor chain.
    for lvl in range(depth - 1, -1, -1):
        size = g >> lvl
        cell = _window_reduce(imgp, size, cfg.padding, "max" if needs_max else "min")
        split = _split_criterion(cell, cell, cfg.thresh, cfg.condition)
        if maskp is not None:
            split = split | _window_reduce(maskp, size, cfg.padding, "any")
        if hirp is not None:
            split = split | _window_reduce(hirp, size, cfg.padding, "any")
        level = torch.where(_upsample(split, size), level, lvl)

    level = level[:, :rows, :cols]
    if cfg.node_budget:
        level = _apply_node_budget(level, cfg, mask)
    return level


def _leaders(level: torch.Tensor, cfg: GraphConfig, invalid: torch.Tensor):
    """(B, rows, cols) bool: the anchor pixel of every valid cell."""
    rows, cols = level.shape[-2:]
    size = 2 ** (cfg.depth - level)  # = max_grid_size >> level
    r = torch.arange(rows, device=level.device)[:, None]
    c = torch.arange(cols, device=level.device)[None, :]
    return (r == (r & ~(size - 1))) & (c == (c & ~(size - 1))) & ~invalid


def _apply_node_budget(
    level: torch.Tensor, cfg: GraphConfig, mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """Coarsen each mesh to respect ``cfg.node_budget``: pick the largest
    refinement cutoff L* whose capped mesh ``min(level, L*)`` has ≤ budget
    nodes. Aligned blocks overlapping the mask keep their mask-forced
    levels (see the JAX package's docstring for why this is
    partition-consistent)."""
    b, rows, cols = level.shape
    g = cfg.max_grid_size
    depth = cfg.depth
    hp, wp = cfg.padded_shape
    invalid = (
        mask.bool() if mask is not None
        else torch.zeros((rows, cols), dtype=torch.bool, device=level.device)
    )

    def capped_level(cap: int) -> torch.Tensor:
        lv = level.clamp_max(cap)
        if mask is not None and cap < depth:
            size = g >> cap
            invp = F.pad(invalid.float(), (0, wp - cols, 0, hp - rows))
            ov = F.max_pool2d(invp[None, None], size, size)[0, 0] > 0
            lv = torch.where(_upsample(ov, size)[:rows, :cols], level, lv)
        return lv

    levels = torch.stack([capped_level(cap) for cap in range(depth + 1)])
    counts = torch.stack(
        [_leaders(lv, cfg, invalid).sum(dim=(-2, -1)) for lv in levels]
    )  # (depth+1, B)
    caps = torch.arange(depth + 1, device=level.device)[:, None]
    cap_star = torch.where(counts <= cfg.node_budget, caps, 0).amax(dim=0)  # (B,)
    return levels[cap_star, torch.arange(b, device=level.device)]


def pixel_nodes_from_levels(
    level: torch.Tensor,
    cfg: GraphConfig,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Canonical node ids from per-pixel level maps.

    Cells are numbered in raster order of their anchor pixel; masked pixels
    get the invalid sentinel ``n_max``, as do cells past capacity.

    Returns:
      (pixel_node (B, P) int64, n_nodes (B,) int64, counts (B, n_max) f32).
    """
    b = level.shape[0]
    rows, cols = cfg.image_shape
    n_max = cfg.n_max
    invalid = (
        mask.bool() if mask is not None
        else torch.zeros((rows, cols), dtype=torch.bool, device=level.device)
    )
    size = 2 ** (cfg.depth - level)  # = max_grid_size >> level
    r = torch.arange(rows, device=level.device)[:, None]
    c = torch.arange(cols, device=level.device)[None, :]
    anchor_r = r & ~(size - 1)
    anchor_c = c & ~(size - 1)
    leader = (r == anchor_r) & (c == anchor_c) & ~invalid

    cum = torch.cumsum(leader.reshape(b, -1).long(), dim=1)
    n_nodes = cum[:, -1]
    anchor_flat = (anchor_r * cols + anchor_c).reshape(b, -1)
    node_id = torch.gather(cum, 1, anchor_flat) - 1
    node_id = torch.where(invalid.reshape(1, -1), n_max, node_id)
    node_id = node_id.clamp_max(n_max)  # capacity overflow guard

    counts = segment_sum_nodes(
        torch.ones(node_id.shape, dtype=torch.float32, device=level.device),
        node_id, n_max,
    )
    return node_id, n_nodes, counts
