"""Dense stencil aggregation for pixelwise meshes (``aggregation="grid"``).

Counterpart of ``quadtree_mpnnlstm_tpu/ops/grid.py``. With the quadtree
off (``thresh=-inf``) every valid pixel is a node and the mesh is a regular
4- (or 8-) neighbour grid. Node ids are raster pixel indices (masked pixels
invalid), so message passing is a stencil: for each direction the
neighbour plane is a shifted copy of the node plane,

    (Â z)[r, c] = Σ_d coeff_d[r, c] · z[r - dr_d, c - dc_d],

and every edge of a direction has the same (bearing, distance) attributes,
so attention edge projections collapse into D small vectors. Node planes
carry a leading batch axis: (B, rows, cols, ...).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Same direction order as graph/adjacency.py.
SHIFTS_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
SHIFTS_8 = SHIFTS_4 + ((-1, -1), (1, -1), (-1, 1), (1, 1))


def shifts_for(edges_at_corners: bool) -> Tuple[Tuple[int, int], ...]:
    return SHIFTS_8 if edges_at_corners else SHIFTS_4


def shift_in(zg: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """Plane of incoming-neighbour values for direction (dr, dc):
    ``out[b, r, c] = zg[b, r - dr, c - dc]``, zero outside the grid.
    ``zg`` is (B, rows, cols, ...)."""
    rows, cols = zg.shape[1], zg.shape[2]
    out = zg.new_zeros(zg.shape)
    r0, r1 = max(dr, 0), rows + min(dr, 0)
    c0, c1 = max(dc, 0), cols + min(dc, 0)
    if r0 < r1 and c0 < c1:
        out[:, r0:r1, c0:c1] = zg[:, r0 - dr:r1 - dr, c0 - dc:c1 - dc]
    return out


def neighbor_valid(valid: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """(B, rows, cols) bool: pixel (r, c) has a valid neighbour at
    (r - dr, c - dc), i.e. an incoming edge of direction (dr, dc)."""
    return shift_in(valid, dr, dc) & valid


def dir_attrs(edges_at_corners: bool, resolution: float) -> np.ndarray:
    """(D, 2) per-direction (bearing, distance) edge attributes, computed
    in numpy as the JAX package computes them (bit-identical): for the
    edge src→dst, ddx = -dc·res, ddy = -dr·res; the bearing is
    atan2(ddx, ddy) normalised to [0, 1)."""
    shifts = shifts_for(edges_at_corners)
    out = np.zeros((len(shifts), 2), np.float32)
    for i, (dr, dc) in enumerate(shifts):
        ddx = -dc * resolution
        ddy = -dr * resolution
        out[i, 0] = np.mod(np.arctan2(ddx, ddy), 2 * np.pi) / (2 * np.pi)
        out[i, 1] = resolution * float(np.hypot(dr, dc))
    return out


def grid_sym_coeff(valid: torch.Tensor, edges_at_corners: bool,
                   resolution: float) -> torch.Tensor:
    """(D, rows, cols) D^{-1/2} A D^{-1/2} stencil coefficient planes of
    the (rows, cols) validity plane: edge weight = centroid distance,
    deg[n] = Σ incoming weights, coeff = dinv[dst] · w · dinv[src]; zero
    where either end is invalid."""
    shifts = shifts_for(edges_at_corners)
    attrs = dir_attrs(edges_at_corners, resolution)
    valid = valid[None]
    deg = torch.zeros(valid.shape, dtype=torch.float32, device=valid.device)
    for i, (dr, dc) in enumerate(shifts):
        deg = deg + float(attrs[i, 1]) * neighbor_valid(valid, dr, dc).float()
    dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), 0.0)
    planes = [torch.where(neighbor_valid(valid, dr, dc),
                          float(attrs[i, 1]) * dinv * shift_in(dinv, dr, dc), 0.0)
              for i, (dr, dc) in enumerate(shifts)]
    return torch.cat(planes)


def grid_a_mul(z: torch.Tensor, graph) -> torch.Tensor:
    """``Â z`` for z (B, rows·cols, F) over the identity-mapped grid: D
    shifted multiply-adds (the Cheb aggregation, dispatched from
    ``models/conv.py`` ``a_mul``). Plain PyTorch on both devices, as the
    JAX version is plain XLA."""
    _, rows, cols, ndirs = graph.agg
    b, _, f = z.shape
    zg = z.reshape(b, rows, cols, f)
    coeff = graph.grid_coeff.to(z.dtype)
    out = torch.zeros_like(zg)
    for i, (dr, dc) in enumerate(shifts_for(ndirs == 8)):
        out = out + coeff[i][None, ..., None] * shift_in(zg, dr, dc)
    return out.reshape(b, rows * cols, f)
