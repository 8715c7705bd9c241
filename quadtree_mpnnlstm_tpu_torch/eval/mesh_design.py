"""Mesh design from climatological variance maps.

Counterpart of ``quadtree_mpnnlstm_tpu/eval/mesh_design.py``: seasonal
variance maps of a field, decomposed into candidate quadtree meshes at
several thresholds, with each mesh's reconstruction of the map and node
count, for choosing a production static mesh. The meshes are built by the
port's ``image_to_graph`` on ``device`` (the card unless the caller asks
for the CPU): on a card the node counts and the pooling of the map onto
the nodes are segment sums on the segment-sum kernel (``ops/segment_sum.py``),
as are the edge list's degrees.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.graph.state import unflatten
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding


def seasonal_variance(values: np.ndarray, times: np.ndarray, month: int,
                      halo: int = 1) -> np.ndarray:
    """Per-pixel variance over the days of ``month`` ± ``halo`` months of
    all years, NaN → 0."""
    times = np.asarray(times, dtype="datetime64[M]")
    months = (times.astype(int) % 12) + 1
    wanted = {((month - 1 + d) % 12) + 1 for d in range(-halo, halo + 1)}
    sel = np.isin(months, list(wanted))
    return np.nan_to_num(np.var(np.asarray(values)[sel], axis=0))


@torch.no_grad()
def design_mesh(varmap: np.ndarray, mask: Optional[np.ndarray], thresh: float,
                max_grid_size: int = 4, resolution: float = 0.25, device="cuda"):
    """Decompose a variance map (rows, cols) into a quadtree mesh of
    ``thresh`` (``mask``: True = invalid pixel) → (graph, the map's
    reconstruction from the mesh's node means (rows, cols) numpy,
    n_nodes). ``graph`` is the port's ``GraphTensors`` of batch 1 on
    ``device``."""
    shape = tuple(varmap.shape)
    cfg = GraphConfig(image_shape=shape, max_grid_size=max_grid_size, thresh=thresh,
                      resolution=resolution)
    img = torch.as_tensor(np.asarray(varmap), dtype=torch.float32, device=device)
    arr = add_positional_encoding(img[None, None, :, :, None])
    graph, data = image_to_graph(
        arr, cfg, mask=None if mask is None else torch.as_tensor(mask, device=device).bool())
    recon = unflatten(data[:, 0, :, :1], graph, shape)[0, ..., 0].cpu().numpy()
    return graph, recon, int(graph.n_nodes[0])


def sweep_meshes(varmap: np.ndarray, mask: Optional[np.ndarray], thresholds: Sequence[float],
                 max_grid_size: int = 4, device="cuda") -> dict:
    """threshold → node count, for mesh budget planning."""
    return {float(t): design_mesh(varmap, mask, t, max_grid_size, device=device)[2]
            for t in thresholds}
