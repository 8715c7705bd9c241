"""PyTorch port vs JAX package: ``eval/mesh_design.py``.

``seasonal_variance`` exactly; ``design_mesh`` and ``sweep_meshes`` on
16×16 and 32×32 variance maps (half of the map low-variance, with and
without a land mask, max_grid_size 4 and 8, thresholds from splitting
every cell to none) on the CPU: node counts equal, the node-id image of
each mesh equal, reconstructions ≤1e-6. On the CPU no kernel launch is
counted (the segment sums take their plain version).
"""

import numpy as np
import pytest
import torch

from quadtree_mpnnlstm_tpu.eval import mesh_design as j_md
from quadtree_mpnnlstm_tpu_torch.eval import mesh_design as t_md
from quadtree_mpnnlstm_tpu_torch.ops import segment_sum
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

RECON_TOL = 1e-6
THRESHOLDS = (1e-6, 0.004, 0.02, 1e9)


def _variance_map(shape, seed=0):
    rng = np.random.default_rng(seed)
    times = np.arange(np.datetime64("2015-01-01"), np.datetime64("2017-01-01"),
                      np.timedelta64(1, "D"))
    vals = rng.random((len(times), *shape)).astype(np.float32)
    vals[:, : shape[0] // 2] *= 0.05  # low-variance half
    vals[:, :, -3:] = np.nan  # open water: NaN → variance 0
    got = t_md.seasonal_variance(vals, times, month=6, halo=1)
    np.testing.assert_array_equal(got, j_md.seasonal_variance(vals, times, month=6, halo=1))
    np.testing.assert_array_equal(t_md.seasonal_variance(vals, times, 1, 0),
                                  j_md.seasonal_variance(vals, times, 1, 0))
    return got


def _mask(shape):
    mask = np.zeros(shape, bool)
    mask[-4:, :5] = True
    mask[3, 3] = True
    return mask


@pytest.mark.parametrize("max_grid_size", [4, 8])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("shape", [(16, 16), (32, 32)], ids=["16x16", "32x32"])
def test_design_mesh_matches_jax(shape, masked, max_grid_size):
    varmap = _variance_map(shape)
    mask = _mask(shape) if masked else None
    segment_sum.reset_launch_counts()
    counts = []
    for thresh in THRESHOLDS:
        graph, recon, n = t_md.design_mesh(varmap, mask, thresh, max_grid_size, device="cpu")
        j_graph, j_recon, j_n = j_md.design_mesh(varmap, mask, thresh, max_grid_size)
        assert n == j_n and recon.shape == shape
        np.testing.assert_array_equal(graph.pixel_node[0].numpy(), np.asarray(j_graph.pixel_node))
        assert float(np.abs(recon - np.asarray(j_recon)).max()) <= RECON_TOL
        if mask is not None:
            assert (recon[mask] == 0).all()
        counts.append(n)
    assert counts == sorted(counts, reverse=True) and counts[0] > counts[-1]
    assert sum(segment_sum.LAUNCHES.values()) == 0 == sum(segment_sum.LAUNCHES_BF16.values())


def test_sweep_meshes_matches_jax():
    varmap = _variance_map((32, 32), seed=1)
    for mask in (None, _mask((32, 32))):
        got = t_md.sweep_meshes(varmap, mask, THRESHOLDS, device="cpu")
        assert got == j_md.sweep_meshes(varmap, mask, THRESHOLDS)
        assert list(got) == [float(t) for t in THRESHOLDS]


def test_design_mesh_graph_is_on_the_device():
    varmap = _variance_map((16, 16))
    graph, recon, n = t_md.design_mesh(varmap, None, 0.004, device="cpu")
    assert graph.pixel_node.device == torch.device("cpu") and isinstance(recon, np.ndarray)
    assert graph.pixel_node.shape == (1, 256) and int(graph.n_nodes[0]) == n
