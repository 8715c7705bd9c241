"""PyTorch port vs JAX package: quadtree levels, node budget and the
pixel → node map must be bit-identical on the same inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph import quadtree as jq
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig as TGraphConfig
from quadtree_mpnnlstm_tpu_torch.graph import quadtree as tq


def _images(shape, seed, batch=3):
    """Smooth blobs plus noise, so every level of the tree gets used."""
    rng = np.random.default_rng(seed)
    rows, cols = shape
    r = np.arange(rows)[:, None]
    c = np.arange(cols)[None, :]
    imgs = []
    for _ in range(batch):
        cy, cx = rng.uniform(0, rows), rng.uniform(0, cols)
        blob = np.exp(-((r - cy) ** 2 + (c - cx) ** 2) / (2 * (rows / 6) ** 2))
        imgs.append(blob + 0.05 * rng.random(shape))
    return np.stack(imgs).astype(np.float32)


def _compare(cfg_kw, imgs, mask=None):
    jcfg = JGraphConfig(**cfg_kw)
    tcfg = TGraphConfig(**cfg_kw)
    tmask = None if mask is None else torch.from_numpy(mask)
    t_level = tq.decompose_levels(torch.from_numpy(imgs), tcfg, mask=tmask)
    t_node, t_n, t_counts = tq.pixel_nodes_from_levels(t_level, tcfg, mask=tmask)
    for b in range(imgs.shape[0]):
        jmask = None if mask is None else jnp.asarray(mask)
        j_level = jq.decompose_levels(jnp.asarray(imgs[b]), jcfg, mask=jmask)
        j_node, j_n, j_counts = jq.pixel_nodes_from_levels(j_level, jcfg, mask=jmask)
        np.testing.assert_array_equal(t_level[b].numpy(), np.asarray(j_level))
        np.testing.assert_array_equal(t_node[b].numpy(), np.asarray(j_node))
        assert int(t_n[b]) == int(j_n)
        np.testing.assert_array_equal(t_counts[b].numpy(), np.asarray(j_counts))
    return t_n


@pytest.mark.parametrize("thresh", [0.05, 0.1, 0.3, 0.6])
@pytest.mark.parametrize("shape", [(16, 16), (32, 32), (24, 20)])
def test_levels_and_nodes_match_jax(thresh, shape):
    imgs = _images(shape, seed=int(thresh * 100) + shape[1])
    _compare(dict(image_shape=shape, max_grid_size=8, thresh=thresh), imgs)


@pytest.mark.parametrize("condition", ["max_smaller_than", "min_larger_than",
                                       "min_smaller_than"])
def test_other_conditions_match_jax(condition):
    imgs = _images((16, 16), seed=5)
    _compare(dict(image_shape=(16, 16), max_grid_size=8, thresh=0.3,
                  condition=condition, padding=1), imgs)


@pytest.mark.parametrize("budget", [24, 64, 200])
def test_node_budget_matches_jax(budget):
    imgs = _images((32, 32), seed=budget)
    n = _compare(dict(image_shape=(32, 32), max_grid_size=8, thresh=0.05,
                      node_budget=budget), imgs)
    assert (n <= max(budget, 16)).all()


@pytest.mark.parametrize("budget", [None, 48])
def test_masked_case_matches_jax(budget):
    rng = np.random.default_rng(11)
    mask = rng.random((16, 16)) < 0.08
    mask[:3, :5] = True
    imgs = _images((16, 16), seed=12)
    _compare(dict(image_shape=(16, 16), max_grid_size=8, thresh=0.2,
                  node_budget=budget), imgs, mask=mask)


def test_capacity_overflow_sentinel_matches_jax():
    imgs = _images((16, 16), seed=3)
    n = _compare(dict(image_shape=(16, 16), max_grid_size=4, thresh=0.01,
                      n_max=40), imgs)
    assert (n > 40).all()
