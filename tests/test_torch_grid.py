"""PyTorch port vs JAX package: the pixelwise grid backend
(``aggregation="grid"``) — ``shift_in``, ``neighbor_valid``, ``dir_attrs``
(bit-identical), ``grid_sym_coeff`` and ``grid_a_mul`` (≤1e-6), the grid
graph build with 5 variables and a mask, and the identity-mapped
``flatten``/``unflatten``. Grids are 13×20 and 16×24 with masks, so the
column count is not a multiple of 8 in one of them."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import NEG_INF
from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.graph.state import unflatten as j_unflatten
from quadtree_mpnnlstm_tpu.ops import grid as jgrid
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.graph.state import flatten, unflatten
from quadtree_mpnnlstm_tpu_torch.models.conv import a_mul
from quadtree_mpnnlstm_tpu_torch.ops import grid
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding

SHAPES = [(16, 24), (13, 20)]
SHIFTS = grid.SHIFTS_8
TOL = 1e-6


def _mask(shape, seed=0, p=0.2):
    return np.random.default_rng(seed).random(shape) < p


def _frames(shape, b=2, t=3, c=5, seed=1):
    rng = np.random.default_rng(seed)
    return rng.random((b, t, *shape, c)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dr,dc", SHIFTS)
def test_shift_in_and_neighbor_valid_match_jax(shape, dr, dc):
    z = _frames(shape, b=2, t=1, c=3)[:, 0]  # (B, rows, cols, 3)
    valid = ~_mask(shape)
    out = grid.shift_in(torch.from_numpy(z), dr, dc).numpy()
    nb = grid.neighbor_valid(torch.from_numpy(valid)[None], dr, dc)[0].numpy()
    for b in range(2):
        np.testing.assert_array_equal(out[b], np.asarray(jgrid.shift_in(jnp.asarray(z[b]), dr, dc)))
    np.testing.assert_array_equal(nb, np.asarray(jgrid.neighbor_valid(jnp.asarray(valid), dr, dc)))


@pytest.mark.parametrize("corners", [False, True])
@pytest.mark.parametrize("resolution", [0.25, 1.0])
def test_dir_attrs_bit_identical(corners, resolution):
    mine = grid.dir_attrs(corners, resolution)
    assert mine.dtype == np.float32
    np.testing.assert_array_equal(mine, jgrid.dir_attrs(corners, resolution))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("corners", [False, True])
def test_grid_sym_coeff_and_a_mul_match_jax(shape, corners):
    mask = _mask(shape, seed=2)
    cfg = GraphConfig(image_shape=shape, thresh=NEG_INF, aggregation="grid",
                      edges_at_corners=corners)
    coeff = grid.grid_sym_coeff(torch.from_numpy(~mask), corners, 0.25)
    ref = jgrid.grid_sym_coeff(jnp.asarray(~mask), corners, 0.25)
    np.testing.assert_allclose(coeff.numpy(), np.asarray(ref), rtol=0, atol=TOL)

    x = _frames(shape, b=2, t=1, c=4, seed=3)
    g, _ = image_to_graph(add_positional_encoding(torch.from_numpy(x)), cfg,
                          mask=torch.from_numpy(mask))
    z = np.random.default_rng(4).standard_normal((2, shape[0] * shape[1], 7)).astype(np.float32)
    mine = a_mul(torch.from_numpy(z), g).numpy()
    jcfg = JGraphConfig(image_shape=shape, thresh=NEG_INF, aggregation="grid",
                        edges_at_corners=corners)
    jg, _ = j_image_to_graph(j_posenc(jnp.asarray(x[0])), jcfg, mask=jnp.asarray(mask))
    for b in range(2):
        np.testing.assert_allclose(mine[b], np.asarray(jgrid.grid_a_mul(jnp.asarray(z[b]), jg)),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("corners,edge_attrs", [(False, True), (True, False)])
def test_grid_graph_matches_jax(shape, corners, edge_attrs):
    """5 variables and a mask: the mapping, counts, validity and edge
    attributes identical; the stencil planes and node data ≤1e-6."""
    mask = _mask(shape, seed=5)
    x = _frames(shape, seed=6)
    kw = dict(image_shape=shape, thresh=NEG_INF, aggregation="grid",
              edges_at_corners=corners, use_edge_attrs=edge_attrs)
    g, data = image_to_graph(add_positional_encoding(torch.from_numpy(x)), GraphConfig(**kw),
                             mask=torch.from_numpy(mask))
    p = shape[0] * shape[1]
    assert g.mapping_identity and g.agg == ("grid", *shape, 8 if corners else 4)
    assert g.edge_src is None and g.n_max == p and int(g.overflow.max()) == 0
    assert data.shape == (2, 3, p, 5 + 3)
    for b in range(2):
        jg, jdata = j_image_to_graph(j_posenc(jnp.asarray(x[b])), JGraphConfig(**kw),
                                     mask=jnp.asarray(mask))
        np.testing.assert_array_equal(g.pixel_node[b].numpy(), np.asarray(jg.pixel_node))
        np.testing.assert_array_equal(g.counts[b].numpy(), np.asarray(jg.counts))
        np.testing.assert_array_equal(g.node_valid[b].numpy(), np.asarray(jg.node_valid))
        assert int(g.n_nodes[b]) == int(jg.n_nodes)
        np.testing.assert_array_equal(g.grid_attr.numpy(), np.asarray(jg.grid_attr))
        np.testing.assert_allclose(g.grid_coeff.numpy(), np.asarray(jg.grid_coeff), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(data[b].numpy(), np.asarray(jdata), rtol=0, atol=TOL)


def test_identity_flatten_unflatten():
    """flatten is a masked reshape and unflatten its inverse on valid
    pixels, as in the JAX package; masked pixels read ``fill``."""
    shape = SHAPES[1]
    mask = _mask(shape, seed=7)
    x = _frames(shape, seed=8)
    kw = dict(image_shape=shape, thresh=NEG_INF, aggregation="grid")
    g, _ = image_to_graph(add_positional_encoding(torch.from_numpy(x)), GraphConfig(**kw),
                          mask=torch.from_numpy(mask))
    flat = flatten(torch.from_numpy(x), g)
    assert flat.shape == (2, 3, shape[0] * shape[1], 5)
    back = unflatten(flat[:, 0], g, shape, fill=-1.0).numpy()
    np.testing.assert_array_equal(back[:, ~mask], x[:, 0][:, ~mask])
    assert (back[:, mask] == -1.0).all()
    jg, _ = j_image_to_graph(j_posenc(jnp.asarray(x[0])), JGraphConfig(**kw),
                             mask=jnp.asarray(mask))
    np.testing.assert_array_equal(
        back[0], np.asarray(j_unflatten(jnp.asarray(flat[0, 0].numpy()), jg, shape, fill=-1.0)))


def test_grid_config_checks():
    with pytest.raises(ValueError, match="pixelwise"):
        GraphConfig(image_shape=(8, 8), thresh=0.1, aggregation="grid")
    with pytest.raises(ValueError, match="n_max"):
        GraphConfig(image_shape=(8, 8), thresh=NEG_INF, aggregation="grid", n_max=32)
    edge_list = GraphConfig(image_shape=(8, 8), thresh=NEG_INF, aggregation="xla")
    assert (edge_list.n_max, edge_list.e_max) == (64, 256)
    with pytest.raises(ValueError, match="aggregation"):
        GraphConfig(image_shape=(8, 8), thresh=NEG_INF, aggregation="cuda")
    with pytest.raises(ValueError, match="not ported"):
        GraphConfig(image_shape=(8, 8), thresh=NEG_INF, aggregation="pallas")
    # a JAX-style graph_kwargs may carry grid_attn, which the port keeps
    # (it launches its grid attention kernels for either value)
    tp = NextFramePredictorS2S((8, 8), NEG_INF, decompose=False, device="cpu",
                               graph_kwargs=dict(aggregation="grid", grid_attn="pallas"))
    assert tp.gcfg.aggregation == "grid" and tp.gcfg.grid_attn == "pallas"
    with pytest.raises(ValueError, match="grid_attn"):
        GraphConfig(image_shape=(8, 8), thresh=NEG_INF, aggregation="grid", grid_attn="fused")
    assert GraphConfig(image_shape=(8, 8), thresh=NEG_INF, aggregation="grid").n_max == 64
