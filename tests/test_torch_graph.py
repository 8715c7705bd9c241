"""PyTorch port vs JAX package: the assembled graph (edge list, edge
attributes, symmetric-norm coefficients, overflow counter), the segment
sum and the pixel ↔ node pooling, on the same inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.graph.state import unflatten as j_unflatten
from quadtree_mpnnlstm_tpu.ops.segment import segment_sum_nodes as j_segment_sum
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig as TGraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph as t_image_to_graph
from quadtree_mpnnlstm_tpu_torch.graph.state import unflatten as t_unflatten
from quadtree_mpnnlstm_tpu_torch.ops.segment import segment_sum_nodes as t_segment_sum
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc


def _stacks(shape, seed, batch=2, t=2):
    rng = np.random.default_rng(seed)
    return rng.random((batch, t, *shape, 1)).astype(np.float32) ** 3


def _build_both(cfg_kw, x, mask=None):
    jcfg = JGraphConfig(**cfg_kw)
    tcfg = TGraphConfig(**cfg_kw)
    tmask = None if mask is None else torch.from_numpy(mask)
    tg, tdata = t_image_to_graph(t_posenc(torch.from_numpy(x)), tcfg, mask=tmask)
    js = []
    for b in range(x.shape[0]):
        jmask = None if mask is None else jnp.asarray(mask)
        js.append(j_image_to_graph(j_posenc(jnp.asarray(x[b])), jcfg, mask=jmask))
    return tg, tdata, js


CASES = {
    "distance": dict(image_shape=(16, 16), thresh=0.2),
    "bearing": dict(image_shape=(16, 16), thresh=0.2, use_edge_attrs=True),
    "corners": dict(image_shape=(16, 16), thresh=0.3, edges_at_corners=True),
    "wide": dict(image_shape=(32, 24), thresh=0.1, use_edge_attrs=False),
    "budget": dict(image_shape=(32, 32), thresh=0.02, node_budget=100),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_matches_jax(case):
    kw = dict(max_grid_size=8, use_edge_attrs=False)
    kw.update(CASES[case])
    tg, tdata, js = _build_both(kw, _stacks(kw["image_shape"], seed=len(case)))
    for b, (jg, jdata) in enumerate(js):
        for name in ("pixel_node", "n_nodes", "edge_src", "edge_dst",
                     "edge_valid", "n_edges", "overflow", "node_valid"):
            np.testing.assert_array_equal(
                getattr(tg, name)[b].numpy(), np.asarray(getattr(jg, name)), err_msg=name
            )
        np.testing.assert_allclose(tg.edge_attr[b].numpy(), np.asarray(jg.edge_attr),
                                   atol=1e-6)
        np.testing.assert_allclose(tg.sym_coeff[b].numpy(), np.asarray(jg.sym_coeff),
                                   atol=1e-6)
        np.testing.assert_allclose(tg.node_xy[b].numpy(), np.asarray(jg.node_xy),
                                   atol=1e-5)
        np.testing.assert_allclose(tdata[b].numpy(), np.asarray(jdata), atol=1e-6)
        assert int(tg.n_edges[b]) > 0


def test_masked_graph_matches_jax():
    mask = np.zeros((16, 16), bool)
    mask[5:9, 2:7] = True
    kw = dict(image_shape=(16, 16), max_grid_size=8, thresh=0.2, use_edge_attrs=False)
    tg, _, js = _build_both(kw, _stacks((16, 16), seed=4), mask=mask)
    for b, (jg, _) in enumerate(js):
        np.testing.assert_array_equal(tg.edge_src[b].numpy(), np.asarray(jg.edge_src))
        np.testing.assert_array_equal(tg.pixel_node[b].numpy(), np.asarray(jg.pixel_node))
        np.testing.assert_allclose(tg.sym_coeff[b].numpy(), np.asarray(jg.sym_coeff),
                                   atol=1e-6)


def test_edge_capacity_overflow_matches_jax():
    kw = dict(image_shape=(16, 16), max_grid_size=8, thresh=0.01, use_edge_attrs=False,
              e_max=128)
    tg, _, js = _build_both(kw, _stacks((16, 16), seed=8))
    for b, (jg, _) in enumerate(js):
        assert int(jg.overflow) > 0
        assert int(tg.overflow[b]) == int(jg.overflow)
        np.testing.assert_array_equal(tg.edge_dst[b].numpy(), np.asarray(jg.edge_dst))
        assert int(tg.n_edges[b]) == 128


def test_window_overflow_matches_jax():
    kw = dict(image_shape=(16, 16), max_grid_size=8, thresh=0.01, use_edge_attrs=False,
              n_max=256, e_max=2048, aggregation="pallas", agg_nt=32, agg_eb=64,
              agg_sw=32)
    tg, _, js = _build_both(kw, _stacks((16, 16), seed=9))
    for b, (jg, _) in enumerate(js):
        assert int(jg.overflow) > 0
        assert int(tg.overflow[b]) == int(jg.overflow)


def test_carry_edges_false_drops_edge_list():
    kw = dict(image_shape=(16, 16), max_grid_size=8, thresh=0.2, use_edge_attrs=False,
              n_max=256, e_max=2048, aggregation="pallas", agg_nt=128, agg_eb=512,
              agg_sw=256, carry_edges=False)
    tg, _, js = _build_both(kw, _stacks((16, 16), seed=10))
    assert tg.edge_src is None and tg.sym_coeff is None and tg.node_xy is None
    assert tg.agg_meta is not None and tg.agg[0] == "pallas"
    for b, (jg, _) in enumerate(js):
        assert jg.edge_src is None
        assert int(tg.overflow[b]) == int(jg.overflow) == 0


def test_segment_sum_matches_jax_with_sentinels():
    rng = np.random.default_rng(0)
    n_max = 12
    vals = rng.standard_normal((3, 40, 5)).astype(np.float32)
    ids = rng.integers(0, n_max + 1, size=(3, 40))  # n_max = sentinel
    out = t_segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), n_max)
    for b in range(3):
        ref = j_segment_sum(jnp.asarray(vals[b]), jnp.asarray(ids[b]), n_max)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), atol=1e-6)


def test_unflatten_matches_jax():
    kw = dict(image_shape=(16, 16), max_grid_size=8, thresh=0.2, use_edge_attrs=False,
              n_max=64)
    tg, _, js = _build_both(kw, _stacks((16, 16), seed=13))
    rng = np.random.default_rng(1)
    data = rng.standard_normal((2, 64, 3)).astype(np.float32)
    img = t_unflatten(torch.from_numpy(data), tg, (16, 16), fill=-1.0)
    for b, (jg, _) in enumerate(js):
        ref = j_unflatten(jnp.asarray(data[b]), jg, (16, 16), fill=-1.0)
        np.testing.assert_array_equal(img[b].numpy(), np.asarray(ref))
