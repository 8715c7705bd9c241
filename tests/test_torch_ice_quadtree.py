"""PyTorch port vs JAX package: the ice-quadtree workload's pieces
(``bench.py --workload ice-quadtree``: thresh 0.15 on the transformed
criterion ``dist_from_05``, node budget, attention windows, the "sort"
adjacency).

The graph build with the criterion transform and a high-interest region
is bit-identical to the JAX package's: the level maps, the node ids,
counts and node features, the edge list and the attention windows (the
edge attributes, a bearing and a distance that each framework's
``atan2``/``sqrt`` rounds its own way, within 1e-6, as
``tests/test_torch_graph.py`` holds the quadtree build's). A
scaled-down ice-quadtree forecaster (32×48, 5 variables, climatology,
TransformerConv on attention windows) runs its every decoder step on the
mesh the JAX package builds with the same transform and forecasts within
1e-4 per pixel. ``GraphConfig.adjacency``: ``"sort"`` runs,
``"csum"`` builds (its lists are held to the JAX package's in
``tests/test_torch_adjacency_csum.py``), any other value raises.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.cli.ice_exp import dist_from_05 as j_dist_from_05
from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.graph.quadtree import decompose_levels as j_decompose_levels
from quadtree_mpnnlstm_tpu.models import conv as jconv
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.graph.quadtree import decompose_levels, dist_from_05
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (32, 48)
B, VARS, T_IN, T_OUT = 2, 5, 2, 3
# bench.py make_ice_predictor(mesh="quadtree") scaled to 32×48: a node
# budget of a quarter of the pixels, e_max 8 × budget
BUDGET = 384
GRAPH = dict(max_grid_size=8, n_max=BUDGET, e_max=8 * BUDGET, node_budget=BUDGET,
             aggregation="pallas", agg_nt=128, agg_eb=1024, agg_sw=512, adjacency="sort")


def _fields(seed, t=1, c=1):
    """Smooth ice-fraction-like fields in [0, 1]: blocks of 8 × 8 with
    values near 0, near 1 and in between."""
    rng = np.random.default_rng(seed)
    coarse = rng.choice([0.0, 0.05, 0.5, 0.95, 1.0], size=(B, t, SHAPE[0] // 8, SHAPE[1] // 8, c))
    up = np.kron(coarse, np.ones((1, 1, 8, 8, 1)))
    return np.clip(up + 0.03 * rng.standard_normal(up.shape), 0.0, 1.0).astype(np.float32)


def _mask():
    mask = np.zeros(SHAPE, bool)
    mask[:3] = True
    mask[20:26, 30:40] = True
    return mask


def _hir():
    hir = np.zeros(SHAPE, bool)
    hir[np.arange(32), np.arange(32) + 8] = True  # a diagonal corridor
    return hir


def test_dist_from_05_matches_jax():
    x = np.random.default_rng(0).random((4, 37)).astype(np.float32)
    np.testing.assert_array_equal(dist_from_05(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_dist_from_05(jnp.asarray(x))))


@pytest.mark.parametrize("transform", [True, False])
@pytest.mark.parametrize("hir", [True, False])
@pytest.mark.parametrize("budget", [BUDGET, None])
def test_ice_quadtree_build_is_bit_identical(transform, hir, budget):
    """Levels, node ids, counts, node features, edges and attention
    windows of the build with ``transform_func`` and
    ``high_interest_region``, against the JAX package's, bit for bit."""
    kw = dict(GRAPH, image_shape=SHAPE, thresh=0.15, attn_windows=True, node_budget=budget)
    if budget is None:
        kw.update(n_max=SHAPE[0] * SHAPE[1], e_max=4 * SHAPE[0] * SHAPE[1], agg_eb=1024)
    x = _fields(1)
    mask, region = _mask(), (_hir() if hir else None)
    fn = (dist_from_05, j_dist_from_05) if transform else (None, None)
    tg, data = image_to_graph(
        add_positional_encoding(torch.from_numpy(x)), GraphConfig(**kw),
        mask=torch.from_numpy(mask),
        high_interest_region=None if region is None else torch.from_numpy(region),
        transform_func=fn[0])
    levels = decompose_levels(torch.from_numpy(x[:, 0, ..., 0]), GraphConfig(**kw),
                              mask=torch.from_numpy(mask),
                              high_interest_region=None if region is None
                              else torch.from_numpy(region), transform_func=fn[0])
    jcfg = JGraphConfig(**kw)
    for b in range(B):
        jm, jr = jnp.asarray(mask), None if region is None else jnp.asarray(region)
        jg, jdata = j_image_to_graph(j_posenc(jnp.asarray(x[b])), jcfg, mask=jm,
                                     high_interest_region=jr, transform_func=fn[1])
        jl = j_decompose_levels(jnp.asarray(x[b, 0, ..., 0]), jcfg, mask=jm,
                                high_interest_region=jr, transform_func=fn[1])
        np.testing.assert_array_equal(levels[b].numpy(), np.asarray(jl))
        for name in ("pixel_node", "n_nodes", "counts", "edge_src", "edge_dst", "edge_valid",
                     "overflow"):
            np.testing.assert_array_equal(getattr(tg, name)[b].numpy(),
                                          np.asarray(getattr(jg, name)), err_msg=name)
        np.testing.assert_allclose(tg.edge_attr[b].numpy(), np.asarray(jg.edge_attr),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(data[b].numpy(), np.asarray(jdata))
        jm_ = jg.attn_meta
        meta = tg.attn_meta
        np.testing.assert_array_equal(meta.s0[b].numpy(), np.asarray(jm_.s0)[:, 0])
        np.testing.assert_array_equal(meta.src_rel[b].numpy(), np.asarray(jm_.src_rel))
        np.testing.assert_array_equal(meta.dst_rel[b].numpy(), np.asarray(jm_.dst_rel))
        np.testing.assert_allclose(meta.attr[b].numpy(),
                                   np.asarray(jm_.attr_t).transpose(0, 2, 1), rtol=0,
                                   atol=1e-6)
    assert int(tg.overflow.max()) == 0
    if hir and budget is None:  # the corridor's pixels are single-pixel cells
        assert (levels[:, torch.from_numpy(_hir())] == GraphConfig(**kw).depth).all()


def test_high_interest_region_refines_the_corridor():
    """Without a budget every corridor pixel is its own cell, and the mesh
    has more nodes than without the region."""
    kw = dict(image_shape=SHAPE, max_grid_size=8, thresh=0.15)
    x = torch.from_numpy(_fields(2)[:, 0, ..., 0])
    plain = decompose_levels(x, GraphConfig(**kw), transform_func=dist_from_05)
    hir = torch.from_numpy(_hir())
    refined = decompose_levels(x, GraphConfig(**kw), high_interest_region=hir,
                               transform_func=dist_from_05)
    assert (refined[:, hir] == GraphConfig(**kw).depth).all()
    assert (refined >= plain).all() and (refined > plain).any()


def test_adjacency_sort_runs_and_csum_is_not_ported():
    """The name predates the csum port: ``"csum"`` now builds, on the
    config and through the ice-quadtree predictor's ``graph_kwargs``."""
    cfg = GraphConfig(image_shape=SHAPE, adjacency="sort")
    assert cfg.adjacency == "sort"
    assert GraphConfig(image_shape=SHAPE, adjacency="csum").adjacency == "csum"
    with pytest.raises(ValueError, match="adjacency"):
        GraphConfig(image_shape=SHAPE, adjacency="dense")
    tp = NextFramePredictorS2S(SHAPE, 0.15, device="cpu",
                               model_kwargs=dict(convolution_type="TransformerConv"),
                               graph_kwargs=dict(GRAPH, adjacency="csum"))
    assert tp.gcfg.adjacency == "csum" and tp.gcfg.attn_windows


MODEL = dict(hidden_size=8, dropout=0.1, n_layers=1, n_conv_layers=3,
             convolution_type="TransformerConv")


def test_ice_quadtree_forecast_matches_jax(tmp_path, monkeypatch):
    """The scaled ice-quadtree forecaster (``transform_func=dist_from_05``,
    climatology, attention windows, remat at its default): the encoder's
    mesh and every decoder mesh the JAX package builds from its own
    prediction with the same transform, and the frames within 1e-4 until
    the first mesh that differs."""
    for registry in (jconv.CONVOLUTION_KWARGS, tconv.CONVOLUTION_KWARGS):
        monkeypatch.setitem(registry, "TransformerConv",
                            dict(registry["TransformerConv"], dropout=0.0))
    kw = dict(input_features=VARS, input_timesteps=T_IN, output_timesteps=T_OUT,
              use_climatology=True)
    jp = JPredictor(SHAPE, 0.15, transform_func=j_dist_from_05,
                    model_kwargs=dict(MODEL, remat=True), graph_kwargs=dict(GRAPH), **kw)
    jp._ensure_params()
    weights = jax.tree.map(np.asarray, jp.params)
    tp = NextFramePredictorS2S(SHAPE, 0.15, transform_func=dist_from_05, device="cpu",
                               run_dir=str(tmp_path), model_kwargs=dict(MODEL),
                               graph_kwargs=dict(GRAPH), **kw)
    assert tp.gcfg.attn_windows and tp.model.remat == "full"
    tp.load_jax_params(weights)
    x = _fields(3, T_IN, VARS)
    clim = _fields(4, T_OUT)
    mask = _mask()
    y_hat, overflow, meshes = tp.forecast(x, mask=mask, climatology=clim)
    assert int(overflow.max()) == 0
    y_hat, meshes = y_hat.numpy(), meshes.numpy()
    jm = jnp.asarray(mask)
    apply = jax.jit(lambda xb, cb: jp.eval_model.apply(weights, xb, None, cb, jm))
    mesh_of = jax.jit(lambda f: j_image_to_graph(j_posenc(f), jp.gcfg, mask=jm,
                                                 transform_func=j_dist_from_05)[0].pixel_node)
    compared = 0
    for b in range(B):
        ref = np.asarray(apply(jnp.asarray(x[b]), jnp.asarray(clim[b])))
        frames = [x[b]] + [ref[t:t + 1] for t in range(T_OUT - 1)]
        same = [np.array_equal(meshes[t, b], np.asarray(mesh_of(jnp.asarray(f))))
                for t, f in enumerate(frames)]
        assert same[0], "the encoder's mesh differs"
        steps = same.index(False) if False in same else T_OUT
        np.testing.assert_allclose(y_hat[b, :steps], ref[:steps], rtol=0, atol=1e-4)
        compared += steps
    assert compared >= B
