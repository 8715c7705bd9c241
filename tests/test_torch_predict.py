"""PyTorch port vs JAX package: the whole forecast slice
(``NextFramePredictorS2S.predict``: encoder, decoder rollout with a remesh
at every step, Â-block aggregation) in f32, deterministic, with the JAX
weights carried over; ≤1e-4 max per pixel."""

import numpy as np
import pytest

import jax
import torch

from quadtree_mpnnlstm_tpu.data.loader import ArrayDataset as JArrayDataset
from quadtree_mpnnlstm_tpu.data.loader import DataLoader as JDataLoader
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader
from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.weights import init_params

SHAPE = (32, 32)
MODEL = dict(hidden_size=8, n_layers=2, n_conv_layers=2,
             convolution_type="ChebConv")
GRAPH = dict(max_grid_size=8, n_max=1024, e_max=8192, node_budget=1024,
             aggregation="pallas", agg_nt=128, agg_eb=512, agg_sw=512)


def _port(**kw):
    return NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=3, output_timesteps=3,
                                 device="cpu", model_kwargs=dict(MODEL),
                                 graph_kwargs=dict(GRAPH), **kw)


@pytest.fixture(scope="module")
def run():
    ds = ModMovingMNISTDataset(4, 3, 3, canvas_size=SHAPE, digit_size=(12, 12),
                               pixel_noise=0.02, velocity_noise=0.0, seed=3)
    jp = JPredictor(SHAPE, 0.1, input_timesteps=3, output_timesteps=3,
                    model_kwargs=dict(MODEL), graph_kwargs=dict(GRAPH))
    jp._ensure_params()
    jout = jp.predict(JDataLoader(JArrayDataset(ds.x, ds.y, ds.launch_dates), batch_size=2))
    tp = _port()
    tp.load_jax_params(jax.tree.map(np.asarray, jp.params))
    tout = tp.predict(DataLoader(ds, batch_size=2))
    return ds, jp, tp, jout, tout


def test_predict_matches_jax(run):
    _, _, _, jout, tout = run
    assert tout.shape == jout.shape == (4, 3, *SHAPE, 1)
    assert np.isfinite(tout).all()
    np.testing.assert_allclose(tout, jout, atol=1e-4)


def test_predict_graph_config_resolution_matches_jax(run):
    _, jp, tp, _, _ = run
    assert tp.gcfg.carry_edges is jp.gcfg.carry_edges is False
    assert tp.gcfg.use_edge_attrs is jp.gcfg.use_edge_attrs is False
    for field in ("max_grid_size", "n_max", "e_max", "node_budget", "agg_nt", "agg_eb",
                  "agg_sw", "thresh", "image_shape"):
        assert getattr(tp.gcfg, field) == getattr(jp.gcfg, field), field


def test_params_from_jax_fills_every_parameter(run):
    _, jp, tp, _, _ = run
    n_jax = sum(np.asarray(v).size for v in jax.tree.leaves(jp.params))
    assert n_jax == sum(p.numel() for p in tp.model.parameters())


def test_forecast_reports_meshes_and_overflow(run):
    ds, _, tp, _, tout = run
    y_hat, overflow, meshes = tp.forecast(ds.x[:2])
    np.testing.assert_array_equal(y_hat.numpy(), tout[:2])
    assert overflow.shape == (2,) and meshes.shape == (3, 2, SHAPE[0] * SHAPE[1])
    assert tp.last_overflow == int(overflow.max())
    # every step's mesh is a valid partition: ids run 0..n_nodes-1
    for step in meshes:
        for ids in step:
            assert set(ids.unique().tolist()) == set(range(int(ids.max()) + 1))


def test_seeded_init_follows_flax_fan_rules(run):
    """Same seed → same weights; every glorot tensor stays inside the flax
    initializer's bound for its shape, with a spread near the uniform's."""
    _, jp, _, _, _ = run
    first, again = _port(seed=21), _port(seed=21)
    for (name, p), q in zip(first.model.named_parameters(), again.model.parameters()):
        assert torch.equal(p, q), name
    flax_leaves = {"/".join(str(k.key) for k in path): np.asarray(v)
                   for path, v in jax.tree_util.tree_flatten_with_path(jp.params)[0]}
    own = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=3, output_timesteps=3,
                                device="cpu", model_kwargs=dict(MODEL),
                                graph_kwargs=dict(GRAPH), seed=5)
    sd = own.model.state_dict()
    for path, v in flax_leaves.items():
        parts = path.split("/")[3:]
        key = ".".join([{"enc": "encoder", "dec": "decoder"}[path.split("/")[1]]]
                       + [{"kernel": "weight", "scale": "weight"}.get(x, x) for x in parts])
        mine = sd[key].numpy()
        if parts[-1] == "kernel":
            mine = mine.T
        assert mine.shape == v.shape, key
        if np.all(v == v.flat[0]):  # constant inits: zeros or LayerNorm ones
            np.testing.assert_array_equal(mine, v)
        else:
            fan_in, fan_out = v.shape[-2], v.shape[-1]
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            assert np.abs(mine).max() <= limit and np.abs(v).max() <= limit, key
            assert 0.4 * limit < mine.std() < 0.75 * limit, key


def test_init_params_is_seeded():
    a, b = _port(seed=1).model, _port(seed=1).model
    init_params(b, torch.Generator().manual_seed(2))
    assert not all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


@pytest.mark.parametrize("model,graph,thresh", [
    (dict(convolution_type="GCNConv"), {}, 0.1),
    (dict(rnn_type="GRU"), {}, 0.1),
    (dict(remesh_every=2), {}, 0.1),
    (dict(compute_dtype="bfloat16", convolution_type="TransformerConv"), {}, 0.1),
    (dict(compute_dtype="bfloat16"), dict(aggregation="grid", n_max=None, e_max=None,
                                          node_budget=None), float("-inf")),
    (dict(compute_dtype="bfloat16"), dict(aggregation="xla", n_max=None, e_max=None,
                                          node_budget=None), float("-inf")),
    (dict(convolution_type="GATConv"), {}, 0.1),
], ids=["convolution_type-GCNConv", "rnn_type-GRU", "remesh_every-2",
        "compute_dtype-bfloat16-TransformerConv", "compute_dtype-bfloat16-grid",
        "compute_dtype-bfloat16-edge-list", "convolution_type-GATConv"])
def test_unported_model_options_raise(model, graph, thresh):
    """The options that once raised "not ported" are ported now (GCNConv,
    bf16 TransformerConv on attention windows, bf16 on the grid and on the
    pixelwise edge list, the GRU cell, GATConv and, since ROADMAP Queue 1
    item 8, ``remesh_every`` > 1): each builds, and a forecast on the CPU
    gives finite f32 frames (two steps: with ``remesh_every=2`` the first
    keeps its mesh, the second remeshes)."""
    kw = dict(device="cpu", model_kwargs=dict(MODEL, **model), graph_kwargs=dict(GRAPH, **graph))
    tp = NextFramePredictorS2S(SHAPE, thresh, input_timesteps=2, output_timesteps=2, **kw)
    for field, value in model.items():
        assert getattr(tp.cfg, field) == value, field
    x = np.random.default_rng(0).random((1, 2, *SHAPE, 1)).astype(np.float32)
    y, _, meshes = tp.forecast(x)
    assert y.dtype == torch.float32 and y.shape == (1, 2, *SHAPE, 1)
    assert torch.isfinite(y).all()
    if model.get("remesh_every") == 2:
        assert torch.equal(meshes[0], meshes[1])


def test_default_conv_is_the_jax_packages_and_not_ported_yet():
    """Both packages' ``ModelConfig`` default to the same conv, GCNConv
    (ported since ROADMAP Queue 1 item 6, whatever this test's name says),
    so a bare ``Seq2Seq(ModelConfig(), …)`` builds the same model in both
    packages: GCN gate stacks in every cell and GCN head convs, with the
    same parameter names and shapes."""
    import jax.numpy as jnp

    from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
    from quadtree_mpnnlstm_tpu.config import ModelConfig as JModelConfig
    from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
    from quadtree_mpnnlstm_tpu_torch.config import GraphConfig, ModelConfig
    from quadtree_mpnnlstm_tpu_torch.models.conv import GCNConv
    from quadtree_mpnnlstm_tpu_torch.models.seq2seq import Seq2Seq
    from quadtree_mpnnlstm_tpu_torch.utils.weights import params_to_jax

    assert ModelConfig().convolution_type == JModelConfig().convolution_type == "GCNConv"
    shape = (16, 16)
    model = Seq2Seq(ModelConfig(), GraphConfig(image_shape=shape))
    assert model.encoder.rnn_0.gates.convolution_type == "GCNConv"
    assert isinstance(model.decoder.fc_out1, GCNConv) and isinstance(model.decoder.fc_out2, GCNConv)
    jm = JSeq2Seq(JModelConfig(), JGraphConfig(image_shape=shape))
    jparams = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                             jnp.zeros((3, *shape, 1), jnp.float32)))
    mine = params_to_jax(model.state_dict())
    assert jax.tree.map(np.shape, mine) == jax.tree.map(lambda a: a.shape, jparams)
