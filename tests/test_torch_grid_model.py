"""PyTorch port vs JAX package: the sea-ice flagship's model on the
pixelwise grid, cut to a 12×20 grid — ``TransformerConv``,
``FusedAttnGateStack`` and ``GConvLSTM`` on a grid graph (≤1e-5 absolute
plus 1e-5 relative: the 3-layer stacks reach values of 5), a whole
``Seq2Seq`` rollout with climatology on the fixed mesh (5 variables,
T_in 3 → T_out 4, hidden 8, 3 conv layers, the JAX side with
``grid_attn="pallas"``;
≤1e-4 per pixel against ``Seq2Seq.apply`` per sample), teacher forcing 1.0
(the raw-count size channel), a per-gate (``fused_gates=False``) JAX tree
loaded through ``params_from_jax`` (within the 2e-4/2e-5 of
tests/test_fused.py), and ``predict`` over ``IceDataset`` windows with
launch dates and a climatology against the JAX predictor. The Pallas
kernel runs in interpret mode; the port runs its plain versions."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.cli.ice_exp import synthetic_dataset as j_synthetic
from quadtree_mpnnlstm_tpu.config import NEG_INF
from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.config import ModelConfig as JModelConfig
from quadtree_mpnnlstm_tpu.data.ice_dataset import IceDataset as JIceDataset
from quadtree_mpnnlstm_tpu.data.ice_dataset import climatology_from_dataset as j_climatology
from quadtree_mpnnlstm_tpu.data.loader import DataLoader as JDataLoader
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models.cells import GConvLSTM as JGConvLSTM
from quadtree_mpnnlstm_tpu.models.conv import TransformerConv as JTransformerConv
from quadtree_mpnnlstm_tpu.models.fused import FusedAttnGateStack as JFusedAttn
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig, ModelConfig
from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import (
    IceDataset,
    climatology_from_dataset,
    synthetic_dataset,
)
from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.models.cells import GConvLSTM as TGConvLSTM
from quadtree_mpnnlstm_tpu_torch.models.fused import FusedAttnGateStack as TFusedAttn
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import Seq2Seq
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (12, 20)
P = SHAPE[0] * SHAPE[1]
B = 2
VARS = 5
T_IN, T_OUT = 3, 4
GRID = dict(image_shape=SHAPE, thresh=NEG_INF, aggregation="grid", use_edge_attrs=True)
# the JAX package takes its Pallas kernel only with grid_attn="pallas"; the
# port has one grid attention and no such field
J_GRID = dict(GRID, grid_attn="pallas")
MODEL = dict(hidden_size=8, dropout=0.1, input_features=VARS, input_timesteps=T_IN,
             output_timesteps=T_OUT, n_layers=1, n_conv_layers=3,
             convolution_type="TransformerConv")
X_VARS = ["siconc", "t2m", "v10", "u10", "sshf"]


def _mask():
    mask = np.random.default_rng(0).random(SHAPE) < 0.15
    mask[:2] = True
    return mask


def _nonzero_biases(params, seed):
    """The flax init zeroes every bias; give them values so the test sees
    every term."""
    rng = np.random.default_rng(seed)

    def fill(path, v):
        name = str(path[-1].key)
        if name == "bias" or name.startswith("b_"):
            return (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        return np.asarray(v)

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.fixture(scope="module")
def meshes():
    x = np.random.default_rng(1).random((B, 1, *SHAPE, 1)).astype(np.float32)
    mask = _mask()
    tg, _ = image_to_graph(t_posenc(torch.from_numpy(x)), GraphConfig(**GRID),
                           mask=torch.from_numpy(mask))
    jg, _ = j_image_to_graph(j_posenc(jnp.asarray(x[0])), JGraphConfig(**J_GRID),
                             mask=jnp.asarray(mask))
    assert jg.grid_attn_fused
    return tg, jg


def _feats(seed, width, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((B, P, width))).astype(np.float32)


def _flax_params(module, seed, *args):
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed), *args))


@pytest.mark.parametrize("fin,fout", [(9, 8), (8, 1)])
def test_transformer_conv_on_the_grid_matches_jax(meshes, fin, fout):
    tg, jg = meshes
    x = _feats(fin, fin)
    kw = dict(heads=1, concat=False, dropout=0.1, edge_dim=2)
    jmod = JTransformerConv(out_channels=fout, **kw)
    params = _nonzero_biases(_flax_params(jmod, 1, jnp.asarray(x[0]), jg), 2)
    tmod = tconv.TransformerConv(fin, fout, **kw).eval()
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), tg).numpy()
    for b in range(B):
        ref = jmod.apply(params, jnp.asarray(x[b]), jg)
        np.testing.assert_allclose(out[b], np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fx,layers", [(8, 3), (4, 1)])
def test_fused_attn_gate_stack_and_cell_on_the_grid_match_jax(meshes, fx, layers):
    """The gate stack (8 streams as the heads of one call) and the
    GConvLSTM around it."""
    tg, jg = meshes
    d = 8
    x, h, c = _feats(1, fx), _feats(2, d, 0.5), _feats(3, d, 0.5)
    jmod = JFusedAttn("TransformerConv", d, n_layers=layers)
    params = _nonzero_biases(
        _flax_params(jmod, 3, jnp.asarray(x[0]), jnp.asarray(h[0]), jg), 4)
    tmod = TFusedAttn(fx, d, d, n_layers=layers).eval()
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    jcell = JGConvLSTM(out_channels=d, n_conv_layers=layers, convolution_type="TransformerConv")
    cparams = _nonzero_biases(_flax_params(jcell, 5, jnp.asarray(x[0]), jg, jnp.asarray(h[0]),
                                           jnp.asarray(c[0])), 6)
    tcell = TGConvLSTM(fx, d, n_conv_layers=layers, convolution_type="TransformerConv").eval()
    tcell.load_state_dict(state_dict_from_flax(cparams["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), torch.from_numpy(h), tg).numpy()
        outs = tcell(torch.from_numpy(x), tg, torch.from_numpy(h), torch.from_numpy(c))
    for b in range(B):
        ref = jmod.apply(params, jnp.asarray(x[b]), jnp.asarray(h[b]), jg)
        np.testing.assert_allclose(out[:, b], np.asarray(ref), rtol=1e-5, atol=1e-5)
        refs = jcell.apply(cparams, jnp.asarray(x[b]), jg, jnp.asarray(h[b]), jnp.asarray(c[b]))
        for mine, r in zip(outs, refs):
            np.testing.assert_allclose(mine[b].numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ Seq2Seq


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(4)
    x = rng.random((B, T_IN, *SHAPE, VARS)).astype(np.float32)
    y = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    clim = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    return x, y, clim, _mask()


def _jax_model(fused_gates=True, **kw):
    cfg = JModelConfig(**MODEL, fused_gates=fused_gates)
    return JSeq2Seq(cfg, JGraphConfig(**J_GRID), use_climatology=True, **kw)


def _port_model(weights, fuse_gates=False):
    model = Seq2Seq(ModelConfig(**MODEL), GraphConfig(**GRID), use_climatology=True).eval()
    model.load_state_dict(params_from_jax(weights, fuse_gates=fuse_gates))
    return model


def _jax_weights(model, inputs, seed):
    x, _, clim, mask = inputs
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(x[0]), None, jnp.asarray(clim[0]),
                        jnp.asarray(mask))
    return _nonzero_biases(jax.tree.map(np.asarray, params), seed + 1)


def test_rollout_with_climatology_matches_jax(inputs):
    """Fixed mesh, climatology concat flattened once, ≤1e-4 per pixel."""
    x, _, clim, mask = inputs
    jm = _jax_model()
    weights = _jax_weights(jm, inputs, 0)
    model = _port_model(weights)
    assert model.decoder.fc_out1.lin_query.in_features == 8 + 1
    with torch.no_grad():
        y_hat, state, meshes = model.rollout(torch.from_numpy(x), mask=torch.from_numpy(mask),
                                             climatology=torch.from_numpy(clim))
    assert y_hat.shape == (B, T_OUT, *SHAPE, 1) and int(state.graph.overflow.max()) == 0
    assert (meshes == meshes[0]).all()  # one mesh for the whole rollout
    apply = jax.jit(lambda xb, cb: jm.apply(weights, xb, None, cb, jnp.asarray(mask)))
    for b in range(B):
        ref = np.asarray(apply(jnp.asarray(x[b]), jnp.asarray(clim[b])))
        np.testing.assert_allclose(y_hat[b].numpy(), ref, rtol=0, atol=1e-4)


def test_teacher_forcing_on_the_fixed_mesh_matches_jax(inputs):
    """Ratio 1.0: every next input is the true frame on the same mesh, with
    the raw pixel count as its size channel, as in the JAX package."""
    x, y, clim, mask = inputs
    jm = _jax_model(teacher_forcing_ratio=1.0)
    weights = _jax_weights(jm, inputs, 2)
    model = _port_model(weights)
    with torch.no_grad():
        state = model.encode(torch.from_numpy(x), mask=torch.from_numpy(mask))
        _, y_hat, _ = model.decode(state, T_OUT, y=torch.from_numpy(y),
                                   mask=torch.from_numpy(mask), teacher_forcing_ratio=1.0,
                                   generator=torch.Generator().manual_seed(0),
                                   climatology=torch.from_numpy(clim))
        free = model.rollout(torch.from_numpy(x), mask=torch.from_numpy(mask),
                             climatology=torch.from_numpy(clim))[0]
    assert not torch.allclose(y_hat[:, 1:], free[:, 1:])
    apply = jax.jit(lambda xb, yb, cb: jm.apply(weights, xb, yb, cb, jnp.asarray(mask),
                                                rngs={"sampling": jax.random.PRNGKey(0)}))
    for b in range(B):
        ref = np.asarray(apply(jnp.asarray(x[b]), jnp.asarray(y[b]), jnp.asarray(clim[b])))
        np.testing.assert_allclose(y_hat[b].numpy(), ref, rtol=0, atol=1e-4)


def test_per_gate_tree_loads_into_the_fused_layout(inputs):
    """The flagship's per-gate (``fused_gates=False``) checkpoint layout:
    vmapped ``conv_x``/``conv_h`` TransformerConv stacks, stacked into the
    fused gate layout (``params_from_jax(..., fuse_gates=True)``); the
    rollout matches the JAX per-gate model."""
    x, _, clim, mask = inputs
    jm = _jax_model(fused_gates=False)
    weights = _jax_weights(jm, inputs, 4)
    assert "conv_x" in weights["params"]["enc"]["encoder"]["rnn_0"]
    model = _port_model(weights, fuse_gates=True)
    n_jax = sum(np.asarray(v).size for v in jax.tree.leaves(weights))
    assert n_jax == sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        y_hat = model(torch.from_numpy(x), mask=torch.from_numpy(mask),
                      climatology=torch.from_numpy(clim)).numpy()
    apply = jax.jit(lambda xb, cb: jm.apply(weights, xb, None, cb, jnp.asarray(mask)))
    for b in range(B):
        ref = np.asarray(apply(jnp.asarray(x[b]), jnp.asarray(clim[b])))
        np.testing.assert_allclose(y_hat[b], ref, rtol=2e-4, atol=2e-5)


# ------------------------------------------------------------ data + predict


@pytest.fixture(scope="module")
def ice():
    ds, mask = synthetic_dataset(shape=SHAPE, years=(2016, 2017), seed=3)
    jds, jmask = j_synthetic(shape=SHAPE, years=(2016, 2017), seed=3)
    return ds, mask, jds, jmask


def test_ice_data_match_jax(ice):
    """The synthetic fields, the windows with their launch dates and the
    climatology are bit-identical to the JAX package's."""
    ds, mask, jds, jmask = ice
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(ds.times, jds.times)
    for v in X_VARS:
        np.testing.assert_array_equal(ds.variables[v], jds.variables[v])
    for train in (False, True):
        mine = IceDataset(ds, [2016], 3, T_IN, T_OUT, X_VARS, ["siconc"], train=train)
        ref = JIceDataset(jds, [2016], 3, T_IN, T_OUT, X_VARS, ["siconc"], train=train)
        for a, b in ((mine.x, ref.x), (mine.y, ref.y), (mine.launch_dates, ref.launch_dates)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(climatology_from_dataset(ds), j_climatology(jds))


def test_predict_with_climatology_matches_jax(ice):
    """``predict`` over two March windows with their launch dates and the
    day-of-year climatology, against the JAX predictor (which vmaps the
    batch, so its grid attention takes the XLA chain)."""
    ds, mask, _, _ = ice
    data = IceDataset(ds, [2016], 3, T_IN, T_OUT, X_VARS, ["siconc"])
    sub = ArrayDataset(data.x[:B], data.y[:B], data.launch_dates[:B])
    clim = climatology_from_dataset(ds)
    kw = dict(thresh=NEG_INF, decompose=False, input_features=VARS, input_timesteps=T_IN,
              output_timesteps=T_OUT, use_climatology=True,
              model_kwargs=dict(hidden_size=8, n_layers=1, n_conv_layers=3,
                                convolution_type="TransformerConv"),
              graph_kwargs=dict(aggregation="grid"))
    jp = JPredictor(SHAPE, **dict(kw, graph_kwargs=dict(aggregation="grid",
                                                        grid_attn="pallas")))
    jp._ensure_params()
    jout = jp.predict(JDataLoader(sub, batch_size=B), climatology=clim, mask=mask)
    tp = NextFramePredictorS2S(SHAPE, device="cpu", **kw)
    assert tp.gcfg.aggregation == "grid" and not tp.gcfg.attn_windows
    tp.load_jax_params(jax.tree.map(np.asarray, jp.params))
    tout = tp.predict(DataLoader(sub, batch_size=B), climatology=clim, mask=mask)
    assert tout.shape == jout.shape == (B, T_OUT, *SHAPE, 1) and tp.last_overflow == 0
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-4)
    # the climatology reaches the decoder: other normals, other forecasts
    other = tp.predict(DataLoader(sub, batch_size=B), climatology=clim[::-1], mask=mask)
    assert np.abs(other - tout).max() > 1e-4
