"""PyTorch port vs JAX package: ChebConv, FusedGateConvStack and
GConvLSTM on the same meshes, inputs and (carried-over) weights, ≤1e-5.
Both sides aggregate through their Â blocks (Pallas interpret mode on the
JAX side, the plain block product on the torch side)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models.cells import GConvLSTM as JGConvLSTM
from quadtree_mpnnlstm_tpu.models.conv import ChebConv as JChebConv
from quadtree_mpnnlstm_tpu.models.fused import FusedGateConvStack as JFused
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig as TGraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph as t_image_to_graph
from quadtree_mpnnlstm_tpu_torch.models.cells import GConvLSTM as TGConvLSTM
from quadtree_mpnnlstm_tpu_torch.models.conv import ChebConv as TChebConv
from quadtree_mpnnlstm_tpu_torch.models.fused import FusedGateConvStack as TFused
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from quadtree_mpnnlstm_tpu_torch.utils.weights import state_dict_from_flax

N_MAX = 512
BATCH = 2


@pytest.fixture(scope="module", params=["pallas", "xla"])
def meshes(request):
    kw = dict(image_shape=(32, 32), max_grid_size=8, thresh=0.2, use_edge_attrs=False,
              n_max=N_MAX, e_max=4096, aggregation=request.param, agg_nt=128,
              agg_eb=512, agg_sw=512)
    rng = np.random.default_rng(0)
    x = (rng.random((BATCH, 1, 32, 32, 1)) ** 4).astype(np.float32)
    tg, _ = t_image_to_graph(t_posenc(torch.from_numpy(x)), TGraphConfig(**kw))
    jgs = [j_image_to_graph(j_posenc(jnp.asarray(x[b])), JGraphConfig(**kw))[0]
           for b in range(BATCH)]
    return tg, jgs


def _feats(seed, width, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((BATCH, N_MAX, width))).astype(np.float32)


def _flax_params(module, seed, *args):
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed), *args))


@pytest.mark.parametrize("fin,fout", [(17, 16), (16, 1), (4, 8)])
def test_chebconv_matches_jax(meshes, fin, fout):
    tg, jgs = meshes
    x = _feats(fin, fin)
    jconv = JChebConv(out_channels=fout)
    params = _flax_params(jconv, 1, jnp.asarray(x[0]), jgs[0])
    tconv = TChebConv(fin, fout)
    tconv.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tconv(torch.from_numpy(x), tg).numpy()
    for b, jg in enumerate(jgs):
        ref = jconv.apply(params, jnp.asarray(x[b]), jg)
        np.testing.assert_allclose(out[b], np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("fx,fh,d,layers", [(4, 8, 8, 2), (8, 8, 8, 1), (4, 16, 16, 2)])
def test_fused_gate_stack_matches_jax(meshes, fx, fh, d, layers):
    tg, jgs = meshes
    x, h = _feats(1, fx), _feats(2, fh, 0.5)
    jmod = JFused("ChebConv", d, n_layers=layers)
    params = _flax_params(jmod, 3, jnp.asarray(x[0]), jnp.asarray(h[0]), jgs[0])
    tmod = TFused(fx, fh, d, n_layers=layers)
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), torch.from_numpy(h), tg).numpy()  # (g, B, N, d)
    for b, jg in enumerate(jgs):
        ref = jmod.apply(params, jnp.asarray(x[b]), jnp.asarray(h[b]), jg)
        np.testing.assert_allclose(out[:, b], np.asarray(ref), atol=1e-5)


def _nonzero_cell_params(params, seed):
    """The flax init zeroes peepholes and gate biases; give them values so
    the test sees every term."""
    rng = np.random.default_rng(seed)
    p = params["params"]
    for name in ("w_c_i", "w_c_f", "w_c_o", "b_i", "b_f", "b_c", "b_o"):
        p[name] = (0.3 * rng.standard_normal(p[name].shape)).astype(np.float32)
    return params


@pytest.mark.parametrize("fx,d,layers", [(4, 8, 2), (8, 8, 1)])
def test_gconvlstm_matches_jax(meshes, fx, d, layers):
    tg, jgs = meshes
    x, h, c = _feats(4, fx), _feats(5, d, 0.5), _feats(6, d, 0.5)
    jcell = JGConvLSTM(out_channels=d, n_conv_layers=layers, convolution_type="ChebConv")
    params = _flax_params(jcell, 7, jnp.asarray(x[0]), jgs[0], jnp.asarray(h[0]),
                          jnp.asarray(c[0]))
    params = _nonzero_cell_params(jax.tree.map(np.array, params), 8)
    tcell = TGConvLSTM(fx, d, n_conv_layers=layers)
    tcell.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        outs = tcell(torch.from_numpy(x), tg, torch.from_numpy(h), torch.from_numpy(c))
    for b, jg in enumerate(jgs):
        refs = jcell.apply(params, jnp.asarray(x[b]), jg, jnp.asarray(h[b]),
                           jnp.asarray(c[b]))
        for out, ref in zip(outs, refs):
            np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), atol=1e-5)
