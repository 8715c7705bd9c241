"""PyTorch port vs JAX package: the sea-ice flagship's model on the
pixelwise edge list (``thresh=-inf``, ``aggregation="xla"``, the JAX
package's ``ice-xla`` workload), cut to a masked 24×32 grid: 5 variables,
T_in 3 → T_out 4, hidden 8, TransformerConv, climatology, the JAX weights
carried over by ``params_from_jax``.

* ``predict`` over ``IceDataset`` windows with launch dates and the
  day-of-year climatology against the JAX predictor, ≤1e-4 per pixel;
* teacher forcing 1.0 on the fixed mesh, where the next input's size
  channel is the raw node count, not ``resolution**2``, ≤1e-4;
* one ``train_step`` with truncated BPTT of 2 steps: the loss and every
  gradient leaf within 1e-4 × max(1, max|g|) of ``jax.value_and_grad`` of
  the JAX loss (one re-encode per chunk, the sum of the chunk means,
  clipped at a global norm of 10), dropout 0 on both sides — the decoder
  head's through ``ModelConfig.dropout``, the attention's by setting the
  TransformerConv registry entry of both packages to 0 for that test.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import NEG_INF
from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.config import ModelConfig as JModelConfig
from quadtree_mpnnlstm_tpu.data.loader import DataLoader as JDataLoader
from quadtree_mpnnlstm_tpu.models import conv as jconv
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig, ModelConfig
from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import (
    IceDataset,
    climatology_from_dataset,
    synthetic_dataset,
)
from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import Seq2Seq
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (24, 32)
B, VARS, T_IN, T_OUT = 2, 5, 3, 4
EDGE_LIST = dict(image_shape=SHAPE, thresh=NEG_INF, aggregation="xla", use_edge_attrs=True)
MODEL = dict(hidden_size=8, dropout=0.1, input_features=VARS, input_timesteps=T_IN,
             output_timesteps=T_OUT, n_layers=1, n_conv_layers=3,
             convolution_type="TransformerConv")
X_VARS = ["siconc", "t2m", "v10", "u10", "sshf"]
TOL, GRAD_TOL = 1e-4, 1e-4


def _mask():
    mask = np.random.default_rng(0).random(SHAPE) < 0.15
    mask[:3] = True
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


def test_predict_with_climatology_matches_jax():
    """``predict`` over two June windows of the synthetic fields, with
    their launch dates and the day-of-year climatology."""
    ds, band = synthetic_dataset(shape=SHAPE, years=(2016, 2017), seed=3)
    mask = band | _mask()
    data = IceDataset(ds, [2016], 6, T_IN, T_OUT, X_VARS, ["siconc"])
    sub = ArrayDataset(data.x[:B], data.y[:B], data.launch_dates[:B])
    clim = climatology_from_dataset(ds)
    kw = dict(thresh=NEG_INF, decompose=False, input_features=VARS, input_timesteps=T_IN,
              output_timesteps=T_OUT, use_climatology=True,
              model_kwargs=dict(hidden_size=8, n_layers=1, n_conv_layers=3,
                                convolution_type="TransformerConv"),
              graph_kwargs=dict(aggregation="xla"))
    jp = JPredictor(SHAPE, **kw)
    jp._ensure_params()
    weights = _nonzero_biases(jax.tree.map(np.asarray, jp.params), 1)
    jp.params = jax.tree.map(jnp.asarray, weights)
    jout = jp.predict(JDataLoader(sub, batch_size=B), climatology=clim, mask=mask)
    tp = NextFramePredictorS2S(SHAPE, device="cpu", **kw)
    assert tp.gcfg.aggregation == "xla" and tp.gcfg.carry_edges and tp.gcfg.pixelwise
    assert (tp.gcfg.n_max, tp.gcfg.e_max) == (SHAPE[0] * SHAPE[1], 4 * SHAPE[0] * SHAPE[1])
    tp.load_jax_params(weights)
    tout = tp.predict(DataLoader(sub, batch_size=B), climatology=clim, mask=mask)
    assert tout.shape == jout.shape == (B, T_OUT, *SHAPE, 1) and tp.last_overflow == 0
    np.testing.assert_allclose(tout, jout, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(4)
    x = rng.random((B, T_IN, *SHAPE, VARS)).astype(np.float32)
    y = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    clim = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    return x, y, clim, _mask()


def test_teacher_forcing_on_the_edge_list_matches_jax(inputs):
    """Ratio 1.0: every next input is the true frame pooled on the same
    mesh, with the raw node count (1 at a valid node, 0 at a padded row)
    as its size channel, as in the JAX package."""
    x, y, clim, mask = inputs
    jm = JSeq2Seq(JModelConfig(**MODEL), JGraphConfig(**EDGE_LIST), use_climatology=True,
                  teacher_forcing_ratio=1.0)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x[0]), None, jnp.asarray(clim[0]),
                     jnp.asarray(mask))
    weights = _nonzero_biases(jax.tree.map(np.asarray, params), 3)
    model = Seq2Seq(ModelConfig(**MODEL), GraphConfig(**EDGE_LIST), use_climatology=True).eval()
    model.load_state_dict(params_from_jax(weights))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        state = model.encode(t(x), mask=t(mask))
        assert not state.graph.mapping_identity
        _, y_hat, meshes = model.decode(state, T_OUT, y=t(y), mask=t(mask),
                                        teacher_forcing_ratio=1.0,
                                        generator=torch.Generator().manual_seed(0),
                                        climatology=t(clim))
        free = model.rollout(t(x), mask=t(mask), climatology=t(clim))[0]
    assert (meshes == meshes[0]).all()  # one mesh for the whole rollout
    assert not torch.allclose(y_hat[:, 1:], free[:, 1:])
    apply = jax.jit(lambda xb, yb, cb: jm.apply(weights, xb, yb, cb, jnp.asarray(mask),
                                                rngs={"sampling": jax.random.PRNGKey(0)}))
    for b in range(B):
        ref = np.asarray(apply(jnp.asarray(x[b]), jnp.asarray(y[b]), jnp.asarray(clim[b])))
        np.testing.assert_allclose(y_hat[b].numpy(), ref, rtol=0, atol=TOL)


def _jax_loss_and_grads(jp, weights, x, y, clim, mask, truncated):
    """The JAX loss of one step and its clipped gradient as a port
    state_dict."""
    model = jp.model
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}
    m = jnp.asarray(mask)
    chunks = jp._chunks(truncated)

    def sample_loss(params, xb, yb, cb):
        total = 0.0
        for t0, n in chunks:
            state = model.apply(params, xb, mask=m, method=JSeq2Seq.encode, rngs=rngs)
            _, y_hat = model.apply(params, state, t0, n, yb[t0:t0 + n], cb[t0:t0 + n], m,
                                   method=JSeq2Seq.decode, rngs=rngs)
            total = total + J_LOSSES["MSE"](y_hat, yb[t0:t0 + n], m)
        return total

    def loss(params):
        return jnp.mean(jax.vmap(lambda xb, yb, cb: sample_loss(params, xb, yb, cb))(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(clim)))

    params = jax.tree.map(jnp.asarray, weights)
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    clip = optax.clip_by_global_norm(10.0)
    clipped, _ = clip.update(grads, clip.init(params))
    return float(value), params_from_jax(jax.tree.map(np.asarray, clipped))


def test_train_step_loss_and_grads_match_jax(inputs, tmp_path, monkeypatch):
    x, y, clim, mask = inputs
    for registry in (jconv.CONVOLUTION_KWARGS, tconv.CONVOLUTION_KWARGS):
        monkeypatch.setitem(registry, "TransformerConv",
                            dict(registry["TransformerConv"], dropout=0.0))
    model = dict(hidden_size=8, n_layers=1, n_conv_layers=2, dropout=0.0,
                 convolution_type="TransformerConv")
    kw = dict(thresh=NEG_INF, decompose=False, input_features=VARS, input_timesteps=T_IN,
              output_timesteps=T_OUT, use_climatology=True,
              graph_kwargs=dict(aggregation="xla"))
    jp = JPredictor(SHAPE, model_kwargs=dict(model, remat=False), **kw)
    jp._ensure_params()
    weights = jax.tree.map(np.asarray, jp.params)
    j_loss, j_grads = _jax_loss_and_grads(jp, weights, x, y, clim, mask, truncated=2)
    tp = NextFramePredictorS2S(SHAPE, device="cpu", model_kwargs=model, run_dir=str(tmp_path),
                               **kw)
    tp.load_jax_params(weights)
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    loss, overflow = tp.train_step(x, y, mask=mask, truncated_backprop=2, climatology=clim)
    assert int(overflow) == 0
    assert abs(float(loss) - j_loss) <= 1e-5 * abs(j_loss)
    grads = {name: p.grad for name, p in tp.model.named_parameters()}
    assert set(grads) == set(j_grads)
    assert any(".gates.w_e_" in n for n in grads)
    for name, g in grads.items():
        r = j_grads[name]
        err = float((g - r).abs().max())
        assert err <= GRAD_TOL * max(1.0, float(r.abs().max())), (name, err)
