"""PyTorch port vs JAX package: the loss and gradient of one training step
of the sea-ice flagship's model on the pixelwise grid, cut to a 12×20
masked grid (5 variables, T_in 3 → T_out 4, hidden 8, 2 conv layers,
TransformerConv, climatology concat), with full BPTT and with truncated
BPTT of 2 steps.

The JAX side is ``jax.value_and_grad`` of the per-sample loss of
``Seq2Seq.encode``/``decode`` (one re-encode per chunk, the sum of the
chunk means) and ``LOSSES["MSE"]`` over the valid pixels, vmapped over
the batch and averaged, both chunkings in one compiled program; its
gradient is clipped at a global norm of 10 with optax. The port side is
``NextFramePredictorS2S.train_step`` at lr 0 and the ``.grad`` it leaves.
f32 and the same weights; dropout is 0 on both sides — the decoder
head's through ``ModelConfig.dropout``, the attention's by setting the
TransformerConv registry entry of both packages to 0 for this module.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

from quadtree_mpnnlstm_tpu.models import conv as jconv
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (12, 20)
T_IN, T_OUT, VARS, B = 3, 4, 5, 2
KW = dict(thresh=float("-inf"), decompose=False, input_features=VARS, input_timesteps=T_IN,
          output_timesteps=T_OUT, use_climatology=True,
          graph_kwargs=dict(aggregation="grid"))
# the JAX package takes its Pallas kernel only with grid_attn="pallas"
J_GRAPH = dict(aggregation="grid", grid_attn="pallas")
MODEL = dict(hidden_size=8, n_layers=1, n_conv_layers=2, dropout=0.0,
             convolution_type="TransformerConv")
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
TRUNCATIONS = (0, 2)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    x = rng.random((B, T_IN, *SHAPE, VARS)).astype(np.float32)
    y = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    clim = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    mask = rng.random(SHAPE) < 0.15
    mask[:2] = True
    with pytest.MonkeyPatch.context() as mp:
        for registry in (jconv.CONVOLUTION_KWARGS, tconv.CONVOLUTION_KWARGS):
            mp.setitem(registry, "TransformerConv",
                       dict(registry["TransformerConv"], dropout=0.0))
        jp = JPredictor(SHAPE, model_kwargs=dict(MODEL, remat=False),
                        **dict(KW, graph_kwargs=J_GRAPH))
        jp._ensure_params()
        weights = jax.tree.map(np.asarray, jp.params)
        ref = _jax_losses_and_grads(jp, weights, x, y, clim, mask)

        def port(run_dir):
            tp = NextFramePredictorS2S(SHAPE, device="cpu", model_kwargs=dict(MODEL),
                                       run_dir=str(run_dir), **KW)
            tp.load_jax_params(weights)
            assert tp.model.decoder.fc_out1.dropout == 0.0
            return tp

        yield x, y, clim, mask, ref, port


def _jax_losses_and_grads(jp, weights, x, y, clim, mask):
    """{truncation: (loss, clipped grads as a port state_dict)}."""
    model = jp.model
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}
    m = jnp.asarray(mask)

    def sample_loss(params, xb, yb, cb, chunks):
        total = 0.0
        for t0, n in chunks:
            state = model.apply(params, xb, mask=m, method=JSeq2Seq.encode, rngs=rngs)
            _, y_hat = model.apply(params, state, t0, n, yb[t0:t0 + n], cb[t0:t0 + n], m,
                                   method=JSeq2Seq.decode, rngs=rngs)
            total = total + J_LOSSES["MSE"](y_hat, yb[t0:t0 + n], m)
        return total

    def all_losses(params):
        out = {}
        for trunc in TRUNCATIONS:
            chunks = jp._chunks(trunc)
            losses = jax.vmap(lambda xb, yb, cb: sample_loss(params, xb, yb, cb, chunks))(
                jnp.asarray(x), jnp.asarray(y), jnp.asarray(clim))
            out[trunc] = jnp.mean(losses)
        return out

    params = jax.tree.map(jnp.asarray, weights)
    losses, grads = jax.jit(lambda p: (all_losses(p), {
        t: jax.grad(lambda q, t=t: all_losses(q)[t])(p) for t in TRUNCATIONS}))(params)
    clip = optax.clip_by_global_norm(10.0)
    out = {}
    for t in TRUNCATIONS:
        clipped, _ = clip.update(grads[t], clip.init(params))
        out[t] = (float(losses[t]), params_from_jax(jax.tree.map(np.asarray, clipped)))
    return out


@pytest.mark.parametrize("truncated", TRUNCATIONS)
def test_grid_train_step_loss_and_grads_match_jax(setup, truncated, tmp_path):
    x, y, clim, mask, ref, port = setup
    j_loss, j_grads = ref[truncated]
    tp = port(tmp_path)
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    loss, overflow = tp.train_step(x, y, mask=mask, truncated_backprop=truncated,
                                   climatology=clim)
    assert int(overflow) == 0
    assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    grads = {name: p.grad for name, p in tp.model.named_parameters()}
    assert set(grads) == set(j_grads)
    assert "decoder.fc_out2.lin_edge.weight" in grads and any(".gates.w_e_" in n for n in grads)
    for name, g in grads.items():
        r = j_grads[name]
        err = float((g - r).abs().max())
        assert err <= GRAD_TOL * max(1.0, float(r.abs().max())), (name, err)
