"""PyTorch port vs JAX package: the loss and gradient of one TransformerConv
training step.

The JAX side is ``jax.value_and_grad`` of the per-sample loss of
``Seq2Seq.encode``/``decode`` and ``LOSSES["MSE"]``, vmapped over the batch
and averaged, with the Pallas attention kernels in interpret mode and the
gradient clipped at a global norm of 10 with optax. The port side is
``NextFramePredictorS2S.train_step`` at lr 0 and the ``.grad`` it leaves.
f32 and the same weights; dropout is 0 on both sides — the decoder head's
through ``ModelConfig.dropout``, the attention's by setting the
TransformerConv registry entry of both packages to 0 for this module (the
two frameworks draw different random numbers). The meshes every decoder
step ran on are asserted identical before anything is compared.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models import conv as jconv
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (16, 16)
T_IN = T_OUT = 3
MODEL = dict(hidden_size=8, n_layers=2, n_conv_layers=2, dropout=0.0,
             convolution_type="TransformerConv")
GRAPH = dict(max_grid_size=8, n_max=256, e_max=2048, node_budget=256,
             aggregation="pallas", agg_nt=128, agg_eb=1024, agg_sw=256)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        for registry in (jconv.CONVOLUTION_KWARGS, tconv.CONVOLUTION_KWARGS):
            mp.setitem(registry, "TransformerConv",
                       dict(registry["TransformerConv"], dropout=0.0))
        ds = ModMovingMNISTDataset(2, T_IN, T_OUT, canvas_size=SHAPE, digit_size=(8, 8),
                                   pixel_noise=0.02, velocity_noise=0.0, seed=1)
        jp = JPredictor(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                        model_kwargs=dict(MODEL, remat=False), graph_kwargs=dict(GRAPH))
        jp._ensure_params()
        weights = jax.tree.map(np.asarray, jp.params)
        j_loss, j_grads, j_frames = _jax_loss_and_grad(jp, weights, ds)
        tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                                   device="cpu", model_kwargs=dict(MODEL),
                                   graph_kwargs=dict(GRAPH),
                                   run_dir=str(tmp_path_factory.mktemp("runs")))
        tp.load_jax_params(weights)
        assert tp.gcfg.attn_windows and tp.model.decoder.fc_out1.dropout == 0.0
        mesh = jax.jit(lambda f: j_image_to_graph(j_posenc(f), jp.gcfg)[0].pixel_node)
        yield ds, tp, j_loss, j_grads, j_frames, mesh


def _jax_loss_and_grad(jp, weights, ds):
    model = jp.model
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}

    def sample_loss(params, xb, yb):
        state = model.apply(params, xb, method=JSeq2Seq.encode, rngs=rngs)
        _, y_hat = model.apply(params, state, 0, T_OUT, yb, method=JSeq2Seq.decode, rngs=rngs)
        return J_LOSSES["MSE"](y_hat, yb, None), y_hat

    def batch_loss(params):
        losses, y_hat = jax.vmap(lambda xb, yb: sample_loss(params, xb, yb))(
            jnp.asarray(ds.x), jnp.asarray(ds.y))
        return jnp.mean(losses), y_hat

    params = jax.tree.map(jnp.asarray, weights)
    (loss, y_hat), grads = jax.jit(jax.value_and_grad(batch_loss, has_aux=True))(params)
    clip = optax.clip_by_global_norm(10.0)
    grads, _ = clip.update(grads, clip.init(params))
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads)), np.asarray(y_hat)


def test_meshes_identical(setup):
    """The encoder's mesh, then one built from each step's prediction."""
    ds, tp, _, _, j_frames, mesh = setup
    model = tp.model.train()
    with torch.no_grad():
        state = model.encode(torch.from_numpy(ds.x), generator=torch.Generator())
        _, _, meshes = model.decode(state, T_OUT, generator=torch.Generator())
    for b in range(len(ds.x)):
        want = [mesh(jnp.asarray(ds.x[b]))] + [mesh(jnp.asarray(f[None])) for f in j_frames[b]]
        for t in range(T_OUT):
            np.testing.assert_array_equal(meshes[t, b].numpy(), np.asarray(want[t]),
                                          err_msg=f"sample {b}, decoder step {t}")


def test_train_step_loss_and_grads_match_jax(setup):
    ds, tp, j_loss, j_grads, _, _ = setup
    test_meshes_identical(setup)
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    loss, overflow = tp.train_step(ds.x, ds.y)
    assert int(overflow) == 0
    assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    grads = {name: p.grad for name, p in tp.model.named_parameters()}
    assert set(grads) == set(j_grads)
    assert any(".gates.w_e_" in n for n in grads) and "decoder.fc_out2.lin_edge.weight" in grads
    for name, g in grads.items():
        ref = j_grads[name]
        err = float((g - ref).abs().max())
        assert err <= GRAD_TOL * max(1.0, float(ref.abs().max())), (name, err)
