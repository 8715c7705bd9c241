"""PyTorch port vs JAX package: the training loss and its gradient.

The JAX side is ``jax.value_and_grad`` of a per-sample loss built from
``Seq2Seq.encode``/``decode`` and ``LOSSES["MSE"]`` (one re-encode per
truncated-BPTT chunk, the sum of the chunk means), vmapped over the batch
and averaged, with the Pallas kernels in interpret mode; its gradient is
clipped at a global norm of 10 with optax. The port side is
``NextFramePredictorS2S.train_step`` (at lr 0, so it leaves the weights
as they were) and the ``.grad`` it leaves, mapped onto the flax tree
through ``params_from_jax``. f32, dropout 0, the same weights.

Remeshing amplifies every difference, so the meshes every decoder step ran
on are asserted identical before the gradients are compared. A ReLU or a
quadtree cell that sits within rounding of its kink can flip between two
f32 programs; the inputs come from a seed on which none does.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax

SHAPE = (16, 16)
T_IN = T_OUT = 3
MODEL = dict(hidden_size=8, n_layers=2, n_conv_layers=2, dropout=0.0)
GRAPH = dict(max_grid_size=8, n_max=256, e_max=2048, node_budget=256,
             aggregation="pallas", agg_nt=128, agg_eb=512, agg_sw=256)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _jax_predictor(tf):
    return JPredictor(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                      teacher_forcing_ratio=tf, model_kwargs=dict(MODEL, remat=False),
                      graph_kwargs=dict(GRAPH))


def _port(tf, weights, run_dir):
    tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", teacher_forcing_ratio=tf, run_dir=str(run_dir),
                               model_kwargs=dict(MODEL), graph_kwargs=dict(GRAPH))
    tp.load_jax_params(weights)
    return tp


@pytest.fixture(scope="module")
def setup():
    ds = ModMovingMNISTDataset(2, T_IN, T_OUT, canvas_size=SHAPE, digit_size=(8, 8),
                               pixel_noise=0.02, velocity_noise=0.0, seed=1)
    jp = _jax_predictor(0.0)
    jp._ensure_params()
    weights = jax.tree.map(np.asarray, jp.params)
    mesh = jax.jit(lambda frames: j_image_to_graph(j_posenc(frames), jp.gcfg)[0].pixel_node)
    forecast = jax.jit(jax.vmap(lambda xb: jp.eval_model.apply(jp.params, xb)))
    y_hat = np.asarray(forecast(jnp.asarray(ds.x)))
    return ds, weights, mesh, y_hat


def _assert_meshes_identical(setup, tp, tf):
    """The mesh of every decoder step equals the JAX package's: the
    encoder's, then one built from each step's frame (the prediction, or
    the target where the step was teacher-forced)."""
    ds, _, mesh, y_hat = setup
    model = tp.model.train()
    with torch.no_grad():
        state = model.encode(torch.from_numpy(ds.x))
        _, _, meshes = model.decode(state, T_OUT, y=torch.from_numpy(ds.y),
                                    teacher_forcing_ratio=tf,
                                    generator=torch.Generator().manual_seed(0))
    frames = ds.y if tf == 1.0 else y_hat
    for b in range(len(ds.x)):
        want = [mesh(jnp.asarray(ds.x[b]))] + [mesh(jnp.asarray(f[None])) for f in frames[b]]
        for t in range(T_OUT):
            np.testing.assert_array_equal(meshes[t, b].numpy(), np.asarray(want[t]),
                                          err_msg=f"sample {b}, decoder step {t}")


def _jax_loss_and_grad(tf, weights, x, y, truncated):
    jp = _jax_predictor(tf)
    model = jp.model
    chunks = jp._chunks(truncated)
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}

    def sample_loss(params, xb, yb):
        total = 0.0
        for t0, n in chunks:
            state = model.apply(params, xb, method=JSeq2Seq.encode, rngs=rngs)
            _, y_hat = model.apply(params, state, t0, n, yb[t0:t0 + n],
                                   method=JSeq2Seq.decode, rngs=rngs)
            total = total + J_LOSSES["MSE"](y_hat, yb[t0:t0 + n], None)
        return total

    def batch_loss(params):
        return jnp.mean(jax.vmap(lambda xb, yb: sample_loss(params, xb, yb))(x, y))

    params = jax.tree.map(jnp.asarray, weights)
    loss, grads = jax.jit(jax.value_and_grad(batch_loss))(params)
    clip = optax.clip_by_global_norm(10.0)
    grads, _ = clip.update(grads, clip.init(params))
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("truncated,tf", [(0, 0.0), (2, 0.0), (0, 1.0)])
def test_train_step_loss_and_grads_match_jax(setup, truncated, tf, tmp_path):
    ds, weights, _, _ = setup
    tp = _port(tf, weights, tmp_path)
    _assert_meshes_identical(setup, tp, tf)

    j_loss, j_grads = _jax_loss_and_grad(tf, weights, jnp.asarray(ds.x), jnp.asarray(ds.y),
                                         truncated)
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    loss, overflow = tp.train_step(ds.x, ds.y, truncated_backprop=truncated)
    assert int(overflow) == 0
    assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    grads = {name: p.grad for name, p in tp.model.named_parameters()}
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        ref = j_grads[name]
        err = float((g - ref).abs().max())
        assert err <= GRAD_TOL * max(1.0, float(ref.abs().max())), (name, err)


def test_params_from_jax_reads_gradient_trees_with_or_without_params_level(setup):
    """A gradient tree has the parameters' structure; both forms map."""
    _, weights, _, _ = setup
    grads = jax.tree.map(lambda a: 2.0 * a, weights)
    full, inner = params_from_jax(grads), params_from_jax(grads["params"])
    assert full.keys() == inner.keys() == params_from_jax(weights).keys()
    for name, value in full.items():
        assert torch.equal(value, inner[name])
