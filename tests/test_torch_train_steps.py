"""PyTorch port vs JAX package: three Adam steps of the trainer.

``NextFramePredictorS2S.initiate_training`` + ``_get_train_step(False, k)``
of the JAX package, full BPTT (k = 0) and chunks of 2 steps (k = 2), (Pallas in interpret mode) against the port's
``initiate_training`` + ``train_step``, from the same weights, on three
batches made from a seed: f32, dropout 0, lr 0.01, global-norm clip 10.
From these random weights the gradient norm is above 10 at every step, so
the clip acts; the clip below and above its threshold is also held
against optax on its own. The
losses of steps 1–3 agree to 1e-4 relative, and the weights after step 3
to 1e-4 absolute, ten times the lr-scaled rounding seen on these inputs
(≤ 7e-6). That bound holds only while no gradient entry is rounding noise
around zero: Adam divides each update by the root of its second moment,
so such an entry moves its weight by up to lr a step, in a direction each
framework draws from its own rounding.
"""

import os

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S, clip_by_global_norm_
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax

SHAPE = (16, 16)
T_IN = T_OUT = 3
BATCH, STEPS = 2, 3
MODEL = dict(hidden_size=8, n_layers=2, n_conv_layers=2, dropout=0.0)
GRAPH = dict(max_grid_size=8, n_max=256, e_max=2048, node_budget=256,
             aggregation="pallas", agg_nt=128, agg_eb=1024, agg_sw=256)
LR = 0.01
LOSS_RTOL, PARAM_TOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Per chunk length: the JAX trainer's batches, losses and weights
    after the last step, and the initial weights."""
    ds = ModMovingMNISTDataset(BATCH * STEPS, T_IN, T_OUT, canvas_size=SHAPE,
                               digit_size=(8, 8), pixel_noise=0.02, velocity_noise=0.0,
                               seed=1)
    jp = JPredictor(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                    model_kwargs=dict(MODEL, remat=False), graph_kwargs=dict(GRAPH))
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("jax"))  # its metrics writer opens runs/ here
    try:
        jp.initiate_training(lr=LR, lr_decay=0.95)
    finally:
        os.chdir(cwd)
    jp._set_lr()
    weights = jax.tree.map(np.asarray, jp.params)
    clim = jnp.zeros((BATCH, T_OUT, *SHAPE, 1))
    mask = jnp.zeros(SHAPE, bool)
    runs = {}
    for truncated in (0, 2):
        step = jp._get_train_step(False, truncated)
        params, opt_state = jax.tree.map(jnp.asarray, weights), jp.optimizer.init(weights)
        batches, losses = [], []
        for i in range(STEPS):
            x = ds.x[i * BATCH:(i + 1) * BATCH]
            y = ds.y[i * BATCH:(i + 1) * BATCH]
            params, opt_state, loss, aux = step(params, opt_state, jnp.asarray(x),
                                                jnp.asarray(y), clim, mask, mask, None,
                                                jax.random.PRNGKey(0))
            assert int(aux["mesh_overflow"]) == 0
            batches.append((x, y))
            losses.append(float(loss))
        runs[truncated] = (batches, losses, params_from_jax(jax.tree.map(np.asarray, params)))
    return weights, runs


@pytest.mark.parametrize("truncated", [0, 2])
def test_three_adam_steps_match_jax(jax_run, truncated, tmp_path):
    weights, runs = jax_run
    batches, j_losses, j_params = runs[truncated]
    tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", run_dir=str(tmp_path),
                               model_kwargs=dict(MODEL), graph_kwargs=dict(GRAPH))
    tp.load_jax_params(weights)
    tp.initiate_training(lr=LR, lr_decay=0.95)
    norms = []
    for (x, y), j_loss in zip(batches, j_losses):
        loss, overflow = tp.train_step(x, y, truncated_backprop=truncated)
        assert int(overflow) == 0
        assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss), (float(loss), j_loss)
        norms.append(float(tp.last_grad_norm))
    assert min(norms) > 10.0, norms  # the clip acted at every step
    for name, p in tp.model.named_parameters():
        err = float((p.detach() - j_params[name]).abs().max())
        assert err <= PARAM_TOL, (name, err)


@pytest.mark.parametrize("norm", [3.0, 10.0, 37.0])
def test_clip_by_global_norm_matches_optax(norm):
    rng = np.random.default_rng(int(norm))
    leaves = [rng.standard_normal(shape).astype(np.float32) for shape in [(4, 3), (7,), (2, 2, 5)]]
    total = np.sqrt(sum((a.astype(np.float64) ** 2).sum() for a in leaves))
    leaves = [a * np.float32(norm / total) for a in leaves]
    clip = optax.clip_by_global_norm(10.0)
    want, _ = clip.update([jnp.asarray(a) for a in leaves], clip.init(leaves))
    grads = [torch.from_numpy(a.copy()) for a in leaves]
    got = clip_by_global_norm_(grads, 10.0)
    np.testing.assert_allclose(float(got), norm, rtol=1e-6)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
