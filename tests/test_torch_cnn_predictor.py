"""PyTorch port vs JAX package: the CNN-LSTM trainer
``NextFramePredictorCNNLSTM`` (``train/cnn_predictor.py``).

At 12×16, hidden 4, T_in 2 → T_out 3, 2 layers, dropout 0, teacher
forcing 0, from the same perturbed weights:

* one epoch (two Adam steps of batch 2, lr 0.01, a mask) against the JAX
  trainer: each step's loss ≤1e-5 relative, the running variances ≤1e-5
  and every weight ≤1e-4 but the biases of the convs that feed a
  BatchNorm (see ``test_trainer_epoch_matches_jax``); the test loss of the
  JAX trainer's end state through the port ≤1e-5 relative;
* the learning rate lr · 0.95^(epoch // 3) at epochs 0, 3 and 6 on both;
* ``save``/``load``, the weight map both ways against the JAX model's
  forecast (≤1e-4), ``get_n_params``, and the port's init rules;
* ``use_climatology=True``, on which the JAX trainer's ``predict`` and
  ``train`` raise flax's ``ScopeParamShapeError``, raises the port's
  ``ValueError``.
"""

from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax.errors import ScopeParamShapeError

import quadtree_mpnnlstm_tpu.train.cnn_predictor as jcp
from quadtree_mpnnlstm_tpu.data.loader import ArrayDataset as JArrayDataset
from quadtree_mpnnlstm_tpu.data.loader import DataLoader as JDataLoader
from quadtree_mpnnlstm_tpu.models import cnnlstm as jm
from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader
from quadtree_mpnnlstm_tpu_torch.models import cnnlstm as tm
from quadtree_mpnnlstm_tpu_torch.train.cnn_predictor import NextFramePredictorCNNLSTM
from quadtree_mpnnlstm_tpu_torch.utils.weights import (
    cnnlstm_state_dict_from_jax,
    cnnlstm_variables_to_jax,
    init_params,
)
from test_torch_cnnlstm import (
    B, BN_FED_BIASES, HIDDEN, MODEL, OP_TOL, ROLLOUT_TOL, SHAPE, T_IN, T_OUT, _data, _np, _perturb,
    _t,
)
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

LOSS_RTOL, PARAM_TOL, LR = 1e-5, 1e-4, 0.01


TRAINER = dict(image_shape=SHAPE, input_features=1, teacher_forcing_ratio=0.0, **MODEL)


class _NoLog:
    """Stands in for the JAX trainer's metrics writer (no files, no
    TensorBoard import)."""

    def __init__(self, *args, **kwargs):
        pass

    def scalar(self, *args):
        pass

    def flush(self):
        pass


def _trainer_data():
    rng = np.random.default_rng(11)
    n = 2 * B
    x = rng.random((n, T_IN, *SHAPE, 1)).astype(np.float32)
    y = rng.random((n, T_OUT, *SHAPE, 1)).astype(np.float32)
    return x, y, np.arange(n, dtype=np.int64), _data()[2]


@pytest.fixture(scope="module")
def jax_trainer():
    """The JAX trainer after one epoch (two steps of batch 2, a mask) from
    perturbed weights (the port's init, moved off it), and those weights."""
    x, y, lds, mask = _trainer_data()
    model = NextFramePredictorCNNLSTM(**TRAINER, device="cpu", seed=5).model
    start = _perturb(cnnlstm_variables_to_jax(model.state_dict()))
    with mock.patch.object(jcp, "MetricsLogger", _NoLog):
        trainer = jcp.NextFramePredictorCNNLSTM(**TRAINER)
        trainer.variables = jax.tree_util.tree_map(jnp.asarray, start)
        trainer.train(JDataLoader(JArrayDataset(x, y, lds), batch_size=B),
                      JDataLoader(JArrayDataset(x[:B], y[:B], lds[:B]), batch_size=B),
                      n_epochs=1, lr=LR, mask=mask)
    return trainer, start


def test_trainer_epoch_matches_jax(jax_trainer, tmp_path):
    """One epoch from the same weights: each step's training loss ≤1e-5
    relative and every weight ≤1e-4 but five. The biases of the convs
    that feed a BatchNorm get a zero gradient up to rounding (the batch
    mean cancels them; ``test_seq2seq_gradients_match_jax``), and Adam
    divides each update by its gradient's own size, so each framework
    moves them by up to lr a step in a direction its rounding draws: they
    are held to that bound instead. The training losses do not see them
    (the batch mean cancels them); the running means and the test loss do,
    so the running variances (blind to a shift) are held ≤1e-5 and the
    test loss is held through the port's eval of the JAX trainer's end
    state ≤1e-5 relative."""
    j_trainer, start = jax_trainer
    x, y, lds, mask = _trainer_data()
    trainer = NextFramePredictorCNNLSTM(**TRAINER, device="cpu", run_dir=str(tmp_path))
    trainer.load_jax_params(start)
    trainer.train(DataLoader(ArrayDataset(x, y, lds), batch_size=B),
                  DataLoader(ArrayDataset(x[:B], y[:B], lds[:B]), batch_size=B),
                  n_epochs=1, lr=LR, mask=mask)
    np.testing.assert_allclose(trainer.train_loss, j_trainer.train_loss, rtol=LOSS_RTOL)

    want = _np(j_trainer.variables)
    got = trainer.model.state_dict()
    ref = cnnlstm_state_dict_from_jax(want)
    begin = cnnlstm_state_dict_from_jax(start)
    steps = len(x) // B
    for name, value in got.items():
        if name in BN_FED_BIASES:
            for end in (value, ref[name]):
                assert float((end - begin[name]).abs().max()) <= steps * LR * (1 + 1e-3)
        elif name.endswith(".mean"):
            continue
        elif name.endswith(".var"):
            assert float((value - ref[name]).abs().max()) <= OP_TOL, name
        else:
            assert float((value - ref[name]).abs().max()) <= PARAM_TOL, name

    port_eval = NextFramePredictorCNNLSTM(**TRAINER, device="cpu")
    port_eval.load_jax_params(want)
    _, test_loss = port_eval._eval(x[:B], y[:B], mask)
    assert abs(float(test_loss) - j_trainer.test_loss[0]) <= LOSS_RTOL * j_trainer.test_loss[0]


def test_trainer_lr_steps(jax_trainer, tmp_path):
    """lr · 0.95^(epoch // 3) at epochs 0, 3 and 6, on both trainers' own
    schedule, and on the port's after training epochs."""
    j_trainer, _ = jax_trainer
    trainer = NextFramePredictorCNNLSTM(**TRAINER, device="cpu", run_dir=str(tmp_path))
    trainer.initiate_training(LR, 0.95)
    saved = j_trainer._epoch
    try:
        for epoch in (0, 3, 6):
            want = LR * 0.95 ** (epoch // 3)
            j_trainer._epoch = trainer._epoch = epoch
            j_trainer._set_lr()
            trainer._set_lr()
            j_lr = float(j_trainer.opt_state[1].hyperparams["learning_rate"])
            assert j_lr == pytest.approx(want, rel=1e-6)
            assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(want, rel=1e-12)
    finally:
        j_trainer._epoch = saved
    x, y, lds, mask = _trainer_data()
    trainer = NextFramePredictorCNNLSTM(**TRAINER, device="cpu", run_dir=str(tmp_path))
    loader = DataLoader(ArrayDataset(x[:1], y[:1], lds[:1]), batch_size=1)
    trainer.train(loader, loader, n_epochs=7, lr=LR, lr_decay=0.5)
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(LR * 0.5 ** 2)
    assert np.isfinite(trainer.train_loss).all() and len(trainer.test_loss) == 7


def test_save_load_and_weight_map(tmp_path):
    """``save``/``load`` restore every weight and running statistic; the
    port's own init carried to the JAX model forecasts as the port does
    (≤1e-4), and back again leaf for leaf."""
    x, _, mask = _data()
    trainer = NextFramePredictorCNNLSTM(**TRAINER, device="cpu", run_dir=str(tmp_path), seed=3)
    with torch.no_grad():
        for name, buf in trainer.model.named_buffers():
            if name.endswith(".mean"):
                buf.normal_(0, 0.2, generator=torch.Generator().manual_seed(1))
    path = trainer.save(str(tmp_path))
    other = NextFramePredictorCNNLSTM(**TRAINER, device="cpu", seed=4)
    other.load(str(tmp_path))
    assert path.endswith(".pt")
    for (n, a), (_, b) in zip(trainer.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), n
    got = trainer.forecast(x, mask)
    variables = cnnlstm_variables_to_jax(trainer.model.state_dict())
    want = jm.CNNLSTMSeq2Seq(input_features=1, **MODEL).apply(
        variables, jnp.asarray(x), None, None, jnp.asarray(mask))
    assert float((got - _t(np.asarray(want))).abs().max()) <= ROLLOUT_TOL
    back = cnnlstm_state_dict_from_jax(variables)
    assert set(back) == set(trainer.model.state_dict())
    for n, v in trainer.model.state_dict().items():
        assert torch.equal(back[n], v), n
    assert trainer.get_n_params() == sum(
        np.asarray(a).size for a in jax.tree_util.tree_leaves(variables["params"]))


def test_init_rules():
    """The port's init: conv kernels lecun-normal (fan-in in · kh · kw),
    LSTM recurrent kernels orthogonal per gate, BatchNorm scale 1, biases
    0, running statistics 0 and 1."""
    model = tm.CNNLSTMSeq2Seq(1, 32, input_timesteps=2, output_timesteps=2)
    init_params(model, torch.Generator().manual_seed(0))
    w = model.encoder.conv2.weight
    assert abs(float(w.std()) - (1 / (32 * 9)) ** 0.5) < 0.1 * (1 / (32 * 9)) ** 0.5
    gate = model.decoder_lstm.lstm1.weight_hh_l0[:32]
    assert torch.allclose(gate @ gate.T, torch.eye(32), atol=1e-5)
    assert bool((model.encoder.bn1.weight == 1).all()) and bool((model.decoder.conv3.bias == 0).all())
    assert bool((model.encoder.bn2.mean == 0).all()) and bool((model.encoder.bn2.var == 1).all())




def test_climatology_fails_as_in_jax(jax_trainer, tmp_path):
    """``use_climatology=True``: the JAX trainer's ``predict`` and
    ``train`` raise ``ScopeParamShapeError`` (its decoder LSTM is built
    without the channel); the port's trainer raises a ``ValueError``, and
    so does its model given a channel it was not built for."""
    x, y, lds, _ = _trainer_data()
    loader = JDataLoader(JArrayDataset(x[:1], y[:1], lds[:1]), batch_size=1)
    clim = np.random.default_rng(0).random((366, *SHAPE)).astype(np.float32)
    with mock.patch.object(jcp, "MetricsLogger", _NoLog):
        j_trainer = jcp.NextFramePredictorCNNLSTM(**TRAINER, use_climatology=True)
        j_trainer.variables = jax_trainer[1]  # as its init builds them
        with pytest.raises(ScopeParamShapeError, match="decoder_lstm"):
            j_trainer.predict(loader, climatology=clim)
        with pytest.raises(ScopeParamShapeError, match="decoder_lstm"):
            j_trainer.train(loader, loader, climatology=clim, n_epochs=1)
    with pytest.raises(ValueError, match="use_climatology=True"):
        NextFramePredictorCNNLSTM(**TRAINER, use_climatology=True, device="cpu",
                                  run_dir=str(tmp_path))
    model = tm.CNNLSTMSeq2Seq(1, HIDDEN, input_timesteps=T_IN, output_timesteps=T_OUT)
    with pytest.raises(ValueError, match="ScopeParamShapeError"):
        model(torch.zeros((1, T_IN, *SHAPE, 1)), None, torch.zeros((1, T_OUT, *SHAPE, 1)))
