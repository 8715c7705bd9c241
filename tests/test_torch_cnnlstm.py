"""PyTorch port vs JAX package: the dense CNN-LSTM baseline family
(``models/cnnlstm.py``; its trainer in ``test_torch_cnn_predictor.py``).

At 12×16, hidden 4, T_in 2 → T_out 3, 2 layers, batch 2, dropout 0, with
flax variables perturbed off their init (so BatchNorm's running
statistics and the LSTM biases are not their trivial starting values) and
carried over by ``cnnlstm_state_dict_from_jax``:

* the encoder and decoder conv stacks, in eval (running statistics) and
  in training mode (batch statistics, running statistics moved once),
  and the position LSTM with and without a carry, ≤1e-5 per op;
* ``CNNLSTMSeq2Seq`` rollouts ≤1e-4 in eval and in training mode with
  teacher forcing 0 and 1, and with a climatology channel on a model
  built for it; the running statistics after a training forward (the
  encoder's T_in + T_out calls chained in call order) ≤1e-5; masked
  pixels exactly 0; ``CNNLSTM``'s single step on three input channels
  ≤1e-5 in eval and training mode;
* one training forward's loss ≤1e-5 relative and gradients ≤1e-4 ×
  max(1, max|g|), the BatchNorm-fed conv biases' gradients rounding noise
  on both sides;
* bf16 (both sides built and run in bf16) within the JAX package's own
  bf16-vs-f32 bound (0.05, ``tests/test_baseline_models.py``) of the JAX
  package's bf16 rollout and of the port's f32 one, with every conv and
  LSTM asserted to run on bf16 operands;
* ``input_features != 1``, on which flax raises ``ScopeParamShapeError``,
  raises the port's ``ValueError``.
"""

from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax.errors import ScopeParamShapeError

from quadtree_mpnnlstm_tpu.models import cnnlstm as jm
from quadtree_mpnnlstm_tpu_torch.models import cnnlstm as tm
from quadtree_mpnnlstm_tpu_torch.train.cnn_predictor import NextFramePredictorCNNLSTM
from quadtree_mpnnlstm_tpu_torch.utils.weights import (
    cnnlstm_state_dict_from_jax,
    cnnlstm_variables_to_jax,
    init_params,
)
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

B, T_IN, T_OUT, SHAPE, HIDDEN, LAYERS = 2, 2, 3, (12, 16), 4, 2
OP_TOL, ROLLOUT_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-4
LOSS_RTOL = 1e-5
BF16_TOL = 0.05
MODEL = dict(hidden_size=HIDDEN, input_timesteps=T_IN, output_timesteps=T_OUT,
             n_layers=LAYERS, dropout=0.0)
# the convs whose output a BatchNorm normalises: in training mode the batch
# mean cancels their bias, whose gradient is then zero up to rounding
BN_FED_BIASES = ("encoder.conv1.bias", "encoder.conv2.bias", "encoder.conv3.bias",
                 "decoder.conv1.bias", "decoder.conv2.bias")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(variables, seed=7):
    """Every leaf moved off its init: params by N(0, 0.1), running means
    by N(0, 0.2), running variances to U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        scale = 0.2 if path[-1].key == "mean" else 0.1
        return (a + rng.normal(0, scale, a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, variables)


def _data(c=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((B, T_IN, *SHAPE, c)).astype(np.float32)
    y = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    mask = np.zeros(SHAPE, bool)
    mask[0, :5] = True
    mask[7, 3] = True
    return x, y, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _leaf_errs(port_tree, jax_tree, prefix=""):
    out = {}
    for k, v in jax_tree.items():
        if isinstance(v, dict):
            out.update(_leaf_errs(port_tree[k], v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = float(np.abs(np.asarray(port_tree[k]) - np.asarray(v)).max())
    return out


@pytest.fixture(scope="module")
def seq_vars():
    """Perturbed flax variables of a ``CNNLSTMSeq2Seq`` (and of one built
    with a climatology channel), made by the port's init and weight map
    (a flax init would run the whole model; ``jax_trainer`` runs one)."""
    out = {}
    for kind, seed in (("plain", 1), ("clim", 2)):
        model = tm.CNNLSTMSeq2Seq(1, use_climatology=kind == "clim", **MODEL)
        init_params(model, torch.Generator().manual_seed(seed))
        out[kind] = _perturb(cnnlstm_variables_to_jax(model.state_dict()), seed)
    return out


def _port_seq(variables, tf=0.0, use_climatology=False, dtype=None):
    model = tm.CNNLSTMSeq2Seq(1, teacher_forcing_ratio=tf, use_climatology=use_climatology,
                              dtype=dtype, **MODEL)
    model.load_state_dict(cnnlstm_state_dict_from_jax(variables))
    return model


# ---------------------------------------------------------------- single ops


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_conv_stacks_match_jax(seq_vars, stack, train):
    """CNNEncoder / CNNDecoder: output and, in training mode, the running
    statistics after one call, ≤1e-5."""
    variables = {col: {stack: seq_vars["plain"][col][stack]}
                 for col in ("params", "batch_stats")}
    x = np.random.default_rng(3).random((B, *SHAPE, 1 if stack == "encoder" else HIDDEN))
    x = x.astype(np.float32)
    if stack == "encoder":
        jmod = jm.CNNEncoder(HIDDEN, dropout=0.0)
        pmod = tm.CNNEncoder(1, HIDDEN, dropout=0.0)
    else:
        jmod = jm.CNNDecoder(HIDDEN, 1, dropout=0.0)
        pmod = tm.CNNDecoder(HIDDEN, 1, dropout=0.0)
    inner = {col: variables[col][stack] for col in variables}
    pmod.load_state_dict(cnnlstm_state_dict_from_jax(inner))
    pmod.train(train)
    if train:
        want, upd = jmod.apply(inner, jnp.asarray(x), False, mutable=["batch_stats"])
    else:
        want = jmod.apply(inner, jnp.asarray(x), True)
    got = pmod(_t(x), torch.Generator())
    assert float((got - _t(np.asarray(want))).abs().max()) <= OP_TOL
    if train:
        stats = cnnlstm_variables_to_jax(pmod.state_dict())["batch_stats"]
        errs = _leaf_errs(stats, _np(upd["batch_stats"]))
        assert max(errs.values()) <= OP_TOL, errs


@pytest.mark.parametrize("carry", [False, True], ids=["zeros", "carry"])
def test_position_lstm_matches_jax(seq_vars, carry):
    rng = np.random.default_rng(4)
    n = B * SHAPE[0] * SHAPE[1]
    seq = rng.normal(size=(T_IN, n, HIDDEN)).astype(np.float32)
    state = (rng.normal(size=(LAYERS, n, HIDDEN)).astype(np.float32),
             rng.normal(size=(LAYERS, n, HIDDEN)).astype(np.float32)) if carry else None
    params = seq_vars["plain"]["params"]["encoder_lstm"]
    want, (h, c) = jm._PositionLSTM(HIDDEN, LAYERS).apply(
        {"params": params}, jnp.asarray(seq),
        None if state is None else tuple(jnp.asarray(s) for s in state))
    pmod = tm.PositionLSTM(HIDDEN, LAYERS)
    pmod.load_state_dict(cnnlstm_state_dict_from_jax({"params": params}))
    got, (gh, gc) = pmod(_t(seq), None if state is None else tuple(_t(s) for s in state))
    for a, b in ((got, want), (gh, h), (gc, c)):
        assert float((a - _t(np.asarray(b))).abs().max()) <= OP_TOL


# ---------------------------------------------------------------- rollouts

ROLLOUTS = {"eval": (True, 0.0, "plain"), "train_tf0": (False, 0.0, "plain"),
            "train_tf1": (False, 1.0, "plain"), "eval_climatology": (True, 0.0, "clim")}


@pytest.mark.parametrize("case", list(ROLLOUTS))
def test_seq2seq_matches_jax(seq_vars, case):
    det, tf, kind = ROLLOUTS[case]
    variables = seq_vars[kind]
    x, y, mask = _data()
    clim = np.random.default_rng(5).random((B, T_OUT, *SHAPE, 1)).astype(np.float32) \
        if kind == "clim" else None
    jmod = jm.CNNLSTMSeq2Seq(input_features=1, deterministic=det, teacher_forcing_ratio=tf,
                             **MODEL)
    args = (jnp.asarray(x), jnp.asarray(y), None if clim is None else jnp.asarray(clim),
            jnp.asarray(mask))
    if det:
        want, upd = jmod.apply(variables, *args), None
    else:
        key = jax.random.PRNGKey(0)
        want, upd = jmod.apply(variables, *args, rngs={"dropout": key, "sampling": key},
                               mutable=["batch_stats"])
    pmod = _port_seq(variables, tf, use_climatology=clim is not None)
    pmod.train(not det)
    got = pmod(_t(x), _t(y), None if clim is None else _t(clim), _t(mask),
               torch.Generator())
    assert got.dtype == torch.float32 and got.shape == (B, T_OUT, *SHAPE, 1)
    err = float((got - _t(np.asarray(want))).abs().max())
    assert err <= ROLLOUT_TOL, err
    assert bool((got[:, :, torch.from_numpy(mask)] == 0).all())  # the mask fill
    if upd is not None:
        stats = cnnlstm_variables_to_jax(pmod.state_dict())["batch_stats"]
        errs = _leaf_errs(stats, _np(upd["batch_stats"]))
        assert max(errs.values()) <= OP_TOL, errs


def test_cnnlstm_single_step_matches_jax():
    """``CNNLSTM`` (time-major frames, three input channels) in eval and
    training mode ≤1e-5."""
    x, _, _ = _data(c=3)
    xt = np.ascontiguousarray(np.swapaxes(x, 0, 1))  # (T_in, B, rows, cols, C)
    jmod = jm.CNNLSTM(input_features=3, hidden_size=HIDDEN, n_layers=LAYERS, dropout=0.0)
    pmod = tm.CNNLSTM(3, HIDDEN, n_layers=LAYERS, dropout=0.0)
    init_params(pmod, torch.Generator().manual_seed(3))
    variables = _perturb(cnnlstm_variables_to_jax(pmod.state_dict()), 3)
    assert set(variables["params"]) == {"encoder", "lstm", "decoder"}
    pmod.load_state_dict(cnnlstm_state_dict_from_jax(variables))
    for det in (True, False):
        want = jmod.apply(variables, jnp.asarray(xt), det, mutable=["batch_stats"])[0]
        got = pmod.train(not det)(_t(xt), torch.Generator())
        assert got.shape == (B, *SHAPE, 1)
        assert float((got - _t(np.asarray(want))).abs().max()) <= OP_TOL


def test_seq2seq_gradients_match_jax(seq_vars):
    """One training forward (teacher forcing 0) and the masked MSE: every
    parameter's gradient ≤1e-4 × max(1, max|g|); the BatchNorm-fed conv
    biases' gradients are rounding noise on both sides."""
    variables = seq_vars["plain"]
    x, y, mask = _data()
    jmod = jm.CNNLSTMSeq2Seq(input_features=1, deterministic=False, teacher_forcing_ratio=0.0,
                             **MODEL)
    w = jnp.asarray(~mask, jnp.float32)[None, None, :, :, None]

    def loss_fn(params):
        y_hat, _ = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(x), jnp.asarray(y), None, jnp.asarray(mask),
                              mutable=["batch_stats"])
        return jnp.sum(((y_hat - y) ** 2) * w) / jnp.sum(jnp.broadcast_to(w, y.shape))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    pmod = _port_seq(variables).train()
    y_hat = pmod(_t(x), _t(y), None, _t(mask), torch.Generator())
    wt = _t(~mask).float()[None, None, :, :, None]
    loss = (((y_hat - _t(y)) ** 2) * wt).sum() / wt.expand(y_hat.shape).sum()
    loss.backward()
    assert abs(float(loss) - float(j_loss)) <= LOSS_RTOL * abs(float(j_loss))
    grads = {n: p.grad for n, p in pmod.named_parameters()}
    grads.update({n: torch.zeros_like(b) for n, b in pmod.named_buffers()
                  if n.endswith("bias_ih_l0")})
    grads = cnnlstm_variables_to_jax(grads)
    j_grads = _np(j_grads)
    scale = max(1.0, max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(j_grads)))
    errs = _leaf_errs(grads["params"], j_grads)
    assert max(errs.values()) <= GRAD_TOL * scale, errs
    for name in BN_FED_BIASES:
        stack, conv, _ = name.split(".")
        assert float(np.abs(j_grads[stack][conv]["bias"]).max()) <= 1e-6 * scale


# ---------------------------------------------------------------- bf16


def test_bf16_matches_jax(seq_vars):
    """Both sides built and run in bf16 (eval): the port's rollout within
    the JAX package's own bf16-vs-f32 bound of the JAX package's bf16
    rollout and of the port's f32 one; every conv and LSTM runs on bf16
    operands."""
    variables = seq_vars["plain"]
    x, _, mask = _data()
    args = (jnp.asarray(x), None, None, jnp.asarray(mask))
    j16 = np.asarray(jm.CNNLSTMSeq2Seq(input_features=1, dtype=jnp.bfloat16, **MODEL)
                     .apply(variables, *args))
    seen = []
    conv, lstm = tm.conv_nhwc, tm.run_lstm

    def conv_spy(c, inp, dtype):
        seen.append(("conv", inp.dtype, c.weight.to(dtype).dtype))
        return conv(c, inp, dtype)

    def lstm_spy(module, inp, carry, dtype):
        seen.append(("lstm", inp.dtype, carry[0].dtype))
        return lstm(module, inp, carry, dtype)

    p16 = _port_seq(variables, dtype=torch.bfloat16).eval()
    with mock.patch.object(tm, "conv_nhwc", conv_spy), mock.patch.object(tm, "run_lstm", lstm_spy):
        got16 = p16(_t(x), None, None, _t(mask))
    got32 = _port_seq(variables).eval()(_t(x), None, None, _t(mask))
    assert got16.dtype == torch.float32
    assert seen and all(a == b == torch.bfloat16 for _, a, b in seen), set(seen)
    assert float((got16 - _t(j16)).abs().max()) < BF16_TOL
    assert float((got16 - got32).abs().max()) < BF16_TOL


# ---------------------------------------------------------------- JAX failures


def test_input_features_fail_as_in_jax():
    """``input_features=4`` (the JAX trainer's default and the sea-ice
    CLI's five x_vars): flax raises ``ScopeParamShapeError``; the port's
    model and trainer raise a ``ValueError`` naming the combination."""
    x = jnp.zeros((1, T_IN, *SHAPE, 4))
    with pytest.raises(ScopeParamShapeError, match="encoder/conv1"):
        jm.CNNLSTMSeq2Seq(input_features=4, **MODEL).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="input_features=4"):
        tm.CNNLSTMSeq2Seq(4, HIDDEN)
    with pytest.raises(ValueError, match="ScopeParamShapeError"):
        NextFramePredictorCNNLSTM(image_shape=SHAPE, device="cpu")  # input_features=4
