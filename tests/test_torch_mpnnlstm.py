"""PyTorch port vs JAX package: the non-seq2seq baselines ``MPNNLSTM``
and ``MPNNLSTMI`` (``models/mpnnlstm.py``).

Both models on a pixelwise edge list (``pixelwise_graph``, a masked 12×20
grid) and on a quadtree mesh with Â blocks (``image_to_graph``, 16×16,
Pallas in interpret mode on the JAX side), dropout 0, the JAX weights
carried over by ``params_from_jax``: f32 outputs ≤1e-5 for ``MPNNLSTM``
and ≤1e-4, a rollout's bound, for ``MPNNLSTMI``, whose BatchNorm divides
by √(var + 1e-5) of features that are near constant over the rows (a
dead ReLU column: the 1e-7 differences of its input come out ×300, 4e-5
seen); in bf16 (both sides built and run in bf16) within the JAX
package's own bf16-vs-f32 bound (0.05, ``tests/test_baseline_models.py``)
of the JAX package's bf16 output and of the port's f32 output (the two
bf16 programs round at other places: 0.025 seen where JAX's own bf16
lies 0.020 from its f32), with every aggregation's operand and every
LSTM's input asserted bf16, so a bf16 model that ran in f32 fails. The
weight
map both ways, and ``BatchNorm``'s statistics over every row, the padded
ones included, against flax's.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as fnn

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.graph.build import pixelwise_graph as j_pixelwise_graph
from quadtree_mpnnlstm_tpu.models import mpnnlstm as jm
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import NEG_INF, GraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph, pixelwise_graph
from quadtree_mpnnlstm_tpu_torch.models.mpnnlstm import MPNNLSTM, MPNNLSTMI, BatchNorm
from quadtree_mpnnlstm_tpu_torch.ops import segment_sum as segment_sum_mod
from quadtree_mpnnlstm_tpu_torch.ops import spmm as spmm_mod
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding
from quadtree_mpnnlstm_tpu_torch.utils.weights import init_params, params_from_jax, params_to_jax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

T, HIDDEN = 3, 8
F32_TOL = {"MPNNLSTM": 1e-5, "MPNNLSTMI": 1e-4}
BF16_TOL = 0.05
MESHES = {
    "edge_list": dict(image_shape=(12, 20), max_grid_size=4, thresh=NEG_INF),
    "blocks": dict(image_shape=(16, 16), max_grid_size=8, thresh=0.3, n_max=256, e_max=2048,
                   aggregation="pallas", agg_nt=128, agg_eb=1024, agg_sw=256),
}


def _frames(mesh):
    rng = np.random.default_rng(2)
    shape = MESHES[mesh]["image_shape"]
    return (rng.random((T, *shape, 1)) ** 3).astype(np.float32)


def _mask(mesh):
    if mesh != "edge_list":
        return None
    mask = np.random.default_rng(0).random(MESHES[mesh]["image_shape"]) < 0.2
    mask[:2] = True
    return mask


def _jax_graph(mesh, dtype):
    cfg = JGraphConfig(**MESHES[mesh])
    img = j_posenc(jnp.asarray(_frames(mesh)).astype(dtype))
    mask = _mask(mesh)
    if mesh == "edge_list":
        return j_pixelwise_graph(img, cfg, mask=jnp.asarray(mask))
    return j_image_to_graph(img, cfg)


def _port_graph(mesh, dtype):
    cfg = GraphConfig(**MESHES[mesh])
    img = add_positional_encoding(torch.from_numpy(_frames(mesh)).to(dtype))[None]
    mask = _mask(mesh)
    if mesh == "edge_list":
        graph, data = pixelwise_graph(img, cfg, mask=torch.from_numpy(mask))
    else:
        graph, data = image_to_graph(img, cfg)
    return graph, data[0]


def _models(kind, dtype):
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    if kind == "MPNNLSTM":
        return (jm.MPNNLSTM(hidden_size=HIDDEN, dropout=0.0, input_timesteps=T, dtype=jdt),
                MPNNLSTM(4, HIDDEN, dropout=0.0, input_timesteps=T, dtype=tdt))
    return (jm.MPNNLSTMI(hidden_size=HIDDEN, dropout=0.0, n_layers=2, dtype=jdt),
            MPNNLSTMI(4, HIDDEN, dropout=0.0, n_layers=2, dtype=tdt))


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


_WEIGHTS = {}


def _weights(kind, mesh):
    """flax params of ``kind`` initialised on ``mesh`` in f32 (shared by
    the f32 and bf16 runs)."""
    if (kind, mesh) not in _WEIGHTS:
        jmodel, _ = _models(kind, "float32")
        jgraph, jdata = _jax_graph(mesh, jnp.float32)
        variables = jmodel.init(jax.random.PRNGKey(1), jdata, jgraph)
        _WEIGHTS[kind, mesh] = {"params": _nonzero_biases(
            jax.tree.map(np.asarray, variables["params"]), 3)}
    return _WEIGHTS[kind, mesh]


def _jax_out(kind, mesh, dtype):
    jmodel, _ = _models(kind, dtype)
    jgraph, jdata = _jax_graph(mesh, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    weights = _weights(kind, mesh)
    if kind == "MPNNLSTMI":
        out, _ = jmodel.apply(weights, jdata, jgraph, mutable=["batch_stats"])
    else:
        out = jmodel.apply(weights, jdata, jgraph)
    return np.asarray(out)


def _port_out(kind, mesh, dtype, weights=None, seen=None):
    """The port's output; ``seen`` (a list) receives the dtype of every
    aggregation's operand (the plain versions of K7 and K2) and every
    LSTM's input."""
    _, model = _models(kind, dtype)
    model.load_state_dict(params_from_jax(weights or _weights(kind, mesh)))
    graph, data = _port_graph(mesh, model.dtype)
    with contextlib.ExitStack() as stack:
        if seen is not None:
            for module, name in ((segment_sum_mod, "segment_sum_plain"),
                                 (spmm_mod, "apply_plain")):
                def record(*args, _fn=getattr(module, name), **kw):
                    seen.append(args[0].dtype)
                    return _fn(*args, **kw)
                stack.enter_context(mock.patch.object(module, name, record))
            for lstm in (m for m in model.modules() if isinstance(m, torch.nn.LSTM)):
                hook = lstm.register_forward_pre_hook(lambda _m, a: seen.append(a[0].dtype))
                stack.callback(hook.remove)
        with torch.no_grad():
            out = model.eval()(data, graph)
    assert out.dtype == torch.float32 and out.shape == (graph.n_max, 1)
    return out.numpy()


CASES = [(k, m) for k in ("MPNNLSTM", "MPNNLSTMI") for m in MESHES]


@pytest.mark.parametrize("kind,mesh", CASES, ids=[f"{k}-{m}" for k, m in CASES])
def test_f32_matches_jax(kind, mesh):
    want = _jax_out(kind, mesh, "float32")
    got = _port_out(kind, mesh, "float32")
    assert np.isfinite(got).all() and 0 <= got.min() and got.max() <= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL[kind])


@pytest.mark.parametrize("kind,mesh", CASES, ids=[f"{k}-{m}" for k, m in CASES])
def test_bf16_matches_jax(kind, mesh):
    want = _jax_out(kind, mesh, "bfloat16")
    seen = []
    got = _port_out(kind, mesh, "bfloat16", seen=seen)
    # the model computes in bf16: every aggregation and LSTM takes bf16
    n_agg = 3 if kind == "MPNNLSTM" else T * 2
    n_lstm = 4 if kind == "MPNNLSTM" else 0
    assert seen == [torch.bfloat16] * (n_agg + n_lstm)
    assert np.abs(got - want).max() <= BF16_TOL
    assert np.abs(got - _port_out(kind, mesh, "float32")).max() <= BF16_TOL


@pytest.mark.parametrize("kind", ["MPNNLSTM", "MPNNLSTMI"])
def test_params_map_both_ways(kind):
    """flax tree → port → flax tree is the identity leaf for leaf; a port
    model's seeded weights → flax → port are its own, and forecast the
    same in both packages."""
    mesh = "edge_list"
    weights = _weights(kind, mesh)
    back = params_to_jax(params_from_jax(weights))
    flat = dict(jax.tree_util.tree_flatten_with_path(weights)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for key, leaf in flat.items():
        np.testing.assert_array_equal(flat_back[key], leaf, err_msg=str(key))

    _, model = _models(kind, "float32")
    init_params(model, torch.Generator().manual_seed(7))
    state = model.state_dict()
    assert all(torch.equal(state[k], v) for k, v in params_from_jax(params_to_jax(state)).items())
    jmodel, _ = _models(kind, "float32")
    jgraph, jdata = _jax_graph(mesh, jnp.float32)
    tree = jax.tree.map(jnp.asarray, params_to_jax(state))
    if kind == "MPNNLSTMI":
        want, _ = jmodel.apply(tree, jdata, jgraph, mutable=["batch_stats"])
    else:
        want = jmodel.apply(tree, jdata, jgraph)
    graph, data = _port_graph(mesh, torch.float32)
    with torch.no_grad():
        got = model.eval()(data, graph)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL[kind])


def test_batchnorm_takes_every_row_as_flax_does():
    """The statistics run over all rows, padded rows (here zero) included,
    with the fast variance; flax's BatchNorm without running averages
    gives the same, ≤1e-6. Without the padded rows they differ."""
    rng = np.random.default_rng(5)
    x = np.zeros((40, 6), np.float32)
    x[:25] = rng.standard_normal((25, 6)) * 3 + 1
    scale = rng.standard_normal(6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=False, epsilon=1e-5)
    variables = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": variables["batch_stats"]}
    want, _ = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        got = bn(torch.from_numpy(x))
        live = bn(torch.from_numpy(x[:25]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert np.abs(live.numpy() - got.numpy()[:25]).max() > 0.1
    mean = x.mean(0)
    var = np.maximum((x * x).mean(0) - mean * mean, 0)
    np.testing.assert_allclose(got.numpy(), (x - mean) / np.sqrt(var + 1e-5) * scale + bias,
                               rtol=0, atol=1e-5)


def test_training_mode_draws_dropout_from_the_generator():
    """In training mode dropout draws from the caller's generator only:
    the same seed gives the same output, another seed another."""
    graph, data = _port_graph("edge_list", torch.float32)
    model = MPNNLSTM(4, HIDDEN, dropout=0.5, input_timesteps=T)
    init_params(model, torch.Generator().manual_seed(0))
    model.train()
    with torch.no_grad():
        a = model(data, graph, torch.Generator().manual_seed(1))
        b = model(data, graph, torch.Generator().manual_seed(1))
        c = model(data, graph, torch.Generator().manual_seed(2))
        assert torch.equal(a, b) and not torch.equal(a, c)
        with pytest.raises(ValueError, match="Generator"):
            model(data, graph)
        with pytest.raises(ValueError, match="one mesh"):
            model(data[None], graph)
