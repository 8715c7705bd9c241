"""PyTorch port vs JAX package: the GRU, shared-conv, split and dummy
cells, the dummy model mode and the Seq2Seq models of the new convs, on
the same meshes, inputs and carried-over weights.

* ``GConvGRU`` fused (GCN, Cheb, Transformer, MH gate stacks) and
  per-gate (and GAT's, which has no fused stack), ``GConvLSTMSimple``,
  ``SplitGConvLSTM`` (``torch.nn.LSTM`` along the node axis) and
  ``DummyLSTM``, loaded leaf for leaf: outputs within 1e-5, gradients
  within 1e-4 × max(1, max|g|); a per-gate GRU tree stacked by
  ``fuse_cell_gates`` into the fused GRU gives the same outputs;
* a bf16 GRU step on the JAX package's bf16 Â blocks within two bf16
  roundings;
* a Seq2Seq rollout of every ``rnn_type``, of ``dummy=True`` and of the
  MH, GATConv and GATv2Conv models, ≤1e-4 per pixel until the first
  quadtree mesh that differs from the one the JAX prediction gives, a
  ``params_to_jax`` round trip of each tree and the port's init in each
  tree's layout with the JAX package's fans;
* a teacher-forced train step's loss and gradients against
  ``jax.value_and_grad`` for GRU, SplitLSTM, MH and GATConv, ≤1e-4 ×
  max(1, max|g|).
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models import cells as jcells
from quadtree_mpnnlstm_tpu.models import conv as jconv
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig as TGraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph as t_image_to_graph
from quadtree_mpnnlstm_tpu_torch.models import cells as tcells
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from quadtree_mpnnlstm_tpu_torch.utils.weights import (
    fuse_cell_gates,
    init_params,
    params_from_jax,
    params_to_jax,
    state_dict_from_flax,
)
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

B = 2
CELL_TOL, GRAD_TOL, ROLLOUT_TOL = 1e-5, 1e-4, 1e-4
BF16 = torch.bfloat16
QUAD = dict(image_shape=(32, 32), max_grid_size=8, thresh=0.2, n_max=512, e_max=4096,
            agg_nt=128, agg_eb=1024, agg_sw=512)
MESHES = {
    "blocks": dict(QUAD, aggregation="pallas", use_edge_attrs=False),
    "windows": dict(QUAD, aggregation="pallas", attn_windows=True),
    "edge_list": dict(QUAD, aggregation="xla"),
}
MESH_OF = {"GCNConv": "blocks", "ChebConv": "blocks", "TransformerConv": "windows",
           "MHTransformerConv": "windows", "GATConv": "edge_list"}


@pytest.fixture(autouse=True)
def no_attention_dropout(monkeypatch):
    """Attention dropout off in both registries: the two frameworks draw
    other random numbers."""
    for registry in (jconv.CONVOLUTION_KWARGS, tconv.CONVOLUTION_KWARGS):
        for conv in ("TransformerConv", "MHTransformerConv"):
            monkeypatch.setitem(registry, conv, dict(registry[conv], dropout=0.0))


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    r, c = np.arange(shape[0])[:, None], np.arange(shape[1])[None, :]
    frames = []
    for _ in range(B):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        blob = np.exp(-((r - cy) ** 2 + (c - cx) ** 2) / (2 * (shape[0] / 5) ** 2))
        frames.append(blob + 0.02 * rng.random(shape))
    return np.stack(frames)[:, None, :, :, None].astype(np.float32)


_CACHE = {}


def _mesh(mesh, bf16=False):
    """(port graph of the batch, the JAX graph of each sample), cached."""
    if (mesh, bf16) not in _CACHE:
        kw = MESHES[mesh]
        x = _frames(kw["image_shape"], 0)
        tg, _ = t_image_to_graph(t_posenc(torch.from_numpy(x).to(BF16 if bf16 else torch.float32)),
                                 TGraphConfig(**kw))
        jgs = [j_image_to_graph(j_posenc(jnp.asarray(x[b], jnp.bfloat16 if bf16
                                                     else jnp.float32)), JGraphConfig(**kw))[0]
               for b in range(B)]
        assert int(tg.overflow.max()) == 0
        _CACHE[mesh, bf16] = tg, jgs
    return _CACHE[mesh, bf16]


def _nonzero(params, seed):
    """The flax init zeroes biases and peepholes; give them values so the
    test sees every term."""
    rng = np.random.default_rng(seed)

    def fill(path, v):
        name = str(path[-1].key)
        if name == "bias" or name.startswith(("b_", "w_c_")):
            return (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        return np.asarray(v)

    return jax.tree_util.tree_map_with_path(fill, params)


def _rel_err(a, b):
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def _check_cell(jcell, tcell, mesh, fx=4, d=8, grads=True):
    """``tcell`` loaded leaf for leaf from ``jcell``'s tree: (O, H, C)
    within 1e-5 and, with ``grads``, the gradients of a weighted sum of
    them with respect to every leaf and to x and h within 1e-4 ×
    max(1, max|g|). Returns the JAX parameters."""
    tg, jgs = _mesh(mesh)
    n = tg.n_max
    rng = np.random.default_rng(2)
    x, h, c = (rng.standard_normal((B, n, w)).astype(np.float32) * s
               for w, s in ((fx, 1.0), (d, 0.5), (d, 0.5)))
    wo, wh, wc = (rng.standard_normal((B, n, d)).astype(np.float32) for _ in range(3))
    params = _nonzero(jax.tree.map(np.asarray, jcell.init(
        jax.random.PRNGKey(3), jnp.asarray(x[0]), jgs[0], jnp.asarray(h[0]),
        jnp.asarray(c[0]))), 4)
    tcell.load_state_dict(state_dict_from_flax(params["params"]))
    tcell.eval()
    xs = [torch.from_numpy(a).requires_grad_(grads) for a in (x, h, c)]
    outs = tcell(xs[0], tg, xs[1], xs[2])
    if grads:
        sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, (wo, wh, wc))).backward()

    def j_loss(p, xb, hb, cb, jg, wb):
        o, hn, cn = jcell.apply(p, xb, jg, hb, cb)
        return (o * wb[0]).sum() + (hn * wb[1]).sum() + (cn * wb[2]).sum(), (o, hn, cn)

    grad = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True))
    j_params = {}
    for b, jg in enumerate(jgs):
        (_, refs), (gp, gx, gh) = grad(params, x[b], h[b], c[b], jg, (wo[b], wh[b], wc[b]))
        for mine, ref in zip(outs, refs):
            np.testing.assert_allclose(mine[b].detach().numpy(), np.asarray(ref), rtol=0,
                                       atol=CELL_TOL)
        if grads:
            for leaf, ref in zip(xs, (gx, gh)):
                assert _rel_err(leaf.grad[b].numpy(), np.asarray(ref)) <= GRAD_TOL
            for name, g in state_dict_from_flax(jax.tree.map(np.asarray, gp["params"])).items():
                j_params[name] = j_params.get(name, 0.0) + g.numpy()
    if grads:
        mine = dict(tcell.named_parameters())
        for name, _ in tcell.named_buffers():  # the LSTM's zero input-side bias
            j_params.pop(name)
        assert sorted(mine) == sorted(j_params)
        for name, ref in j_params.items():
            assert _rel_err(mine[name].grad.numpy(), ref) <= GRAD_TOL, name
    return params, outs


# ---------------------------------------------------------------- cells

# the per-gate ChebConv GRU and the fused MH GRU stay in the core tier
GRU_CASES = [pytest.param(c, f, id=f"{c}-{'fused' if f else 'per_gate'}",
                          marks=() if (c, f) in (("ChebConv", False), ("MHTransformerConv", True))
                          else pytest.mark.slow)
             for c in ("GCNConv", "ChebConv", "TransformerConv", "MHTransformerConv")
             for f in (True, False)] + [pytest.param("GATConv", False, id="GATConv-per_gate",
                                                     marks=pytest.mark.slow)]


@pytest.mark.parametrize("conv,fused", GRU_CASES)
def test_gru_cell_and_gradients_match_jax(conv, fused):
    """The GRU: fused ``gates_zr`` (2 gates) and ``gate_candidate`` (1, on
    h·r), or per-gate ``conv_x`` (3 gates), ``conv_h`` (2) and
    ``conv_h_candidate``; two conv layers. A per-gate tree stacked by
    ``fuse_cell_gates`` into the fused GRU gives the same outputs."""
    d, layers = 8, 2
    jcell = jcells.GConvGRU(out_channels=d, n_conv_layers=layers, convolution_type=conv,
                            fused=fused)
    tcell = tcells.GConvGRU(4, d, layers, conv, fused_gates=fused)
    assert hasattr(tcell, "gates_zr") == fused and hasattr(tcell, "conv_h_candidate") != fused
    params, outs = _check_cell(jcell, tcell, MESH_OF[conv], d=d)
    if fused or conv == "GATConv":
        return
    tg, _ = _mesh(MESH_OF[conv])
    stacked = tcells.GConvGRU(4, d, layers, conv).eval()
    stacked.load_state_dict(state_dict_from_flax(fuse_cell_gates(params["params"])))
    rng = np.random.default_rng(2)
    x, h, c = (torch.from_numpy(rng.standard_normal((B, tg.n_max, w)).astype(np.float32) * s)
               for w, s in ((4, 1.0), (d, 0.5), (d, 0.5)))
    with torch.no_grad():
        for mine, ref in zip(stacked(x, tg, h, c), outs):
            np.testing.assert_allclose(mine.numpy(), ref.detach().numpy(), rtol=0,
                                       atol=CELL_TOL)


@pytest.mark.parametrize("conv", ["ChebConv", "TransformerConv"])
def test_simple_lstm_cell_and_gradients_match_jax(conv):
    """The shared-conv LSTM: one ``conv_x`` and one ``conv_h`` (plain
    ``GraphConv`` stacks of two layers), the gates apart only by their
    biases."""
    jcell = jcells.GConvLSTMSimple(out_channels=8, n_conv_layers=2, convolution_type=conv)
    tcell = tcells.GConvLSTMSimple(4, 8, 2, conv)
    params, _ = _check_cell(jcell, tcell, MESH_OF[conv])
    assert set(params["params"]) == {"conv_x", "conv_h", "b_i", "b_f", "b_c", "b_o"}


@pytest.mark.parametrize("conv", ["ChebConv", "GCNConv"])
def test_split_lstm_cell_and_gradients_match_jax(conv):
    """A ``GraphConv`` then the LSTM along the node axis (every n_max row,
    from the carry in row 0): the flax ``OptimizedLSTMCell``'s kernels
    mapped onto ``torch.nn.LSTM`` (gates i, f, g, o), the final carry
    broadcast over the rows."""
    jcell = jcells.SplitGConvLSTM(out_channels=8, n_conv_layers=1, convolution_type=conv)
    tcell = tcells.SplitGConvLSTM(4, 8, 1, conv)
    params, outs = _check_cell(jcell, tcell, "blocks")
    assert sorted(params["params"]["lstm"]) == ["hf", "hg", "hi", "ho", "if", "ig", "ii", "io"]
    assert float(tcell.lstm.bias_ih_l0.abs().max()) == 0.0
    h = outs[1].detach()
    assert torch.equal(h, h[:, :1].expand_as(h))


def test_dummy_cell_is_the_identity():
    tg, _ = _mesh("blocks")
    x, h, c = (torch.randn(B, tg.n_max, w, generator=torch.Generator().manual_seed(w))
               for w in (4, 8, 8))
    out = tcells.DummyLSTM()(x, tg, h, c)
    assert all(a is b for a, b in zip(out, (x, h, c)))
    assert not list(tcells.DummyLSTM().parameters())


@pytest.mark.parametrize("fused", [True, pytest.param(False, marks=pytest.mark.slow)])
def test_gru_cell_bf16_on_blocks_matches_jax(fused):
    """A ChebConv GRU step in bf16 on the same bf16 Â (the JAX package's
    blocks in the port's graph) against the JAX package's bf16 step:
    within two bf16 roundings, 2 × 2⁻⁷ × max(1, max|ref|), or within the
    JAX package's own bf16-vs-f32 spread on these inputs where that is
    wider. XLA rounds a bf16 sigmoid after each op and torch rounds the
    f32 sigmoid once (``tests/test_torch_bf16.py``'s LSTM cell bound,
    1e-2, is about one rounding); the GRU's update z·h + (1 − z)·h̃
    rounds both products and their sum, and the per-gate layout's JAX
    side rounds every gate's conv taps apart, where the port sums them
    fused."""
    tg, jgs = _mesh("blocks", bf16=True)
    tg = tg.replace(agg_meta=tg.agg_meta._replace(blocks=torch.stack(
        [torch.tensor(np.asarray(jnp.asarray(jg.agg_meta.blocks, jnp.float32)))
         for jg in jgs]).to(BF16)))
    _, jgs_f32 = _mesh("blocks")
    n, d = tg.n_max, 8
    rng = np.random.default_rng(40)
    x, h, c = (rng.standard_normal((B, n, w)).astype(np.float32) * s
               for w, s in ((4, 1.0), (d, 0.5), (d, 0.5)))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    kw = dict(out_channels=d, n_conv_layers=2, convolution_type="ChebConv", fused=fused)
    jcell = jcells.GConvGRU(dtype=jnp.bfloat16, **kw)
    params = _nonzero(jax.tree.map(np.asarray, jcell.init(
        jax.random.PRNGKey(8), bf(x[0]), jgs[0], bf(h[0]), bf(c[0]))), 9)
    tcell = tcells.GConvGRU(4, d, 2, "ChebConv", dtype=BF16, fused_gates=fused)
    tcell.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        outs = tcell(torch.from_numpy(x).to(BF16), tg, torch.from_numpy(h).to(BF16),
                     torch.from_numpy(c).to(BF16))
    assert outs[0].dtype == BF16
    for b, jg in enumerate(jgs):
        ref = np.asarray(jnp.asarray(jcell.apply(params, bf(x[b]), jg, bf(h[b]), bf(c[b]))[0],
                                     jnp.float32))
        f32 = np.asarray(jcells.GConvGRU(**kw).apply(params, x[b], jgs_f32[b], h[b], c[b])[0])
        spread = np.abs(ref - f32).max()
        err = np.abs(outs[0][b].float().numpy() - ref).max()
        assert err <= max(2 * 2.0**-7 * max(1.0, float(np.abs(ref).max())), spread), \
            (err, spread)


# ---------------------------------------------------------------- Seq2Seq

SHAPE = (16, 16)
T_IN, T_OUT = 2, 2
BASE = dict(convolution_type="ChebConv", hidden_size=8, n_layers=2, n_conv_layers=1,
            dropout=0.0)
# windows wide enough for the full 16×16 mesh that random weights can predict
GRAPH = dict(max_grid_size=8, n_max=256, e_max=4096, node_budget=256, aggregation="pallas",
             agg_nt=128, agg_eb=1024, agg_sw=256)
MODELS = {
    "GRU": dict(rnn_type="GRU"),
    "GRU-per_gate": dict(rnn_type="GRU", fused_gates=False),
    "SimpleLSTM": dict(rnn_type="SimpleLSTM"),
    "SplitLSTM": dict(rnn_type="SplitLSTM"),
    "Dummy": dict(rnn_type="Dummy", n_layers=1),
    "dummy": dict(dummy=True),
    "MHTransformerConv": dict(convolution_type="MHTransformerConv"),
    "GATConv": dict(convolution_type="GATConv"),
    "GATv2Conv": dict(convolution_type="GATv2Conv"),
}


def _dataset():
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    return ModMovingMNISTDataset(B, T_IN, T_OUT, canvas_size=SHAPE, digit_size=(8, 8),
                                 pixel_noise=0.02, velocity_noise=0.0, seed=3)


def _jax_predictor(model, tf=0.0):
    return JPredictor(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                      teacher_forcing_ratio=tf,
                      model_kwargs=dict(BASE, remat=False, **MODELS[model]),
                      graph_kwargs=dict(GRAPH))


def _port(model, weights, tf=0.0, run_dir="runs"):
    tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", teacher_forcing_ratio=tf, run_dir=str(run_dir),
                               model_kwargs=dict(BASE, **MODELS[model]),
                               graph_kwargs=dict(GRAPH))
    tp.load_jax_params(weights)
    return tp


# the cheaper JAX compiles stay in the core tier
SLOW_MODELS = ("GRU", "GRU-per_gate", "MHTransformerConv", "GATConv")


@pytest.fixture(scope="module", params=[
    pytest.param(m, marks=pytest.mark.slow) if m in SLOW_MODELS else m for m in MODELS])
def jax_run(request):
    jp = _jax_predictor(request.param)
    jp._ensure_params()
    weights = _nonzero(jax.tree.map(np.asarray, jp.params), 5)
    ds = _dataset()
    forecast = jax.jit(jax.vmap(lambda xb: jp.eval_model.apply(weights, xb)))
    mesh = jax.jit(lambda frames: j_image_to_graph(j_posenc(frames), jp.gcfg)[0].pixel_node)
    return request.param, jp, weights, ds, np.asarray(forecast(jnp.asarray(ds.x))), mesh


def test_rollout_matches_jax_until_a_mesh_flips(jax_run):
    """``forecast`` with the JAX weights: frame t within 1e-4 per pixel
    while the mesh it was decoded on is the one the JAX package's previous
    frame gives; the encoder's meshes must agree."""
    name, jp, weights, ds, jy, mesh = jax_run
    tp = _port(name, weights)
    assert tp.gcfg.aggregation == jp.gcfg.aggregation == "pallas"
    assert (tp.gcfg.attn_windows, tp.gcfg.carry_edges) == (jp.gcfg.attn_windows,
                                                           jp.gcfg.carry_edges)
    with torch.no_grad():
        y, overflow, meshes = tp.forecast(ds.x)
    assert int(overflow.max()) == 0 and torch.isfinite(y).all()
    compared = 0
    for b in range(B):
        want = [mesh(jnp.asarray(ds.x[b]))] + [mesh(jnp.asarray(jy[b, t][None]))
                                               for t in range(T_OUT - 1)]
        for t in range(T_OUT):
            same = np.array_equal(meshes[t, b].numpy(), np.asarray(want[t]))
            assert same or t > 0, f"sample {b}: the encoder's mesh differs"
            if not same:
                break
            np.testing.assert_allclose(y[b, t].numpy(), jy[b, t], rtol=0, atol=ROLLOUT_TOL,
                                       err_msg=name)
            compared += 1
    assert compared >= B + 1


def test_params_round_trip(jax_run):
    """The JAX package's tree maps onto the port's state_dict (the same
    names as the port's model), and ``params_to_jax`` gives it back leaf
    for leaf, exactly (an LSTM's flax kernels and biases included)."""
    name, jp, weights, _, _, _ = jax_run
    sd = params_from_jax(weights)
    tp = _port(name, weights)
    assert sorted(tp.model.state_dict()) == sorted(sd)
    back = params_to_jax(sd)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure({"params": weights["params"]})
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(weights)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_init_follows_the_jax_fans(jax_run):
    """The port's seeded init of each model has the JAX package's tree
    (names and shapes) and its rules: glorot-uniform on the last two axes
    of every kernel, gate-stack weight and GAT ``att`` vector; an LSTM's
    input kernels lecun-normal (truncated at two standard deviations) and
    its recurrent kernels orthogonal, per gate; zero biases and
    peepholes, LayerNorm scale 1."""
    name, _, weights, _, _, _ = jax_run
    tp = _port(name, weights)
    init_params(tp.model, torch.Generator().manual_seed(0))
    mine = params_to_jax(tp.model.state_dict())
    assert jax.tree.map(np.shape, mine) == jax.tree.map(np.shape, {"params": weights["params"]})
    for path, v in jax.tree_util.tree_leaves_with_path(mine["params"]):
        keys = [str(p.key) for p in path]
        fan_in, fan_out = (v.shape[-2], v.shape[-1]) if v.ndim >= 2 else (0, 0)
        if "lstm" in keys and keys[-1] == "kernel":
            if keys[-2].startswith("i"):  # lecun-normal
                std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
                assert np.abs(v).max() <= 2 * std + 1e-6, keys
            else:  # orthogonal
                np.testing.assert_allclose(v.T @ v, np.eye(fan_out), atol=1e-5)
        elif (keys[-1] == "kernel" or keys[-1].startswith("att")
              or (keys[-2] in ("gates", "gates_zr", "gate_candidate")
                  and keys[-1].startswith("w_"))):
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            # a few draws may all be small: fc_out2's att vectors hold one
            assert np.abs(v).max() <= limit, keys
            assert v.size < 16 or np.abs(v).max() > 0.5 * limit, keys
        elif keys[-1] == "scale":
            assert (v == 1).all(), keys
        else:
            assert not v.any(), keys


def _jax_loss_and_grad(model, weights, x, y):
    jmodel = _jax_predictor(model, tf=1.0).model
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}

    def sample_loss(params, xb, yb):
        state = jmodel.apply(params, xb, method=JSeq2Seq.encode, rngs=rngs)
        _, y_hat = jmodel.apply(params, state, 0, T_OUT, yb, method=JSeq2Seq.decode, rngs=rngs)
        return J_LOSSES["MSE"](y_hat, yb, None)

    def batch_loss(params):
        return jnp.mean(jax.vmap(lambda xb, yb: sample_loss(params, xb, yb))(x, y))

    params = jax.tree.map(jnp.asarray, weights)
    loss, grads = jax.jit(jax.value_and_grad(batch_loss))(params)
    clip = optax.clip_by_global_norm(10.0)
    grads, _ = clip.update(grads, clip.init(params))
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("model", [pytest.param(m, marks=pytest.mark.slow)
                                   for m in ("GRU", "MHTransformerConv", "GATConv")]
                         + ["SplitLSTM"])
def test_train_step_loss_and_grads_match_jax(model, tmp_path):
    """One full-BPTT train step (teacher forcing 1.0: every decoder mesh
    from the true frame, so both run on the same meshes; dropout 0): the
    loss within 1e-4 relative and every gradient leaf, clipped at the
    global norm 10, within 1e-4 × max(1, max|g|) of ``jax.value_and_grad``
    of the JAX loss."""
    jp = _jax_predictor(model)
    jp._ensure_params()
    weights = _nonzero(jax.tree.map(np.asarray, jp.params), 5)
    ds = _dataset()
    j_loss, j_grads = _jax_loss_and_grad(model, weights, jnp.asarray(ds.x), jnp.asarray(ds.y))
    tp = _port(model, weights, tf=1.0, run_dir=tmp_path)
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    loss, overflow = tp.train_step(ds.x, ds.y)
    assert int(overflow) == 0
    assert abs(float(loss) - j_loss) <= 1e-4 * abs(j_loss)
    grads = {name: p.grad for name, p in tp.model.named_parameters()}
    assert set(grads) == set(j_grads) - {name for name, _ in tp.model.named_buffers()}
    for name, g in grads.items():
        assert _rel_err(g.numpy(), j_grads[name].numpy()) <= GRAD_TOL, name
