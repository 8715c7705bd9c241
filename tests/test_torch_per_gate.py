"""PyTorch port vs JAX package: the per-gate gate layout
(``fused_gates=False``).

The JAX package's per-gate GConvLSTM vmaps one ``GraphConv`` stack per
side over the four gates (``conv_x``/``conv_h``, every leaf with a leading
gate axis). The port keeps those parameters leaf for leaf and runs them
through its fused stacks' arithmetic (``models/fused.py``
``fused_from_per_gate``). Here, on the same meshes and carried-over
weights, with dropout off: the cell's outputs (≤1e-5) and gradients
(≤1e-4 × max(1, max|g|)) for ChebConv on Â blocks, the grid and a quadtree
edge list, and TransformerConv on attention windows, the grid and the
pixelwise edge list; rollouts (≤1e-4 per pixel, until a quadtree mesh
flips); ``params_from_jax``/``params_to_jax`` leaf for leaf and a saved
port checkpoint back into the JAX model; the per-gate glorot fans; and
the port's per-gate model against its fused model on weights stacked by
``fuse_attn_gates``, bit for bit, dropout on.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import NEG_INF
from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models import conv as jconv
from quadtree_mpnnlstm_tpu.models.cells import GConvLSTM as JGConvLSTM
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig as TGraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph as t_image_to_graph
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.models.cells import GConvLSTM as TGConvLSTM
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from quadtree_mpnnlstm_tpu_torch.utils.weights import (
    fuse_attn_gates,
    init_params,
    params_from_jax,
    params_to_jax,
    state_dict_from_flax,
)
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

B = 2
CELL_TOL, GRAD_TOL, ROLLOUT_TOL = 1e-5, 1e-4, 1e-4
QUAD = dict(image_shape=(32, 32), max_grid_size=8, thresh=0.2, n_max=512, e_max=4096,
            agg_nt=128, agg_eb=1024, agg_sw=512)
PIXEL_SHAPE = (12, 20)
PIXEL = dict(image_shape=PIXEL_SHAPE, thresh=NEG_INF)
# (convolution, mesh): graph config, JAX-only fields
MESHES = {
    ("ChebConv", "blocks"): (dict(QUAD, aggregation="pallas", use_edge_attrs=False), {}),
    ("ChebConv", "grid"): (dict(PIXEL, aggregation="grid", use_edge_attrs=False), {}),
    ("ChebConv", "edge_list"): (dict(QUAD, aggregation="xla", use_edge_attrs=False), {}),
    ("TransformerConv", "windows"): (dict(QUAD, aggregation="pallas", attn_windows=True), {}),
    # the JAX package's grid attention kernel needs grid_attn="pallas"
    ("TransformerConv", "grid"): (dict(PIXEL, aggregation="grid"), dict(grid_attn="pallas")),
    ("TransformerConv", "edge_list"): (dict(PIXEL, aggregation="xla"), {}),
}


@pytest.fixture(autouse=True)
def no_attention_dropout(monkeypatch):
    """Attention dropout off in both registries: the two frameworks draw
    other random numbers."""
    for registry in (jconv.CONVOLUTION_KWARGS, tconv.CONVOLUTION_KWARGS):
        monkeypatch.setitem(registry, "TransformerConv",
                            dict(registry["TransformerConv"], dropout=0.0))


def _frames(shape, seed):
    """A blob plus faint noise per sample: quadtree meshes refined near the
    blob, within n_max."""
    rng = np.random.default_rng(seed)
    r, c = np.arange(shape[0])[:, None], np.arange(shape[1])[None, :]
    frames = []
    for _ in range(B):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        blob = np.exp(-((r - cy) ** 2 + (c - cx) ** 2) / (2 * (shape[0] / 5) ** 2))
        frames.append(blob + 0.02 * rng.random(shape))
    return np.stack(frames)[:, None, :, :, None].astype(np.float32)


def _mask(shape):
    mask = np.random.default_rng(0).random(shape) < 0.15
    mask[:2] = True
    return mask


def _graphs(conv, mesh):
    """(port graph of the batch, the JAX graph of each sample, node count)."""
    tkw, jkw = MESHES[(conv, mesh)]
    shape = tkw["image_shape"]
    x = _frames(shape, 0)
    mask = _mask(shape) if tkw["thresh"] == NEG_INF else None
    tg, _ = t_image_to_graph(t_posenc(torch.from_numpy(x)), TGraphConfig(**tkw),
                             mask=None if mask is None else torch.from_numpy(mask))
    jgs = [j_image_to_graph(j_posenc(jnp.asarray(x[b])), JGraphConfig(**tkw, **jkw),
                            mask=None if mask is None else jnp.asarray(mask))[0]
           for b in range(B)]
    assert int(tg.overflow.max()) == 0
    return tg, jgs, tg.n_max


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


@pytest.mark.parametrize("conv,mesh", list(MESHES), ids=[f"{c}-{m}" for c, m in MESHES])
def test_per_gate_cell_and_gradients_match_jax(conv, mesh):
    """(O, H, C) of one per-gate cell within 1e-5, and the gradients of a
    weighted sum of them with respect to every per-gate leaf and to x, h
    and c within 1e-4 × max(1, max|g|)."""
    tg, jgs, n = _graphs(conv, mesh)
    fx, d, layers = 4, 8, 2
    rng = np.random.default_rng(2)
    x, h, c = (rng.standard_normal((B, n, w)).astype(np.float32) * s
               for w, s in ((fx, 1.0), (d, 0.5), (d, 0.5)))
    wo, wh, wc = (rng.standard_normal((B, n, d)).astype(np.float32) for _ in range(3))
    jcell = JGConvLSTM(out_channels=d, n_conv_layers=layers, convolution_type=conv, fused=False)
    params = _nonzero(jax.tree.map(np.asarray, jcell.init(
        jax.random.PRNGKey(3), jnp.asarray(x[0]), jgs[0], jnp.asarray(h[0]),
        jnp.asarray(c[0]))), 4)
    assert "conv_x" in params["params"] and "gates" not in params["params"]
    tcell = TGConvLSTM(fx, d, layers, conv, fused_gates=False).eval()
    tcell.load_state_dict(state_dict_from_flax(params["params"]))
    assert not hasattr(tcell, "gates")

    xs = [torch.from_numpy(a).requires_grad_(True) for a in (x, h, c)]
    outs = tcell(xs[0], tg, xs[1], xs[2])
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, (wo, wh, wc)))
    loss.backward()

    def j_loss(p, xb, hb, cb, jg, wb):
        o, hn, cn = jcell.apply(p, xb, jg, hb, cb)
        return (o * wb[0]).sum() + (hn * wb[1]).sum() + (cn * wb[2]).sum(), (o, hn, cn)

    grad = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True))
    j_params = {}
    for b, jg in enumerate(jgs):
        (_, refs), (gp, gx, gh, gc) = grad(params, x[b], h[b], c[b], jg,
                                           (wo[b], wh[b], wc[b]))
        for mine, ref in zip(outs, refs):
            np.testing.assert_allclose(mine[b].detach().numpy(), np.asarray(ref), rtol=0,
                                       atol=CELL_TOL)
        for leaf, ref in zip(xs, (gx, gh, gc)):
            assert _rel_err(leaf.grad[b].numpy(), np.asarray(ref)) <= GRAD_TOL
        for name, g in state_dict_from_flax(jax.tree.map(np.asarray, gp["params"])).items():
            j_params[name] = j_params.get(name, 0.0) + g.numpy()
    mine = dict(tcell.named_parameters())
    assert sorted(mine) == sorted(j_params)
    for name, ref in j_params.items():
        assert _rel_err(mine[name].grad.numpy(), ref) <= GRAD_TOL, name


# ------------------------------------------------------------ Seq2Seq

T_IN, T_OUT = 2, 3
MODELS = {
    "ChebConv-blocks": (dict(convolution_type="ChebConv", hidden_size=8, n_layers=2,
                             n_conv_layers=2, dropout=0.0),
                        (16, 16), 0.1,
                        dict(max_grid_size=8, n_max=256, e_max=2048, node_budget=256,
                             aggregation="pallas", agg_nt=128, agg_eb=512, agg_sw=256)),
    "TransformerConv-grid": (dict(convolution_type="TransformerConv", hidden_size=8,
                                  n_layers=1, n_conv_layers=3, dropout=0.0),
                             PIXEL_SHAPE, NEG_INF, dict(aggregation="grid")),
}


@pytest.fixture(scope="module", params=list(MODELS))
def seq2seq(request, tmp_path_factory):
    """A JAX per-gate predictor, its weights with non-zero biases, the
    port's per-gate predictor holding them, and seeded inputs."""
    model, shape, thresh, graph = MODELS[request.param]
    pixelwise = thresh == NEG_INF
    kw = dict(input_timesteps=T_IN, output_timesteps=T_OUT, decompose=not pixelwise,
              use_climatology=pixelwise)
    jp = JPredictor(shape, thresh, model_kwargs=dict(model, fused_gates=False, remat=False),
                    graph_kwargs=dict(graph, **({"grid_attn": "pallas"} if pixelwise else {})),
                    **kw)
    jp._ensure_params()
    weights = _nonzero(jax.tree.map(np.asarray, jp.params), 5)
    tp = NextFramePredictorS2S(shape, thresh, device="cpu", graph_kwargs=dict(graph),
                               model_kwargs=dict(model, fused_gates=False),
                               run_dir=str(tmp_path_factory.mktemp("runs")), **kw)
    tp.load_jax_params(weights)
    rng = np.random.default_rng(6)
    x = (rng.random((B, T_IN, *shape, 1)) ** 2).astype(np.float32)
    clim = rng.random((B, T_OUT, *shape, 1)).astype(np.float32)
    mask = _mask(shape) if pixelwise else None
    return request.param, jp, weights, tp, x, clim, mask


_APPLY = {}


def _jax_rollout(jp, weights, x, clim, mask):
    if id(jp) not in _APPLY:  # one compile per model, the weights an argument
        m = None if mask is None else jnp.asarray(mask)
        _APPLY[id(jp)] = jax.jit(lambda w, xb, cb: jp.eval_model.apply(
            w, xb, None, cb if jp.use_climatology else None, m))
    apply = _APPLY[id(jp)]
    return np.stack([np.asarray(apply(weights, jnp.asarray(x[b]), jnp.asarray(clim[b])))
                     for b in range(B)])


def test_per_gate_rollout_matches_jax(seq2seq):
    """The forecast of the per-gate model, ≤1e-4 per pixel until the first
    decoder step whose quadtree mesh differs from the one the JAX
    package's prediction gives (none on the fixed grid)."""
    name, jp, weights, tp, x, clim, mask = seq2seq
    ref = _jax_rollout(jp, weights, x, clim, mask)
    with torch.no_grad():
        y_hat, _, meshes = tp.model.rollout(
            torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask),
            climatology=torch.from_numpy(clim) if tp.use_climatology else None)
    y_hat, meshes = y_hat.numpy(), meshes.numpy()
    mesh_of = jax.jit(lambda f: j_image_to_graph(j_posenc(f), jp.gcfg)[0].pixel_node)
    for b in range(B):
        steps = T_OUT
        if tp.model.remeshing:
            frames = [x[b]] + [ref[b, t:t + 1] for t in range(T_OUT - 1)]
            same = [np.array_equal(meshes[t, b], np.asarray(mesh_of(jnp.asarray(f))))
                    for t, f in enumerate(frames)]
            assert same[0], "the encoder's meshes differ"
            steps = same.index(False) if False in same else T_OUT
        np.testing.assert_allclose(y_hat[b, :steps], ref[b, :steps], rtol=0, atol=ROLLOUT_TOL,
                                   err_msg=name)


def test_per_gate_params_map_leaf_for_leaf_and_round_trip(seq2seq, tmp_path):
    """``params_from_jax`` copies the per-gate tree leaf for leaf (the
    same names and count, kernels transposed), ``params_to_jax`` gives the
    tree back exactly, and a checkpoint saved by the port loads into the
    JAX per-gate model and forecasts what the original weights forecast."""
    name, jp, weights, tp, x, clim, mask = seq2seq
    sd = params_from_jax(weights)
    leaves = jax.tree_util.tree_leaves_with_path(weights["params"])
    assert len(sd) == len(leaves) == len(tp.model.state_dict())
    assert sorted(sd) == sorted(tp.model.state_dict())
    assert any(".conv_x.conv_0." in k for k in sd) and not any(".gates." in k for k in sd)
    back = params_to_jax(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(weights)
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree_util.tree_leaves_with_path(weights)):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))
    saved = torch.load(tp.save(str(tmp_path)), weights_only=True)
    loaded = params_to_jax(saved)
    np.testing.assert_array_equal(_jax_rollout(jp, loaded, x, clim, mask),
                                  _jax_rollout(jp, weights, x, clim, mask), err_msg=name)


def test_per_gate_init_draws_glorot_per_gate_slice():
    """``init_params`` draws every per-gate Dense kernel from glorot-uniform
    with the fans of one gate's (in, out), as the flax vmap initialises
    each gate, and the gates draw apart."""
    tp = NextFramePredictorS2S((16, 16), 0.1, device="cpu", input_timesteps=2,
                               output_timesteps=1,
                               model_kwargs=dict(MODELS["ChebConv-blocks"][0],
                                                 fused_gates=False),
                               graph_kwargs=dict(MODELS["ChebConv-blocks"][3]))
    init_params(tp.model, torch.Generator().manual_seed(0))
    seen = 0
    for name, p in tp.model.named_parameters():
        p = p.detach()
        if ".conv_" in name and name.endswith(".weight"):
            g, fout, fin = p.shape
            limit = (6.0 / (fin + fout)) ** 0.5
            assert g == 4 and float(p.abs().max()) <= limit, name
            assert float(p.abs().max()) > 0.5 * limit, name
            assert not torch.equal(p[0], p[1]), name
            seen += 1
        elif ".conv_" in name:
            assert not p.any(), name  # per-gate biases start at zero
    # taps × sides × conv layers × cells: the encoder's 3 × 2 × 2 × 2, the decoder's 3 × 2 × 1 × 2
    assert seen == 24 + 12


@pytest.mark.parametrize("aggregation", ["grid", "xla"])
def test_per_gate_step_equals_the_fused_step_on_stacked_weights(aggregation, tmp_path):
    """The port's per-gate TransformerConv model and its fused model with
    the same weights stacked by ``fuse_attn_gates`` take bit-identical
    train steps, attention and head dropout on: the per-gate leaves run
    the fused arithmetic, and every gate and side draws its own dropout
    plane in the same call."""
    kw = dict(input_timesteps=T_IN, output_timesteps=T_OUT, decompose=False, device="cpu",
              use_climatology=True, run_dir=str(tmp_path), seed=4,
              graph_kwargs=dict(aggregation=aggregation))
    model = dict(MODELS["TransformerConv-grid"][0], dropout=0.1)
    rng = np.random.default_rng(7)
    x = rng.random((B, T_IN, *PIXEL_SHAPE, 1)).astype(np.float32)
    y = rng.random((B, T_OUT, *PIXEL_SHAPE, 1)).astype(np.float32)
    clim = rng.random((B, T_OUT, *PIXEL_SHAPE, 1)).astype(np.float32)
    mask = _mask(PIXEL_SHAPE)
    grads = []
    with pytest.MonkeyPatch.context() as mp:  # attention dropout back on
        mp.setitem(tconv.CONVOLUTION_KWARGS, "TransformerConv",
                   dict(tconv.CONVOLUTION_KWARGS["TransformerConv"], dropout=0.1))
        per_gate = NextFramePredictorS2S(PIXEL_SHAPE, NEG_INF, model_kwargs=dict(
            model, fused_gates=False), **kw)
        fused = NextFramePredictorS2S(PIXEL_SHAPE, NEG_INF, model_kwargs=model, **kw)
    tree = params_to_jax(per_gate.model.state_dict())
    fused.model.load_state_dict(params_from_jax(tree, fuse_gates=True))
    for tp in (per_gate, fused):
        tp.initiate_training(0.0, 0.95)
        loss, _ = tp.train_step(x, y, mask=mask, climatology=clim,
                                generator=torch.Generator().manual_seed(1))
        grads.append((loss, {n: p.grad for n, p in tp.model.named_parameters()}))
    (loss_p, g_p), (loss_f, g_f) = grads
    assert torch.equal(loss_p, loss_f)
    stacked = params_from_jax(params_to_jax(g_p), fuse_gates=True)
    assert sorted(stacked) == sorted(g_f)
    for name, g in g_f.items():
        assert torch.equal(stacked[name], g), name


def test_fuse_attn_gates_names_what_it_converts():
    """A per-gate ChebConv cell is not stacked by ``fuse_attn_gates``; the
    error says where it loads instead."""
    cell = {"conv_x": {"conv_0": {"lin_0": {"kernel": np.zeros((4, 2, 3))}}},
            "conv_h": {"conv_0": {"lin_0": {"kernel": np.zeros((4, 3, 3))}}}}
    with pytest.raises(ValueError, match="fused_gates=False"):
        fuse_attn_gates(cell)
