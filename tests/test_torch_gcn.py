"""PyTorch port vs JAX package: GCNConv, the JAX package's default conv
(``ModelConfig.convolution_type``), on the same meshes, inputs and
carried-over weights.

GCN is ``Â (x W) + b`` with no self-loops and the symmetric degree norm
(the distance column as edge weight). Its Â·z is the same dispatch as
ChebConv's: the Â blocks (Pallas interpret mode on the JAX side, the plain
block product here), the edge list and the grid's stencil.

* ``GCNConv`` on Â blocks, a quadtree edge list and a masked grid, ≤1e-5;
* the fused GCN gate stack (weights first, one Â·z over all 2·G streams)
  and the per-gate cell loaded leaf for leaf, against the JAX
  ``FusedGateConvStack`` and the vmapped ``GraphConv`` cell, ≤1e-5, the
  per-gate cell's gradients ≤1e-4 × max(1, max|g|); a per-gate tree
  stacked by ``fuse_gcn_gates`` (the JAX package's ``tests/test_fused.py``
  transplant) into the port's fused cell gives the JAX per-gate cell's
  outputs;
* a Seq2Seq rollout, fused and per-gate, ≤1e-4 per pixel until the first
  quadtree mesh that differs from the one the JAX prediction gives;
* one train step's loss and gradients against ``jax.value_and_grad``,
  ≤1e-4 × max(1, max|g|), teacher forcing 1.0 so both run on the same
  meshes;
* bf16 GCN on the JAX package's bf16 Â blocks at
  ``tests/test_torch_bf16.py``'s tolerances;
* ``params_from_jax``/``params_to_jax`` round trips of the fused and the
  per-gate GCN trees, and the port's init in the JAX package's layout
  with its glorot fans.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import NEG_INF
from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models.cells import GConvLSTM as JGConvLSTM
from quadtree_mpnnlstm_tpu.models.conv import GCNConv as JGCNConv
from quadtree_mpnnlstm_tpu.models.fused import FusedGateConvStack as JFused
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig as TGraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph as t_image_to_graph
from quadtree_mpnnlstm_tpu_torch.models.cells import GConvLSTM as TGConvLSTM
from quadtree_mpnnlstm_tpu_torch.models.conv import GCNConv as TGCNConv
from quadtree_mpnnlstm_tpu_torch.models.fused import FusedGateConvStack as TFused
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from quadtree_mpnnlstm_tpu_torch.utils.weights import (
    fuse_gcn_gates,
    init_params,
    params_from_jax,
    params_to_jax,
    state_dict_from_flax,
)
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

B = 2
CONV_TOL, GRAD_TOL, ROLLOUT_TOL = 1e-5, 1e-4, 1e-4
BF16 = torch.bfloat16
ULP = 2.0**-7  # one bf16 rounding, relative
QUAD = dict(image_shape=(32, 32), max_grid_size=8, thresh=0.2, use_edge_attrs=False,
            n_max=512, e_max=4096, agg_nt=128, agg_eb=1024, agg_sw=512)
GRID_SHAPE = (24, 32)
MESHES = {
    "blocks": dict(QUAD, aggregation="pallas"),
    "edge_list": dict(QUAD, aggregation="xla"),
    "grid": dict(image_shape=GRID_SHAPE, thresh=NEG_INF, aggregation="grid",
                 use_edge_attrs=False),
}


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


def _graphs(mesh, bf16=False):
    """(port graph of the batch, the JAX graph of each sample)."""
    kw = MESHES[mesh]
    shape = kw["image_shape"]
    x = _frames(shape, 0)
    mask = _mask(shape) if kw["thresh"] == NEG_INF else None
    tx = torch.from_numpy(x).to(BF16 if bf16 else torch.float32)
    tg, _ = t_image_to_graph(t_posenc(tx), TGraphConfig(**kw),
                             mask=None if mask is None else torch.from_numpy(mask))
    jgs = [j_image_to_graph(j_posenc(jnp.asarray(x[b], jnp.bfloat16 if bf16 else jnp.float32)),
                            JGraphConfig(**kw),
                            mask=None if mask is None else jnp.asarray(mask))[0]
           for b in range(B)]
    assert int(tg.overflow.max()) == 0 and int(tg.n_nodes.min()) > 20
    return tg, jgs


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    return (request.param,) + _graphs(request.param)


def _feats(n, seed, width, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((B, n, width))).astype(np.float32)


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


def _init(module, seed, *args):
    return _nonzero(jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed), *args)),
                    seed + 1)


def _rel_err(a, b):
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("fin,fout", [(17, 16), (16, 1), (4, 128)])
def test_gcnconv_matches_jax(meshes, fin, fout):
    """The head convs' shapes (hidden + concat → hidden, hidden → 1) and a
    wide one: Â·(x W) + b within 1e-5 on every mesh."""
    mesh, tg, jgs = meshes
    x = _feats(tg.n_max, fin, fin)
    jmod = JGCNConv(out_channels=fout)
    params = _init(jmod, 1, jnp.asarray(x[0]), jgs[0])
    assert sorted(params["params"]) == ["bias", "lin"]
    tmod = TGCNConv(fin, fout)
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), tg).numpy()
    for b, jg in enumerate(jgs):
        ref = np.asarray(jmod.apply(params, jnp.asarray(x[b]), jg))
        np.testing.assert_allclose(out[b], ref, rtol=0, atol=CONV_TOL, err_msg=mesh)


@pytest.mark.parametrize("fx,fh,d,layers", [(4, 8, 8, 2), (8, 16, 16, 1), (4, 16, 16, 3)])
def test_fused_gcn_gate_stack_matches_jax(meshes, fx, fh, d, layers):
    """The fused stack (w_x_0 (g, fx, d), w_l (2g, d, d)): each stream's
    weights first, one Â·z over all 2·G streams a layer, within 1e-5."""
    mesh, tg, jgs = meshes
    n = tg.n_max
    x, h = _feats(n, 1, fx), _feats(n, 2, fh, 0.5)
    jmod = JFused("GCNConv", d, n_layers=layers)
    params = _init(jmod, 3, jnp.asarray(x[0]), jnp.asarray(h[0]), jgs[0])
    tmod = TFused(fx, fh, d, n_layers=layers, convolution_type="GCNConv")
    assert {k: tuple(v.shape) for k, v in tmod.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in state_dict_from_flax(params["params"]).items()}
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), torch.from_numpy(h), tg).numpy()  # (g, B, N, d)
    for b, jg in enumerate(jgs):
        ref = np.asarray(jmod.apply(params, jnp.asarray(x[b]), jnp.asarray(h[b]), jg))
        np.testing.assert_allclose(out[:, b], ref, rtol=0, atol=CONV_TOL, err_msg=mesh)


def test_fused_gcn_cell_matches_jax(meshes):
    """The fused GConvLSTM (the JAX package's default cell) within 1e-5."""
    mesh, tg, jgs = meshes
    n, fx, d = tg.n_max, 4, 8
    x, h, c = _feats(n, 4, fx), _feats(n, 5, d, 0.5), _feats(n, 6, d, 0.5)
    jcell = JGConvLSTM(out_channels=d, n_conv_layers=2, convolution_type="GCNConv")
    params = _init(jcell, 7, jnp.asarray(x[0]), jgs[0], jnp.asarray(h[0]), jnp.asarray(c[0]))
    tcell = TGConvLSTM(fx, d, n_conv_layers=2, convolution_type="GCNConv")
    tcell.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        outs = tcell(torch.from_numpy(x), tg, torch.from_numpy(h),
                     torch.from_numpy(c))
    for b, jg in enumerate(jgs):
        refs = jcell.apply(params, jnp.asarray(x[b]), jg, jnp.asarray(h[b]), jnp.asarray(c[b]))
        for out, ref in zip(outs, refs):
            np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), rtol=0,
                                       atol=CONV_TOL, err_msg=mesh)


def test_per_gate_gcn_cell_and_gradients_match_jax(meshes):
    """The per-gate cell (the JAX package's vmapped ``GraphConv`` of
    GCNConv: ``conv_x/conv_l/lin`` (4, in, d), ``bias`` (4, d)) loaded leaf
    for leaf: (O, H, C) within 1e-5, the gradients of a weighted sum of
    them with respect to every leaf and to x, h and c within 1e-4 ×
    max(1, max|g|). The same tree stacked by ``fuse_gcn_gates`` into the
    port's fused cell gives the same outputs within 1e-5 (the JAX
    package's ``tests/test_fused.py`` transplant)."""
    mesh, tg, jgs = meshes
    n, fx, d, layers = tg.n_max, 4, 8, 2
    rng = np.random.default_rng(2)
    x, h, c = (rng.standard_normal((B, n, w)).astype(np.float32) * s
               for w, s in ((fx, 1.0), (d, 0.5), (d, 0.5)))
    wo, wh, wc = (rng.standard_normal((B, n, d)).astype(np.float32) for _ in range(3))
    jcell = JGConvLSTM(out_channels=d, n_conv_layers=layers, convolution_type="GCNConv",
                       fused=False)
    params = _init(jcell, 3, jnp.asarray(x[0]), jgs[0], jnp.asarray(h[0]), jnp.asarray(c[0]))
    assert sorted(params["params"]["conv_x"]["conv_0"]) == ["bias", "lin"]
    tcell = TGConvLSTM(fx, d, layers, "GCNConv", fused_gates=False)
    tcell.load_state_dict(state_dict_from_flax(params["params"]))
    fused = TGConvLSTM(fx, d, layers, "GCNConv")
    fused.load_state_dict(state_dict_from_flax(fuse_gcn_gates(params["params"])))

    xs = [torch.from_numpy(a).requires_grad_(True) for a in (x, h, c)]
    outs = tcell(xs[0], tg, xs[1], xs[2])
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, (wo, wh, wc)))
    loss.backward()
    with torch.no_grad():
        outs_fused = fused(torch.from_numpy(x), tg, torch.from_numpy(h),
                           torch.from_numpy(c))

    def j_loss(p, xb, hb, cb, jg, wb):
        o, hn, cn = jcell.apply(p, xb, jg, hb, cb)
        return (o * wb[0]).sum() + (hn * wb[1]).sum() + (cn * wb[2]).sum(), (o, hn, cn)

    grad = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True))
    j_params = {}
    for b, jg in enumerate(jgs):
        (_, refs), (gp, gx, gh, gc) = grad(params, x[b], h[b], c[b], jg,
                                           (wo[b], wh[b], wc[b]))
        for mine, other, ref in zip(outs, outs_fused, refs):
            np.testing.assert_allclose(mine[b].detach().numpy(), np.asarray(ref), rtol=0,
                                       atol=CONV_TOL, err_msg=mesh)
            np.testing.assert_allclose(other[b].numpy(), np.asarray(ref), rtol=0,
                                       atol=CONV_TOL, err_msg=mesh)
        for leaf, ref in zip(xs, (gx, gh, gc)):
            assert _rel_err(leaf.grad[b].numpy(), np.asarray(ref)) <= GRAD_TOL, mesh
        for name, g in state_dict_from_flax(jax.tree.map(np.asarray, gp["params"])).items():
            j_params[name] = j_params.get(name, 0.0) + g.numpy()
    mine = dict(tcell.named_parameters())
    assert sorted(mine) == sorted(j_params)
    for name, ref in j_params.items():
        assert _rel_err(mine[name].grad.numpy(), ref) <= GRAD_TOL, (mesh, name)


# ---------------------------------------------------------------- Seq2Seq

SHAPE = (16, 16)
T_IN, T_OUT = 2, 3
MODEL = dict(convolution_type="GCNConv", hidden_size=8, n_layers=2, n_conv_layers=2,
             dropout=0.0)
GRAPH = dict(max_grid_size=8, n_max=256, e_max=2048, node_budget=256, aggregation="pallas",
             agg_nt=128, agg_eb=512, agg_sw=256)


def _dataset():
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    return ModMovingMNISTDataset(B, T_IN, T_OUT, canvas_size=SHAPE, digit_size=(8, 8),
                                 pixel_noise=0.02, velocity_noise=0.0, seed=3)


def _jax_predictor(fused=True, tf=0.0):
    return JPredictor(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                      teacher_forcing_ratio=tf,
                      model_kwargs=dict(MODEL, fused_gates=fused, remat=False),
                      graph_kwargs=dict(GRAPH))


def _port(weights, fused=True, tf=0.0, run_dir="runs"):
    tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", teacher_forcing_ratio=tf, run_dir=str(run_dir),
                               model_kwargs=dict(MODEL, fused_gates=fused),
                               graph_kwargs=dict(GRAPH))
    tp.load_jax_params(weights)
    return tp


@pytest.fixture(scope="module", params=["fused", "per_gate"])
def jax_run(request):
    fused = request.param == "fused"
    jp = _jax_predictor(fused)
    jp._ensure_params()
    weights = _nonzero(jax.tree.map(np.asarray, jp.params), 5)
    ds = _dataset()
    forecast = jax.jit(jax.vmap(lambda xb: jp.eval_model.apply(weights, xb)))
    mesh = jax.jit(lambda frames: j_image_to_graph(j_posenc(frames), jp.gcfg)[0].pixel_node)
    return fused, jp, weights, ds, np.asarray(forecast(jnp.asarray(ds.x))), mesh


def test_gcn_rollout_matches_jax_until_a_mesh_flips(jax_run):
    """``forecast`` with the JAX weights (GCN gate stacks, GCN head convs,
    the Â blocks): frame t within 1e-4 per pixel while the mesh it was
    decoded on is the one the JAX package's previous frame gives; the
    encoder's meshes must agree."""
    fused, jp, weights, ds, jy, mesh = jax_run
    tp = _port(weights, fused)
    assert tp.gcfg.aggregation == "pallas" and not tp.gcfg.carry_edges
    assert tp.cfg.convolution_type == "GCNConv" and tp.cfg.fused_gates == fused
    with torch.no_grad():
        y, overflow, meshes = tp.forecast(ds.x)
    assert int(overflow.max()) == 0
    compared = 0
    for b in range(B):
        want = [mesh(jnp.asarray(ds.x[b]))] + [mesh(jnp.asarray(jy[b, t][None]))
                                               for t in range(T_OUT - 1)]
        for t in range(T_OUT):
            same = np.array_equal(meshes[t, b].numpy(), np.asarray(want[t]))
            assert same or t > 0, f"sample {b}: the encoder's mesh differs"
            if not same:
                break
            np.testing.assert_allclose(y[b, t].numpy(), jy[b, t], rtol=0, atol=ROLLOUT_TOL)
            compared += 1
    assert compared >= B + 1


def _jax_loss_and_grad(fused, weights, x, y):
    model = _jax_predictor(fused, tf=1.0).model
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}

    def sample_loss(params, xb, yb):
        state = model.apply(params, xb, method=JSeq2Seq.encode, rngs=rngs)
        _, y_hat = model.apply(params, state, 0, T_OUT, yb, method=JSeq2Seq.decode, rngs=rngs)
        return J_LOSSES["MSE"](y_hat, yb, None)

    def batch_loss(params):
        return jnp.mean(jax.vmap(lambda xb, yb: sample_loss(params, xb, yb))(x, y))

    params = jax.tree.map(jnp.asarray, weights)
    loss, grads = jax.jit(jax.value_and_grad(batch_loss))(params)
    clip = optax.clip_by_global_norm(10.0)
    grads, _ = clip.update(grads, clip.init(params))
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def test_gcn_train_step_loss_and_grads_match_jax(jax_run, tmp_path):
    """One full-BPTT train step (teacher forcing 1.0: every decoder mesh
    from the true frame, so both packages run on the same meshes; dropout
    0): the loss within 1e-4 relative and every gradient leaf, clipped at
    the global norm 10, within 1e-4 × max(1, max|g|) of
    ``jax.value_and_grad`` of the JAX loss."""
    fused, _, weights, ds, _, _ = jax_run
    j_loss, j_grads = _jax_loss_and_grad(fused, weights, jnp.asarray(ds.x), jnp.asarray(ds.y))
    tp = _port(weights, fused, tf=1.0, run_dir=tmp_path)
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    loss, overflow = tp.train_step(ds.x, ds.y)
    assert int(overflow) == 0
    assert abs(float(loss) - j_loss) <= 1e-4 * abs(j_loss)
    grads = {name: p.grad for name, p in tp.model.named_parameters()}
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        assert _rel_err(g.numpy(), j_grads[name].numpy()) <= GRAD_TOL, name


# ---------------------------------------------------------------- bf16


@pytest.fixture(scope="module")
def bf16_blocks():
    """The Â-block meshes built by each package from the same bf16 frames,
    the port's graph holding the JAX package's bf16 blocks (the builds
    differ by a few ulps of the degrees, ``tests/test_torch_bf16.py``)."""
    tg, jgs = _graphs("blocks", bf16=True)
    assert tg.agg_meta.blocks.dtype == BF16
    tg = tg.replace(agg_meta=tg.agg_meta._replace(blocks=torch.stack(
        [torch.tensor(np.asarray(jnp.asarray(jg.agg_meta.blocks, jnp.float32)))
         for jg in jgs]).to(BF16)))
    return tg, jgs


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(ref, rel):
    return rel * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("fin,fout", [(17, 16), (16, 1)])
def test_gcnconv_bf16_on_blocks_matches_jax(bf16_blocks, fin, fout):
    """GCNConv in bf16 on the same bf16 Â: both round x W, the block
    product (an f32 sum rounded once) and the bias add, so the outputs lie
    within three bf16 roundings, 3 × 2⁻⁷ × max(1, max|ref|)."""
    tg, jgs = bf16_blocks
    x = _feats(tg.n_max, fin + 30, fin)
    jmod = JGCNConv(out_channels=fout, dtype=jnp.bfloat16)
    params = _init(jmod, 1, jnp.asarray(x[0], jnp.bfloat16), jgs[0])
    tmod = TGCNConv(fin, fout, dtype=BF16)
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).to(BF16), tg)
    assert out.dtype == BF16
    for b, jg in enumerate(jgs):
        ref = jmod.apply(params, jnp.asarray(x[b], jnp.bfloat16), jg)
        assert ref.dtype == jnp.bfloat16
        assert np.abs(_f32(out[b]) - _f32(ref)).max() <= _tol(_f32(ref), 3 * ULP)


@pytest.mark.parametrize("fused", [True, False])
def test_gcn_cell_bf16_on_blocks_matches_jax(bf16_blocks, fused):
    """A GCN GConvLSTM step in bf16 on the same bf16 Â, fused and per-gate:
    the output gate, H and C within 1e-2 × max(1, max|ref|), the bound of
    ``tests/test_torch_bf16.py``'s ChebConv cell (XLA rounds a bf16
    sigmoid after each op, torch rounds the f32 sigmoid once)."""
    tg, jgs = bf16_blocks
    n, fx, d = tg.n_max, 4, 8
    x, h, c = _feats(n, 40, fx), _feats(n, 41, d, 0.5), _feats(n, 42, d, 0.5)
    jcell = JGConvLSTM(out_channels=d, n_conv_layers=2, convolution_type="GCNConv",
                       fused=fused, dtype=jnp.bfloat16)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    params = _init(jcell, 8, bf(x[0]), jgs[0], bf(h[0]), bf(c[0]))
    tcell = TGConvLSTM(fx, d, 2, "GCNConv", dtype=BF16, fused_gates=fused)
    tcell.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        outs = tcell(torch.from_numpy(x).to(BF16), tg,
                     torch.from_numpy(h).to(BF16), torch.from_numpy(c).to(BF16))
    assert all(t.dtype == BF16 for t in outs)
    for b, jg in enumerate(jgs):
        refs = jcell.apply(params, bf(x[b]), jg, bf(h[b]), bf(c[b]))
        for out, ref in zip(outs, refs):
            assert np.abs(_f32(out[b]) - _f32(ref)).max() <= _tol(_f32(ref), 1e-2)


# ---------------------------------------------------------------- parameters


def test_gcn_params_round_trip_and_init_layout(jax_run):
    """The JAX package's GCN Seq2Seq tree (fused ``gates/w_x_0`` (4, f, d)
    … or per-gate ``conv_x/conv_l/lin/kernel`` (4, in, d), ``bias`` (4,
    d); head convs ``lin``/``bias``) maps leaf for leaf onto the port's
    state_dict, ``params_to_jax`` gives it back exactly, and the port's own
    seeded init has the JAX tree's structure and shapes, with every kernel
    drawn from glorot-uniform of its (in, out) fans (GCN's ``lin``
    included) and zero biases."""
    fused, _, weights, _, _, _ = jax_run
    sd = params_from_jax(weights)
    cell = weights["params"]["enc"]["encoder"]["rnn_0"]
    assert ("gates" in cell) == fused and ("conv_x" in cell) != fused
    back = params_to_jax(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(weights)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(weights)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    tp = _port(weights, fused)
    assert sorted(tp.model.state_dict()) == sorted(sd)
    init_params(tp.model, torch.Generator().manual_seed(0))
    mine = params_to_jax(tp.model.state_dict())
    shapes = jax.tree.map(np.shape, weights)
    assert jax.tree.map(np.shape, mine) == shapes
    seen = 0
    for path, v in jax.tree_util.tree_leaves_with_path(mine["params"]):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("kernel") or "/gates/w_" in name:
            fan_in, fan_out = v.shape[-2], v.shape[-1]
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            assert 0.5 * limit < np.abs(v).max() <= limit, name
            seen += 1
        elif "norm_" not in name:
            assert not v.any(), name
    # kernels: an encoder cell's w_x_0, w_h_0 and w_1 (per-gate: 2 sides × 2
    # layers), a decoder cell's w_x_0 and w_h_0 (its stacks 1 layer deep),
    # 2 cells each, and the two head convs
    assert seen == (2 * 3 + 2 * 2 + 2 if fused else 2 * 4 + 2 * 2 + 2)
