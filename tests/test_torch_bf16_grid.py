"""PyTorch port vs JAX package in bf16 on the sea-ice flagship's pixelwise
grid (``compute_dtype="bfloat16"``, ``aggregation="grid"``; f32 master
weights, keep planes, LayerNorm statistics, predictions and loss), cut to
a 12×20 masked grid as tests/test_torch_grid_model.py cuts it.

K5's and K6's plain versions against the JAX package's Pallas kernel in
interpret mode, both on bf16 q, k, v, e_dir, valid and cotangent: both
compute in f32 and round each output once (JAX sums the dk/dv halos and
the de_dir partials in f32 before it casts), so every output agrees within
one bf16 rounding, 2⁻⁷ × max(1, max|ref|). Then TransformerConv, the
fused attention gate stack and a GConvLSTM on the grid, ChebConv on the
grid, a rollout with climatology (TransformerConv and ChebConv), a train
step's loss and gradients, and the port's bf16 rollout against its own
f32 one. The two packages round at other places (each test says where),
so two bf16 programs differ by about as much as bf16 and f32 do; each
test states its bound and why. The grid's mesh is fixed, so no cell flips.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import NEG_INF
from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.config import ModelConfig as JModelConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models import conv as jconv
from quadtree_mpnnlstm_tpu.models.cells import GConvLSTM as JGConvLSTM
from quadtree_mpnnlstm_tpu.models.conv import ChebConv as JChebConv
from quadtree_mpnnlstm_tpu.models.conv import TransformerConv as JTransformerConv
from quadtree_mpnnlstm_tpu.models.fused import FusedAttnGateStack as JFusedAttn
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.ops import pallas_grid_attn as jga
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig, ModelConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.models.cells import GConvLSTM as TGConvLSTM
from quadtree_mpnnlstm_tpu_torch.models.fused import FusedAttnGateStack as TFusedAttn
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import Seq2Seq
from quadtree_mpnnlstm_tpu_torch.ops import grid_attn as tga
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

BF16 = torch.bfloat16
ULP = 2.0**-7  # one bf16 rounding, relative
# a conv rounds q, k and v (XLA: the product, then the bias add; the port:
# one rounding of both) and its output after the skip add, around the
# attention's one rounding: at most three roundings of values within
# max|ref| apart (as tests/test_torch_bf16_attn.py)
CONV_TOL = 3 * ULP

SHAPE = (12, 20)
P = SHAPE[0] * SHAPE[1]
B = 2
GRID = dict(image_shape=SHAPE, thresh=NEG_INF, aggregation="grid", use_edge_attrs=True)
# the JAX package takes its Pallas kernel only with grid_attn="pallas"
J_GRID = dict(GRID, grid_attn="pallas")


def _tol(ref, rel):
    return rel * max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jbf16(x):
    return jnp.asarray(_f32(x) if isinstance(x, torch.Tensor) else np.asarray(x, np.float32),
                       jnp.bfloat16)


def _mask(isolated=False):
    """True = invalid: random holes, a masked band and, with ``isolated``,
    one valid pixel whose 8 neighbours are all masked."""
    mask = np.random.default_rng(0).random(SHAPE) < 0.2
    mask[:2] = True
    if isolated:
        mask[4:7, 8:11] = True
        mask[5, 9] = False
    return mask


# ---------------------------------------------------------------- K5/K6


# H 256 (the flagship's gate stacks, 8 × d 32), 32 and 1 (its head convs)
@pytest.mark.parametrize("heads,d,ndirs,dropout", [
    (8, 32, 4, False), (8, 32, 8, True), (1, 32, 4, True), (1, 32, 8, False),
    (1, 1, 4, False), (1, 1, 8, True)])
def test_grid_attn_bf16_apply_and_grads_match_jax(heads, d, ndirs, dropout):
    """K5's plain version on bf16 q, k, v, e_dir and valid against the JAX
    kernel on the same bf16 values, and K6's (autograd through it) dq, dk,
    dv and de_dir: each within one bf16 rounding. The keep planes (rate
    0.1) come from numpy and go to both; the isolated pixel aggregates 0."""
    rng = np.random.default_rng(heads * 100 + d + ndirs)
    h = heads * d
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, P, h)).astype(np.float32)).to(BF16)
                  for _ in range(4))
    e = torch.from_numpy(rng.standard_normal((ndirs, h)).astype(np.float32)).to(BF16)
    valid = torch.from_numpy(~_mask(True).reshape(-1)).to(BF16)
    keep = (((rng.random((B, ndirs, P, heads)) < 0.9) / 0.9).astype(np.float32)
            if dropout else None)
    dims = tga.GridAttnDims(*SHAPE, heads, d, ndirs)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, e)]
    out = tga.grid_attn_apply(*leaves, valid, None if keep is None else torch.from_numpy(keep),
                              dims)
    assert out.dtype == BF16 and not out[:, 5 * SHAPE[1] + 9].any()
    grads = torch.autograd.grad(out, leaves, g)
    assert all(x.dtype == BF16 for x in grads)

    jdims = jga.GridAttnDims(*SHAPE, heads, d, ndirs, dropout)
    jvalid = _jbf16(valid)[:, None]
    de = 0.0  # de_dir sums over the batch (in f32 here; each sample's is bf16)
    for s in range(B):
        kp = jnp.asarray(keep[s]) if dropout else None
        ref, vjp = jax.vjp(lambda *a, kp=kp: jga.grid_attn_apply(*a, jvalid, kp, jdims),
                           _jbf16(q[s]), _jbf16(k[s]), _jbf16(v[s]), _jbf16(e))
        jgrads = vjp(_jbf16(g[s]))
        assert ref.dtype == jnp.bfloat16 and all(x.dtype == jnp.bfloat16 for x in jgrads)
        assert np.abs(_f32(out[s]) - _f32(ref)).max() <= _tol(_f32(ref), ULP)
        for name, mine, jg in zip("qkv", grads[:3], jgrads[:3]):
            err = np.abs(_f32(mine[s]) - _f32(jg)).max()
            assert err <= _tol(_f32(jg), ULP), (name, s, err)
        de = de + _f32(jgrads[3])
    # the port rounds the batch's f32 de_dir once, JAX each sample's
    assert np.abs(_f32(grads[3]) - de).max() <= _tol(de, 2 * ULP)


@pytest.mark.parametrize("heads,d,ndirs,dropout", [(8, 32, 8, True), (1, 1, 4, False)])
def test_grid_attn_plain_bf16_rounds_the_f32_results_once(heads, d, ndirs, dropout):
    """K5's and K6's plain versions on bf16 operands are their f32 results
    on the same (widened) values, each rounded to bf16 once: bit for bit,
    which is what K5's bf16 kernel is held to on the card."""
    gen = torch.Generator().manual_seed(d)
    h = heads * d
    q, k, v, g = (torch.randn(B, P, h, generator=gen).to(BF16) for _ in range(4))
    e = torch.randn(ndirs, h, generator=gen).to(BF16)
    valid = torch.from_numpy(~_mask(True).reshape(-1)).to(BF16)
    keep = ((torch.rand(B, ndirs, P, heads, generator=gen) < 0.9) / 0.9) if dropout else None
    dims = tga.GridAttnDims(*SHAPE, heads, d, ndirs)
    args = (q, k, v, e, valid, keep, dims)
    f32 = tuple(x.float() for x in args[:5]) + args[5:]
    assert torch.equal(tga.grid_attn_plain(*args), tga.grid_attn_plain(*f32).to(BF16))
    for mine, ref in zip(tga.grid_attn_bwd_plain(*args, g),
                         tga.grid_attn_bwd_plain(*f32, g.float())):
        assert mine.dtype == BF16 and torch.equal(mine, ref.to(BF16))


# ---------------------------------------------------------------- modules


@pytest.fixture(scope="module")
def meshes():
    """The grid graph of both packages, built from a bf16 frame: sizes in
    the data's dtype, the direction attributes and the validity in f32."""
    x = np.random.default_rng(1).random((B, 1, *SHAPE, 1)).astype(np.float32)
    mask = _mask()
    tg, data = image_to_graph(t_posenc(torch.from_numpy(x).to(BF16)), GraphConfig(**GRID),
                              mask=torch.from_numpy(mask))
    jg, jdata = j_image_to_graph(j_posenc(jnp.asarray(x[0], jnp.bfloat16)),
                                 JGraphConfig(**J_GRID), mask=jnp.asarray(mask))
    assert data.dtype == BF16 and jdata.dtype == jnp.bfloat16 and jg.grid_attn_fused
    assert tg.grid_attr.dtype == torch.float32 and np.asarray(jg.grid_attr).dtype == np.float32
    np.testing.assert_array_equal(tg.grid_attr.numpy(), np.asarray(jg.grid_attr))
    np.testing.assert_array_equal(_f32(data[0]), _f32(jdata))
    return tg, jg


def _feats(seed, width, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((B, P, width))).astype(np.float32)


def _flax_params(module, seed, *args):
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed), *args))


def _nonzero_biases(params, seed):
    rng = np.random.default_rng(seed)

    def fill(path, v):
        name = str(path[-1].key)
        if name == "bias" or name.startswith("b_"):
            return (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        return np.asarray(v)

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.mark.parametrize("fin,fout", [(9, 8), (8, 1)])
def test_transformer_conv_on_the_grid_bf16_matches_jax(meshes, fin, fout):
    """The head convs' shapes (hidden + climatology → hidden, hidden → 1)
    on the grid in bf16: e_dir and the validity plane in bf16, as the JAX
    package casts them; within ``CONV_TOL``."""
    tg, jg = meshes
    x = _feats(fin, fin)
    kw = dict(heads=1, concat=False, dropout=0.1, edge_dim=2)
    jmod = JTransformerConv(out_channels=fout, dtype=jnp.bfloat16, **kw)
    params = _nonzero_biases(_flax_params(jmod, 1, _jbf16(x[0]), jg), 2)
    tmod = tconv.TransformerConv(fin, fout, dtype=BF16, **kw).eval()
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    seen = []
    apply = tga.grid_attn_apply

    def spy(q, k, v, e_dir, valid, *rest):
        seen.append((q.dtype, e_dir.dtype, valid.dtype))
        return apply(q, k, v, e_dir, valid, *rest)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tga, "grid_attn_apply", spy)
        out = tmod(torch.from_numpy(x), tg)
    assert out.dtype == BF16 and seen == [(BF16, BF16, BF16)]
    for b in range(B):
        ref = jmod.apply(params, _jbf16(x[b]), jg)
        assert np.abs(_f32(out[b]) - _f32(ref)).max() <= _tol(_f32(ref), CONV_TOL)


@pytest.mark.parametrize("fx,layers", [(8, 3), (4, 1)])
def test_fused_attn_gate_stack_and_cell_on_the_grid_bf16_match_jax(meshes, fx, layers):
    """The flagship's gate stack (8 streams as the heads of one call a
    layer, 3 layers) in bf16 within ``CONV_TOL`` a layer, and the GConvLSTM
    around it: the output gate, H and C within 1e-2 × max(1, max|ref|), the
    bound of the ChebConv cell's bf16 test (XLA rounds a bf16 sigmoid after
    each op, torch once)."""
    tg, jg = meshes
    d = 8
    x, h, c = _feats(1, fx), _feats(2, d, 0.5), _feats(3, d, 0.5)
    jmod = JFusedAttn("TransformerConv", d, n_layers=layers, dtype=jnp.bfloat16)
    params = _nonzero_biases(_flax_params(jmod, 3, _jbf16(x[0]), _jbf16(h[0]), jg), 4)
    tmod = TFusedAttn(fx, d, d, n_layers=layers, dtype=BF16).eval()
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    jcell = JGConvLSTM(out_channels=d, n_conv_layers=layers, convolution_type="TransformerConv",
                       dtype=jnp.bfloat16)
    cparams = _nonzero_biases(_flax_params(jcell, 5, _jbf16(x[0]), jg, _jbf16(h[0]),
                                           _jbf16(c[0])), 6)
    tcell = TGConvLSTM(fx, d, n_conv_layers=layers, convolution_type="TransformerConv",
                       dtype=BF16).eval()
    tcell.load_state_dict(state_dict_from_flax(cparams["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), torch.from_numpy(h), tg)
        outs = tcell(torch.from_numpy(x).to(BF16), tg, torch.from_numpy(h).to(BF16),
                     torch.from_numpy(c).to(BF16))
    assert out.dtype == BF16 and all(t.dtype == BF16 for t in outs)
    for b in range(B):
        ref = jmod.apply(params, _jbf16(x[b]), _jbf16(h[b]), jg)
        assert np.abs(_f32(out[:, b]) - _f32(ref)).max() <= _tol(_f32(ref), layers * CONV_TOL)
        refs = jcell.apply(cparams, _jbf16(x[b]), jg, _jbf16(h[b]), _jbf16(c[b]))
        for mine, r in zip(outs, refs):
            assert np.abs(_f32(mine[b]) - _f32(r)).max() <= _tol(_f32(r), 1e-2)


@pytest.mark.parametrize("fin,fout", [(9, 8), (8, 1)])
def test_chebconv_on_the_grid_bf16_matches_jax(meshes, fin, fout):
    """ChebConv (K = 3) on the grid in bf16: the stencil's coefficients are
    cast to z's dtype (``grid_a_mul``), as the JAX package casts them. Each
    of the K − 1 = 2 stencil steps rounds its product and the recursion's
    sums, and the taps' products and their sum are rounded: within 4 bf16
    roundings of values within max|ref|."""
    tg, jg = meshes
    x = _feats(fin + 20, fin)
    jmod = JChebConv(out_channels=fout, K=3, dtype=jnp.bfloat16)
    params = _nonzero_biases(_flax_params(jmod, 1, _jbf16(x[0]), jg), 2)
    tmod = tconv.ChebConv(fin, fout, K=3, dtype=BF16)
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), tg)
    assert out.dtype == BF16
    for b in range(B):
        ref = jmod.apply(params, _jbf16(x[b]), jg)
        assert ref.dtype == jnp.bfloat16
        assert np.abs(_f32(out[b]) - _f32(ref)).max() <= _tol(_f32(ref), 4 * ULP)


# ---------------------------------------------------------------- Seq2Seq

VARS, T_IN, T_OUT = 5, 3, 4


def _model(conv, dtype="bfloat16", n_conv=3):
    return dict(hidden_size=8, dropout=0.1, input_features=VARS, input_timesteps=T_IN,
                output_timesteps=T_OUT, n_layers=1, n_conv_layers=n_conv,
                convolution_type=conv, compute_dtype=dtype)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(4)
    x = rng.random((B, T_IN, *SHAPE, VARS)).astype(np.float32)
    y = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    clim = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    return x, y, clim, _mask()


@pytest.mark.parametrize("conv", ["TransformerConv", "ChebConv"])
def test_rollout_with_climatology_bf16_matches_jax(inputs, conv):
    """The bf16 rollout on the fixed grid with climatology (cast to the
    state's dtype, flattened once) against the JAX package's, same weights:
    frame t within (t + 1) × 2e-2 on average and (t + 1) × 0.15 at most
    (the bounds of the bf16 forecasts on quadtrees, tests/test_torch_bf16.py,
    from the JAX package's bf16-vs-f32 bounds, tests/test_bf16.py) or, where
    larger, within the JAX package's own bf16-vs-f32 distance on the same
    frame: two bf16 programs that round at other places differ by about as
    much as bf16 and f32 do (ChebConv's first frame on the grid: port
    against JAX bf16 0.27 at most, JAX's bf16 against its f32 0.49). The
    port's bf16 rollout against its own f32 one: the first frame within
    2e-2 on average (chip_smoke.py phase 30's bound)."""
    x, _, clim, mask = inputs
    jms = {d: JSeq2Seq(JModelConfig(**_model(conv, d)), JGraphConfig(**J_GRID),
                       use_climatology=True) for d in ("bfloat16", "float32")}
    weights = _nonzero_biases(jax.tree.map(np.asarray, jms["bfloat16"].init(
        jax.random.PRNGKey(0), jnp.asarray(x[0]), None, jnp.asarray(clim[0]),
        jnp.asarray(mask))), 1)
    ys = {}
    for dtype in ("bfloat16", "float32"):
        model = Seq2Seq(ModelConfig(**_model(conv, dtype)), GraphConfig(**GRID),
                        use_climatology=True).eval()
        model.load_state_dict(params_from_jax(weights))
        with torch.no_grad():
            ys[dtype] = model.rollout(torch.from_numpy(x), mask=torch.from_numpy(mask),
                                      climatology=torch.from_numpy(clim))[0]
    y16 = ys["bfloat16"]
    assert y16.dtype == torch.float32 and y16.shape == (B, T_OUT, *SHAPE, 1)
    refs = {}
    for d, jm in jms.items():
        apply = jax.jit(lambda xb, cb, jm=jm: jm.apply(weights, xb, None, cb, jnp.asarray(mask)))
        refs[d] = np.stack([np.asarray(apply(jnp.asarray(x[b]), jnp.asarray(clim[b])))
                            for b in range(B)])
    assert refs["bfloat16"].dtype == np.float32
    for t in range(T_OUT):
        err = np.abs(y16[:, t].numpy() - refs["bfloat16"][:, t])
        spread = np.abs(refs["float32"][:, t] - refs["bfloat16"][:, t])
        assert err.mean() <= max(2e-2 * (t + 1), spread.mean()), (t, err.mean(), spread.mean())
        assert err.max() <= max(0.15 * (t + 1), spread.max()), (t, err.max(), spread.max())
    assert float((y16[:, 0] - ys["float32"][:, 0]).abs().mean()) <= 2e-2


def test_grid_train_step_bf16_loss_and_grads_match_jax(inputs, tmp_path):
    """One full-BPTT bf16 train step with climatology on the grid,
    attention and head dropout 0 (the registries' TransformerConv entry):
    the loss within 1e-2 relative of the JAX package's bf16 loss, and the
    whole gradient (every leaf, as one vector) no further from the JAX
    package's f32 gradient, in L2 norm, than 3 × the JAX package's own bf16
    gradient is. At this size the gradients are small sums of large
    cancelling terms, so bf16 rounding moves them far in both packages: on
    this seed JAX's bf16 gradient lies 0.19 of the f32 gradient's norm from
    it and up to 0.33 × max(1, max|g|) on a leaf, the port's 0.33 and 0.61
    (both packages agree within 3.1e-6 in f32, tests/test_torch_grid_train.py).
    Eager PyTorch rounds every bf16 op where XLA rounds each fusion, so the
    port's rounding noise is a few times JAX's; a lost cast or a wrong bf16
    formula moves the gradient by its whole norm."""
    x, y, clim, mask = inputs
    model = dict(hidden_size=8, n_layers=1, n_conv_layers=2, dropout=0.0,
                 convolution_type="TransformerConv")
    kw = dict(thresh=float("-inf"), decompose=False, input_features=VARS, input_timesteps=T_IN,
              output_timesteps=T_OUT, use_climatology=True)
    with pytest.MonkeyPatch.context() as mp:
        for registry in (jconv.CONVOLUTION_KWARGS, tconv.CONVOLUTION_KWARGS):
            mp.setitem(registry, "TransformerConv",
                       dict(registry["TransformerConv"], dropout=0.0))
        refs = {}
        for dtype in ("bfloat16", "float32"):
            jp = JPredictor(SHAPE, model_kwargs=dict(model, compute_dtype=dtype, remat=False),
                            graph_kwargs=dict(aggregation="grid", grid_attn="pallas"), **kw)
            if dtype == "bfloat16":
                jp._ensure_params()
                weights = jax.tree.map(np.asarray, jp.params)
            refs[dtype] = _jax_loss_and_grads(jp.model, weights, x, y, clim, mask)
        tp = NextFramePredictorS2S(SHAPE, device="cpu", run_dir=str(tmp_path),
                                   model_kwargs=dict(model, compute_dtype="bfloat16"),
                                   graph_kwargs=dict(aggregation="grid"), **kw)
        tp.load_jax_params(weights)
        tp.initiate_training(lr=0.0, lr_decay=0.95)
        loss, overflow = tp.train_step(x, y, mask=mask, climatology=clim)
    j_loss = refs["bfloat16"][0]
    assert int(overflow) == 0 and loss.dtype == torch.float32
    assert abs(float(loss) - j_loss) <= 1e-2 * abs(j_loss)
    grads = {name: p.grad for name, p in tp.model.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    (_, ref), (_, ref32) = refs["bfloat16"], refs["float32"]
    assert set(grads) == set(ref) == set(ref32)
    dist = lambda a: sum(float(((a[n] - ref32[n]) ** 2).sum()) for n in ref32) ** 0.5  # noqa: E731
    assert dist(grads) <= 3 * dist(ref), (dist(grads), dist(ref))


def _jax_loss_and_grads(model, weights, x, y, clim, mask):
    """(loss, clipped gradients as a port state_dict) of one full-BPTT step
    of the JAX package (``jax.value_and_grad`` of the batch mean of the
    per-sample masked MSE)."""
    m = jnp.asarray(mask)
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}

    def sample_loss(params, xb, yb, cb):
        state = model.apply(params, xb, mask=m, method=JSeq2Seq.encode, rngs=rngs)
        _, y_hat = model.apply(params, state, 0, T_OUT, yb, cb, m, method=JSeq2Seq.decode,
                               rngs=rngs)
        return J_LOSSES["MSE"](y_hat, yb, m)

    def batch_loss(params):
        return jnp.mean(jax.vmap(lambda xb, yb, cb: sample_loss(params, xb, yb, cb))(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(clim)))

    params = jax.tree.map(jnp.asarray, weights)
    loss, grads = jax.jit(jax.value_and_grad(batch_loss))(params)
    clip = optax.clip_by_global_norm(10.0)
    grads, _ = clip.update(grads, clip.init(params))
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))
