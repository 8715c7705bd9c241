"""PyTorch port vs JAX package in bf16 with TransformerConv on quadtree
attention windows (``compute_dtype="bfloat16"``; f32 master weights,
window attributes, keep windows, LayerNorm statistics, predictions and
loss).

K3's and K4's plain versions against the JAX package's Pallas kernel in
interpret mode, both on bf16 q, k, v, Wₑ and cotangent: both compute in
f32 and round each output once, so the forward and dq and dWₑ agree within
one bf16 rounding, 2⁻⁷ × max(1, max|ref|); JAX rounds every tile's dk/dv
window to bf16 and sums the overlapping windows in bf16, the port rounds
its f32 sum once (``K4_DKV_TOL`` states that bound). Then
``TransformerConv``, ``FusedAttnGateStack`` and a ``GConvLSTM`` step with
LayerNorm in bf16 against the flax modules on the same windows, the
forecast until the first mesh flip, a teacher-forced train step, the
port's bf16 forecast against its own f32 one, the masters and the CPU
dispatch. The two packages round at other places (XLA rounds a bf16
dense's product before its bias, a bf16 sigmoid after each op, its bf16
segment sums at every add; the port rounds once), so two bf16 programs
differ by about as much as bf16 and f32 do; each test states its bound
and why.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models import conv as jconv
from quadtree_mpnnlstm_tpu.models.cells import GConvLSTM as JGConvLSTM
from quadtree_mpnnlstm_tpu.models.conv import TransformerConv as JTransformerConv
from quadtree_mpnnlstm_tpu.models.fused import FusedAttnGateStack as JFusedAttn
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.ops import pallas_attn as jattn
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig as TGraphConfig
from quadtree_mpnnlstm_tpu_torch.config import TrainConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph as t_image_to_graph
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.models.cells import GConvLSTM as TGConvLSTM
from quadtree_mpnnlstm_tpu_torch.models.fused import FusedAttnGateStack as TFusedAttn
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import LayerNorm as TLayerNorm
from quadtree_mpnnlstm_tpu_torch.ops import attn as tattn
from quadtree_mpnnlstm_tpu_torch.ops import grid_attn as tgrid_attn
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

BF16 = torch.bfloat16
ULP = 2.0**-7  # one bf16 rounding, relative
# JAX rounds each of a source row's T overlapping tile windows of dk/dv to
# bf16 and adds them in bf16 (jax.ops.segment_sum), the port rounds the f32
# sum once: up to 2T − 1 = 5 roundings of half an ulp each (T = 3 tiles)
# against one, on partial sums within max|ref|
K4_DKV_TOL = 3 * ULP


def _tol(ref, rel):
    return rel * max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))


def _f32(x):
    """numpy float32 of a torch or JAX array of any float dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(x):
    """numpy values rounded to bf16 (both packages take the same ones)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF16)


# ---------------------------------------------------------------- K3/K4


def _frame(seed, noise, shape=(32, 32)):
    rng = np.random.default_rng(seed)
    r, c = np.arange(shape[0])[:, None], np.arange(shape[1])[None, :]
    cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
    blob = np.exp(-((r - cy) ** 2 + (c - cx) ** 2) / (2 * (shape[0] / 5) ** 2))
    return (blob + noise * rng.random(shape)).astype(np.float32)


# as tests/test_torch_attn.py: n_max 300 (no multiple of NT), 253 and 289
# nodes, a dead tile with visible rows and padding rows without a slot
N_MAX, NT, EB, SW = 300, 128, 1024, 512


@pytest.fixture(scope="module")
def windows():
    cfg = JGraphConfig(image_shape=(32, 32), max_grid_size=8, thresh=0.3, n_max=N_MAX,
                       e_max=1600)
    graphs = [j_image_to_graph(j_posenc(jnp.asarray(_frame(s, 0.0)[None, :, :, None])), cfg)[0]
              for s in (1, 5)]
    stack = lambda name: np.stack([np.asarray(getattr(g, name)) for g in graphs])  # noqa: E731
    assert stack("n_nodes").tolist() == [253, 289]
    meta, ovf = tattn.attn_tile_meta(
        torch.from_numpy(stack("edge_src")).long(), torch.from_numpy(stack("edge_dst")).long(),
        torch.from_numpy(stack("edge_attr")), N_MAX, NT, EB, SW,
        torch.from_numpy(stack("n_nodes")).long())
    assert int(ovf.max()) == 0
    jmetas = [jattn.attn_tile_meta(g.edge_src, g.edge_dst, g.edge_attr, N_MAX, NT, EB, SW,
                                   n_nodes=g.n_nodes)[0] for g in graphs]
    return meta, jmetas


# HD 128 (the gate stacks: 8 streams × d 16), 16 and 1 (the head convs)
@pytest.mark.parametrize("heads,d", [(8, 16), (1, 16), (1, 1)])
@pytest.mark.parametrize("dropout", [False, True])
def test_attn_bf16_apply_and_grads_match_jax(windows, heads, d, dropout):
    """K3's plain version on bf16 q, k, v, Wₑ against the JAX kernel on the
    same bf16 values: within one bf16 rounding; K4's (autograd through it)
    dq and dWₑ within one rounding, dk and dv within ``K4_DKV_TOL``. With
    dropout the numpy keep windows (rate 0.1) go to both."""
    meta, jmetas = windows
    b, t = meta.s0.shape
    hd = heads * d
    rng = np.random.default_rng(heads * 100 + d)
    q, k, v, g = (_bf16(rng.standard_normal((b, N_MAX, hd))) for _ in range(4))
    we = _bf16(rng.standard_normal((2, hd)))
    keep = ((rng.random((b, t, heads, EB)) < 0.9) / 0.9).astype(np.float32) if dropout else None
    dims = tattn.AttnDims(N_MAX, NT, EB, SW, heads, d)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, we)]
    out = tattn.attn_apply(*leaves, None if keep is None else torch.from_numpy(keep), meta, dims)
    assert out.dtype == BF16
    grads = torch.autograd.grad(out, leaves, g)
    assert all(x.dtype == BF16 for x in grads)

    jdims = jattn.AttnDims(N_MAX, NT, EB, SW, heads, d)
    jb = lambda x: jnp.asarray(_f32(x), jnp.bfloat16)  # noqa: E731
    jwe = 0.0  # dWₑ sums over the batch (in f32 here; each sample's is bf16)
    for s, jm in enumerate(jmetas):
        jkeep = jnp.asarray(keep[s]) if dropout else jnp.ones((t, EB), jnp.float32)
        ref, vjp = jax.vjp(lambda *a, jm=jm, jkeep=jkeep: jattn.attn_apply(*a, jkeep, jm, jdims),
                           jb(q[s]), jb(k[s]), jb(v[s]), jb(we))
        jgrads = vjp(jb(g[s]))
        assert ref.dtype == jgrads[0].dtype == jnp.bfloat16
        assert np.abs(_f32(out[s]) - _f32(ref)).max() <= _tol(_f32(ref), ULP)
        for name, mine, jg in zip("qkv", grads[:3], jgrads[:3]):
            tol = ULP if name == "q" else K4_DKV_TOL
            err = np.abs(_f32(mine[s]) - _f32(jg)).max()
            assert err <= _tol(_f32(jg), tol), (name, s, err)
        jwe = jwe + _f32(jgrads[3])
    # the port rounds the batch's f32 dWₑ once, JAX each sample's
    assert np.abs(_f32(grads[3]) - jwe).max() <= _tol(jwe, 2 * ULP)


@pytest.mark.parametrize("heads,d,dropout", [(8, 16, True), (1, 16, False), (1, 1, True)])
def test_attn_plain_bf16_rounds_the_f32_results_once(windows, heads, d, dropout):
    """K3's and K4's plain versions on bf16 operands are their f32 results
    on the same (widened) values, each rounded to bf16 once: bit for bit."""
    meta, _ = windows
    b, t = meta.s0.shape
    hd = heads * d
    gen = torch.Generator().manual_seed(hd)
    q, k, v, g = (torch.randn(b, N_MAX, hd, generator=gen).to(BF16) for _ in range(4))
    we = torch.randn(2, hd, generator=gen).to(BF16)
    keep = ((torch.rand(b, t, heads, EB, generator=gen) < 0.9) / 0.9) if dropout else None
    dims = tattn.AttnDims(N_MAX, NT, EB, SW, heads, d)
    args = (q, k, v, we, keep, meta, dims)
    f32 = tuple(x.float() for x in args[:4]) + args[4:]
    assert torch.equal(tattn.attn_plain(*args), tattn.attn_plain(*f32).to(BF16))
    for mine, ref in zip(tattn.attn_bwd_plain(*args, g), tattn.attn_bwd_plain(*f32, g.float())):
        assert mine.dtype == BF16 and torch.equal(mine, ref.to(BF16))
    dq, dlog, used, dwe = tattn.attn_bwd_slots_plain(*args, g)
    assert dq.dtype == dwe.dtype == BF16 and dlog.dtype == used.dtype == torch.float32
    assert all(x.dtype == BF16 for x in tattn.attn_combine_plain(dlog, used, q, g, meta, dims))


def test_cpu_bf16_tensors_never_launch_attention_kernels(windows):
    """bf16 tensors on the CPU take the plain versions of K3-K6, forward and
    backward: no launch is counted, f32 or bf16."""
    meta, _ = windows
    dims = tattn.AttnDims(N_MAX, NT, EB, SW, 1, 4)
    tattn.reset_launch_counts()
    tgrid_attn.reset_launch_counts()
    q = torch.zeros(2, N_MAX, 4, dtype=BF16, requires_grad=True)
    tattn.attn_apply(q, q, q, torch.zeros(2, 4, dtype=BF16), None, meta, dims).sum().backward()
    z = torch.zeros(1, 12, 4, dtype=BF16, requires_grad=True)
    tgrid_attn.grid_attn_apply(z, z, z, torch.zeros(4, 4, dtype=BF16),
                               torch.ones(12, dtype=BF16), None,
                               tgrid_attn.GridAttnDims(3, 4, 1, 4, 4)).sum().backward()
    for counts in (tattn.LAUNCHES, tattn.LAUNCHES_BF16, tgrid_attn.LAUNCHES,
                   tgrid_attn.LAUNCHES_BF16):
        assert set(counts.values()) == {0}


# ---------------------------------------------------------------- modules

M_MAX, BATCH = 512, 2
MESH = dict(image_shape=(32, 32), max_grid_size=8, thresh=0.2, n_max=M_MAX, e_max=4096,
            aggregation="pallas", attn_windows=True, agg_nt=128, agg_eb=1024, agg_sw=512)


@pytest.fixture(scope="module")
def meshes():
    """Two f32 meshes (as tests/test_torch_transformer.py builds them), on
    which the bf16 modules run."""
    rng = np.random.default_rng(0)
    frames = np.stack([_frame(s, 0.02) for s in rng.integers(0, 100, BATCH)])
    x = frames[:, None, :, :, None]
    tg, _ = t_image_to_graph(t_posenc(torch.from_numpy(x)), TGraphConfig(**MESH))
    jgs = [j_image_to_graph(j_posenc(jnp.asarray(x[b])), JGraphConfig(**MESH))[0]
           for b in range(BATCH)]
    assert tg.agg[0] == "pallas_attn" and int(tg.overflow.max()) == 0
    for b, jg in enumerate(jgs):
        np.testing.assert_array_equal(tg.pixel_node[b].numpy(), np.asarray(jg.pixel_node))
    return tg, jgs


def _feats(seed, width, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((BATCH, M_MAX, width))).astype(np.float32)


def _flax_params(module, seed, *args):
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed), *args))


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


def _jbf16(x):
    return jnp.asarray(np.asarray(x, np.float32), jnp.bfloat16)


# TransformerConv: the module rounds q, k and v (XLA: the product, then
# the bias add; the port: one rounding of both) and the output after the
# skip add, around K3's one rounding; at most three roundings of values
# within max|ref| apart
CONV_TOL = 3 * ULP


@pytest.mark.parametrize("fin,fout", [(17, 16), (16, 1)])
def test_transformer_conv_bf16_matches_jax(meshes, fin, fout):
    """The decoder's head convs (hidden + 1 → hidden, hidden → 1; heads 1,
    mean over heads, root-weight skip) in bf16 on the same windows."""
    tg, jgs = meshes
    x = _feats(fin, fin)
    kw = dict(heads=1, concat=False, dropout=0.1, edge_dim=2)
    jmod = JTransformerConv(out_channels=fout, dtype=jnp.bfloat16, **kw)
    params = _nonzero_biases(_flax_params(jmod, 1, _jbf16(x[0]), jgs[0]), 2)
    tmod = tconv.TransformerConv(fin, fout, dtype=BF16, **kw).eval()
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    assert all(p.dtype == torch.float32 for p in tmod.parameters())
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), tg)
    assert out.dtype == BF16
    for b, jg in enumerate(jgs):
        ref = jmod.apply(params, _jbf16(x[b]), jg)
        assert ref.dtype == jnp.bfloat16
        assert np.abs(_f32(out[b]) - _f32(ref)).max() <= _tol(_f32(ref), CONV_TOL)


@pytest.mark.parametrize("fx,fh,d,layers", [(4, 16, 16, 2), (4, 8, 8, 1)])
def test_fused_attn_gate_stack_bf16_matches_jax(meshes, fx, fh, d, layers):
    """The gate stack (2·4 streams as the heads of one attention call a
    layer) in bf16: each layer rounds its projections, K3's output and the
    skip add; two layers compound them (``CONV_TOL`` a layer)."""
    tg, jgs = meshes
    x, h = _feats(1, fx), _feats(2, fh, 0.5)
    jmod = JFusedAttn("TransformerConv", d, n_layers=layers, dtype=jnp.bfloat16)
    params = _nonzero_biases(_flax_params(jmod, 3, _jbf16(x[0]), _jbf16(h[0]), jgs[0]), 4)
    tmod = TFusedAttn(fx, fh, d, n_layers=layers, dtype=BF16).eval()
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), torch.from_numpy(h), tg)  # (g, B, N, d)
    assert out.dtype == BF16
    for b, jg in enumerate(jgs):
        ref = jmod.apply(params, _jbf16(x[b]), _jbf16(h[b]), jg)
        assert np.abs(_f32(out[:, b]) - _f32(ref)).max() <= _tol(_f32(ref), layers * CONV_TOL)


def test_gconvlstm_attention_bf16_step_with_layernorm_matches_jax(meshes):
    """A TransformerConv GConvLSTM step and the LayerNorm after it in bf16:
    the output gate within 1e-2 × max(1, max|ref|), the normalised H and C
    within 2e-2, the bounds of the ChebConv cell's bf16 test
    (tests/test_torch_bf16.py): the gates' sigmoid rounds after each op in
    XLA and once in torch, and LayerNorm divides a gate's ulp by the row's
    spread."""
    import flax.linen as fnn

    tg, jgs = meshes
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, M_MAX, 4)).astype(np.float32)
    h, c = (0.5 * rng.standard_normal((2, BATCH, M_MAX, 8))).astype(np.float32)
    jcell = JGConvLSTM(out_channels=8, n_conv_layers=2, convolution_type="TransformerConv",
                       dtype=jnp.bfloat16)
    params = _nonzero_biases(_flax_params(jcell, 7, _jbf16(x[0]), jgs[0], _jbf16(h[0]),
                                          _jbf16(c[0])), 8)
    jnorm = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
    nparams = {"params": {"scale": (1 + 0.2 * rng.standard_normal(8)).astype(np.float32),
                          "bias": (0.1 * rng.standard_normal(8)).astype(np.float32)}}
    tcell = TGConvLSTM(4, 8, n_conv_layers=2, convolution_type="TransformerConv",
                       dtype=BF16).eval()
    tcell.load_state_dict(state_dict_from_flax(params["params"]))
    tnorm = TLayerNorm(8)
    tnorm.load_state_dict({"weight": torch.from_numpy(nparams["params"]["scale"]),
                           "bias": torch.from_numpy(nparams["params"]["bias"])})
    with torch.no_grad():
        o, hn, cn = tcell(torch.from_numpy(x).to(BF16), tg, torch.from_numpy(h).to(BF16),
                          torch.from_numpy(c).to(BF16))
        outs = (o, tnorm(hn), tnorm(cn))
    assert all(t.dtype == BF16 for t in outs)
    for b, jg in enumerate(jgs):
        jo, jh, jc = jcell.apply(params, _jbf16(x[b]), jg, _jbf16(h[b]), _jbf16(c[b]))
        refs = (jo, jnorm.apply(nparams, jh), jnorm.apply(nparams, jc))
        for out, ref, rel in zip(outs, refs, (1e-2, 2e-2, 2e-2)):
            err = np.abs(_f32(out[b]) - _f32(ref)).max()
            assert err <= _tol(_f32(ref), rel), (b, err)


# ---------------------------------------------------------------- model

SHAPE = (16, 16)
T_IN, T_OUT = 2, 3
MODEL = dict(hidden_size=8, n_layers=1, n_conv_layers=1, dropout=0.0,
             convolution_type="TransformerConv")
GRAPH = dict(max_grid_size=8, n_max=256, e_max=2048, node_budget=256,
             aggregation="pallas", agg_nt=128, agg_eb=1024, agg_sw=256)


def _dataset():
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    return ModMovingMNISTDataset(2, T_IN, T_OUT, canvas_size=SHAPE, digit_size=(8, 8),
                                 pixel_noise=0.02, velocity_noise=0.0, seed=1)


def _jax_predictor(tf=0.0, dtype="bfloat16"):
    return JPredictor(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                      teacher_forcing_ratio=tf,
                      model_kwargs=dict(MODEL, compute_dtype=dtype, remat=False),
                      graph_kwargs=dict(GRAPH))


def _port(weights=None, tf=0.0, run_dir="runs", dtype="bfloat16"):
    tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", teacher_forcing_ratio=tf, run_dir=str(run_dir),
                               model_kwargs=dict(MODEL), graph_kwargs=dict(GRAPH),
                               train_config=TrainConfig(dtype=dtype))
    if weights is not None:
        tp.load_jax_params(weights)
    return tp


@pytest.fixture(scope="module")
def jax_run():
    ds = _dataset()
    jp = _jax_predictor()
    jp._ensure_params()
    weights = jax.tree.map(np.asarray, jp.params)
    mesh = jax.jit(lambda frames: j_image_to_graph(j_posenc(frames), jp.gcfg)[0].pixel_node)
    forecast = jax.jit(jax.vmap(lambda xb: jp.eval_model.apply(jp.params, xb)))
    y_hat = np.asarray(forecast(jnp.asarray(ds.x)))
    return ds, weights, mesh, y_hat


def test_forecast_bf16_attention_matches_jax_until_a_mesh_flips(jax_run):
    """The free-running bf16 TransformerConv rollout on the JAX package's
    meshes: the encoder's must agree, and each decoder step is compared
    while the mesh it ran on (built from the previous frame) agrees; frame
    t within (t + 1) × 2e-2 on average and (t + 1) × 0.15 at most, the
    bounds of the ChebConv forecast's bf16 test (tests/test_torch_bf16.py,
    from the JAX package's own bf16-vs-f32 bounds, tests/test_bf16.py). A
    frame's bf16 differences flip cells near the threshold, so every
    sample's first frame is compared, later ones until a flip (the
    teacher-forced test below compares every frame)."""
    ds, weights, mesh, jy = jax_run
    tp = _port(weights)
    assert tp.cfg.compute_dtype == "bfloat16" and tp.gcfg.attn_windows
    y, overflow, meshes = tp.forecast(ds.x)
    assert y.dtype == torch.float32 and jy.dtype == np.float32
    assert int(overflow.max()) == 0
    compared = 0
    for b in range(len(ds.x)):
        want = [mesh(jnp.asarray(ds.x[b], jnp.bfloat16))]
        want += [mesh(jnp.asarray(jy[b, t][None], jnp.bfloat16)) for t in range(T_OUT - 1)]
        for t in range(T_OUT):
            same = np.array_equal(meshes[t, b].numpy(), np.asarray(want[t]))
            if t == 0:
                assert same, f"sample {b}: the encoder's mesh differs"
            if not same:
                break
            err = np.abs(y[b, t].numpy() - jy[b, t])
            assert err.mean() <= 2e-2 * (t + 1) and err.max() <= 0.15 * (t + 1), \
                (b, t, err.mean(), err.max())
            compared += 1
    assert compared >= len(ds.x)


def _jax_forced(weights, x, y, dtype="bfloat16"):
    """The JAX package's teacher-forced (ratio 1.0) run of the batch:
    (loss, clipped gradients as a port state_dict, frames (B, T_out, rows,
    cols, 1) f32)."""
    model = _jax_predictor(1.0, dtype).model
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}

    def sample(params, xb, yb):
        state = model.apply(params, xb, method=JSeq2Seq.encode, rngs=rngs)
        _, y_hat = model.apply(params, state, 0, T_OUT, yb, method=JSeq2Seq.decode, rngs=rngs)
        return J_LOSSES["MSE"](y_hat, yb, None), y_hat

    def batch_loss(params):
        losses, y_hat = jax.vmap(lambda xb, yb: sample(params, xb, yb))(x, y)
        return jnp.mean(losses), y_hat

    params = jax.tree.map(jnp.asarray, weights)
    (loss, y_hat), grads = jax.jit(jax.value_and_grad(batch_loss, has_aux=True))(params)
    clip = optax.clip_by_global_norm(10.0)
    grads, _ = clip.update(grads, clip.init(params))
    assert all(g.dtype == jnp.float32 for g in jax.tree.leaves(grads))
    return (float(loss), params_from_jax(jax.tree.map(np.asarray, grads)),
            np.asarray(y_hat, np.float32))


@pytest.fixture(scope="module")
def forced(jax_run):
    """The JAX package's teacher-forced run in bf16, attention and head
    dropout 0 in both packages (the registries' TransformerConv entry for
    the module's duration)."""
    ds, weights, _, _ = jax_run
    with pytest.MonkeyPatch.context() as mp:
        for registry in (jconv.CONVOLUTION_KWARGS, tconv.CONVOLUTION_KWARGS):
            mp.setitem(registry, "TransformerConv",
                       dict(registry["TransformerConv"], dropout=0.0))
        x, y = jnp.asarray(ds.x), jnp.asarray(ds.y)
        yield ds, weights, _jax_forced(weights, x, y, "bfloat16")


def test_teacher_forced_forecast_bf16_attention_matches_jax(forced):
    """The bf16 rollout with every decoder step's mesh and input built from
    the true frame (teacher forcing 1.0), so both programs run on the same
    meshes at every step: every frame t within (t + 1) × 2e-2 on average and
    (t + 1) × 0.15 at most of the JAX package's, as the free-running test."""
    ds, weights, (_, _, jy) = forced
    tp = _port(weights, tf=1.0)
    model = tp.model.train()  # dropout is 0: training mode only turns on the coins
    with torch.no_grad():
        state = model.encode(torch.from_numpy(ds.x))
        _, y, _ = model.decode(state, T_OUT, y=torch.from_numpy(ds.y), teacher_forcing_ratio=1.0,
                               generator=torch.Generator().manual_seed(0))
    assert y.dtype == torch.float32 and y.shape == jy.shape
    for t in range(T_OUT):
        err = np.abs(y[:, t].numpy() - jy[:, t])
        assert err.mean() <= 2e-2 * (t + 1) and err.max() <= 0.15 * (t + 1), \
            (t, err.mean(), err.max())


def test_train_step_bf16_attention_loss_and_grads_match_jax(forced, tmp_path):
    """A teacher-forced (1.0: every decoder mesh from the true frame, so both
    programs run on the same meshes) bf16 train step, attention and head
    dropout 0: the loss within 1e-2 relative, and every gradient leaf
    within 3e-2 × max(1, max|g|) of the JAX package's bf16 gradient, the
    bound of the ChebConv step's bf16 test (tests/test_torch_bf16.py).
    Eager PyTorch rounds every bf16 op, XLA keeps f32 inside its fusions:
    on this seed the port's bf16 gradient lies 2.8e-2 from JAX's bf16 and
    2.7e-2 from the f32 one (both packages agree within 2.3e-7 in f32),
    JAX's bf16 0.9e-2 from f32; the ChebConv step's were 2.0e-2 and
    1.2e-2."""
    ds, weights, (j_loss, j_grads, _) = forced
    tp = _port(weights, tf=1.0, run_dir=tmp_path)
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    loss, overflow = tp.train_step(ds.x, ds.y)
    assert int(overflow) == 0 and loss.dtype == torch.float32
    assert abs(float(loss) - j_loss) <= 1e-2 * abs(j_loss)
    grads = {name: p.grad for name, p in tp.model.named_parameters()}
    assert set(grads) == set(j_grads)
    assert all(g.dtype == torch.float32 for g in grads.values())
    for name, g in grads.items():
        err = float((g - j_grads[name]).abs().max())
        assert err <= 3e-2 * max(1.0, float(j_grads[name].abs().max())), (name, err)


def test_params_from_jax_keeps_attention_masters_f32(jax_run):
    """A bf16 TransformerConv model loads the JAX package's bf16 model's
    tree (float32 masters) unchanged, attention parameters included (the
    fused gate stacks' w_q/w_k/w_v/w_e/w_s, the head convs' lin_* and
    lin_edge): every parameter filled, in float32, equal to the tree's."""
    _, weights, _, _ = jax_run
    assert all(np.asarray(v).dtype == np.float32 for v in jax.tree.leaves(weights))
    tp = _port(weights)
    sd = params_from_jax(weights)
    names = [n for n, _ in tp.model.named_parameters()]
    assert any("w_e_x_0" in n for n in names) and any("lin_edge" in n for n in names)
    for name, p in tp.model.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p.detach(), sd[name]), name
    assert sum(np.asarray(v).size for v in jax.tree.leaves(weights)) == \
        sum(p.numel() for p in tp.model.parameters())


def test_bf16_attention_forecast_close_to_own_f32(jax_run):
    """The port's bf16 TransformerConv forecast against its own f32 one from
    the same weights: the first frame within 2e-2 on average, the bound of
    the ChebConv path's (chip_smoke.py phase 30); the samples whose encoder
    mesh agrees are compared (the criterion reads the bf16 frame)."""
    ds, weights, _, _ = jax_run
    ys = {}
    for dtype in ("float32", "bfloat16"):
        y, _, meshes = _port(weights, dtype=dtype).forecast(ds.x)
        ys[dtype] = (y, meshes)
    (y16, m16), (y32, m32) = ys["bfloat16"], ys["float32"]
    assert y16.dtype == torch.float32
    same = (m16[0] == m32[0]).all(dim=-1)
    assert bool(same.any())
    err = (y16[:, 0] - y32[:, 0]).abs()[same]
    assert float(err.mean()) <= 2e-2, float(err.mean())


def test_bf16_attention_train_step_keeps_f32_masters(tmp_path):
    """A bf16 TransformerConv train step with attention and head dropout on
    the CPU: finite f32 loss, f32 masters and gradients, weights moved;
    the attention runs on bf16 q, k, v and Wₑ, with f32 keep windows and
    f32 window attributes (the graph build's, from bf16 frames)."""
    ds = _dataset()
    with pytest.MonkeyPatch.context() as mp:  # the registry's dropout, whatever ran before
        mp.setitem(tconv.CONVOLUTION_KWARGS, "TransformerConv",
                   dict(tconv.CONVOLUTION_KWARGS["TransformerConv"], dropout=0.1))
        tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                                   device="cpu", run_dir=str(tmp_path),
                                   model_kwargs=dict(MODEL, compute_dtype="bfloat16",
                                                     dropout=0.1),
                                   graph_kwargs=dict(GRAPH))
    seen = []
    apply = tattn.attn_apply

    def spy(q, k, v, we, keep, meta, *rest):
        seen.append((q.dtype, we.dtype, None if keep is None else keep.dtype, meta.attr.dtype))
        return apply(q, k, v, we, keep, meta, *rest)

    before = [p.detach().clone() for p in tp.model.parameters()]
    tp.initiate_training(lr=0.01, lr_decay=0.95)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tattn, "attn_apply", spy)
        loss, _ = tp.train_step(ds.x, ds.y)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert seen and set(seen) == {(BF16, BF16, torch.float32, torch.float32)}
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in tp.model.parameters())
    assert any(not torch.equal(p, q) for p, q in zip(tp.model.parameters(), before))
