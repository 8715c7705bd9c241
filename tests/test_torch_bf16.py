"""PyTorch port vs JAX package in bf16 mixed precision
(``compute_dtype="bfloat16"``: the graph pipeline, the convolutions and the
recurrence in bf16; float32 master weights, LayerNorm statistics,
predictions and loss).

The kernels' plain versions against the JAX package's Pallas kernels in
interpret mode: K1's bf16 blocks bit for bit, the bf16 block product and
its backward within 2⁻⁷ relative (one bf16 rounding; both sum in f32), the
bf16 segment sum within 1e-2 × max(1, max|out|) of ``jax.ops.segment_sum``
(which rounds every add; the port sums in f32 and rounds once). Then a
graph build, a ChebConv GConvLSTM step with LayerNorm, the forecast on
asserted-identical meshes up to the first mesh flip, one train step's
loss (1e-2 relative) and gradients (3e-2 × max(1, max|g|)) with teacher
forcing 1.0 and dropout 0, the dtype region, and the port's bf16 forecast
against its own f32 forecast at the JAX package's bounds
(``tests/test_bf16.py``). The two packages round at some other places
(the segment sums, the sigmoid), so two bf16 programs differ by about as
much as bf16 and f32 do; each test states its tolerance and why. bf16
rounding flips quadtree cells near the threshold, and remeshing amplifies
a flip, so rollouts are compared only while their meshes agree.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models.cells import GConvLSTM as JGConvLSTM
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.ops import pallas_spmm as jspmm
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig as TGraphConfig
from quadtree_mpnnlstm_tpu_torch.config import TrainConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph as t_image_to_graph
from quadtree_mpnnlstm_tpu_torch.models.cells import GConvLSTM as TGConvLSTM
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import LayerNorm as TLayerNorm
from quadtree_mpnnlstm_tpu_torch.ops import segment_sum as tseg
from quadtree_mpnnlstm_tpu_torch.ops import spmm as tspmm
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

BF16 = torch.bfloat16
ULP = 2.0**-7  # one bf16 rounding, relative
NT, EB, SW = 128, 512, 512

SHAPE = (16, 16)
T_IN, T_OUT = 2, 3
MODEL = dict(hidden_size=8, n_layers=1, n_conv_layers=1, dropout=0.0,
             convolution_type="ChebConv")
GRAPH = dict(max_grid_size=8, n_max=256, e_max=2048, node_budget=256,
             aggregation="pallas", agg_nt=128, agg_eb=512, agg_sw=256)


def _tol(ref, rel):
    return rel * max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))


def _f32(x):
    """numpy float32 of a torch or JAX array of any float dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------- kernels


def _jax_graphs(n_max, thresh, batch=2, shape=(32, 32), seed=0):
    """Edge lists of ``batch`` JAX meshes (blobs over faint noise)."""
    cfg = JGraphConfig(image_shape=shape, max_grid_size=8, thresh=thresh,
                       n_max=n_max, e_max=8 * n_max, use_edge_attrs=False)
    rng = np.random.default_rng(seed)
    r, c = np.arange(shape[0])[:, None], np.arange(shape[1])[None, :]
    graphs = []
    for _ in range(batch):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        img = np.exp(-((r - cy) ** 2 + (c - cx) ** 2) / (2 * (shape[0] / 5) ** 2))
        img = img + 0.04 * rng.random(shape)
        graphs.append(j_image_to_graph(j_posenc(jnp.asarray(img[None, :, :, None],
                                                            jnp.float32)), cfg)[0])
    stack = lambda name: np.stack([np.asarray(getattr(g, name)) for g in graphs])
    return graphs, stack("edge_src"), stack("edge_dst"), stack("sym_coeff"), stack("n_nodes")


def _meta(n_max, thresh, seed, eb=EB, sw=SW):
    """The port's bf16 blocks and the JAX package's, on the same meshes."""
    graphs, src, dst, coeff, n_nodes = _jax_graphs(n_max, thresh, seed=seed)
    tw, ovf = tspmm.spmm_tile_meta(torch.from_numpy(src).long(), torch.from_numpy(dst).long(),
                                   torch.from_numpy(coeff), n_max, NT, eb, sw)
    meta = tspmm.spmm_build_blocks(tw, NT, sw, torch.from_numpy(n_nodes), block_dtype=BF16)
    jms = []
    for g in graphs:
        jw, _ = jspmm.spmm_tile_meta(g.edge_src, g.edge_dst, g.sym_coeff, n_max, NT, eb, sw)
        jms.append(jspmm.spmm_build_blocks(jw, NT, eb, sw, n_nodes=g.n_nodes,
                                           block_dtype=jnp.bfloat16))
    return meta, jms, ovf


@pytest.mark.parametrize("n_max,thresh", [(512, 0.1), (1024, 0.05)])
def test_build_blocks_bf16_bit_identical(n_max, thresh):
    meta, jms, _ = _meta(n_max, thresh, seed=0)
    assert meta.blocks.dtype == BF16
    for b, jm in enumerate(jms):
        assert jm.blocks.dtype == jnp.bfloat16
        np.testing.assert_array_equal(meta.blocks[b].view(torch.int16).numpy(),
                                      np.asarray(jm.blocks).view(np.int16))


@pytest.mark.parametrize("n_max,thresh,f", [(1024, 0.3, 20), (1024, 0.1, 17), (768, 0.1, 128)])
def test_apply_bf16_forward_and_grad_match_jax(n_max, thresh, f):
    meta, jms, _ = _meta(n_max, thresh, seed=f, eb=1024, sw=1024)
    rng = np.random.default_rng(f)
    z = torch.from_numpy(rng.standard_normal((2, n_max, f)).astype(np.float32)).to(BF16)
    g = torch.from_numpy(rng.standard_normal((2, n_max, f)).astype(np.float32)).to(BF16)
    zt = z.clone().requires_grad_(True)
    out = tspmm.spmm_apply(zt, meta, n_max, NT, 1024)
    (dz,) = torch.autograd.grad(out, zt, g)
    assert out.dtype == dz.dtype == BF16
    for b, jm in enumerate(jms):
        zb, gb = jnp.asarray(_f32(z[b]), jnp.bfloat16), jnp.asarray(_f32(g[b]), jnp.bfloat16)
        ref, vjp = jax.vjp(lambda zz: jspmm.spmm_apply(zz, jm, n_max, NT, 1024), zb)
        (dref,) = vjp(gb)
        assert ref.dtype == dref.dtype == jnp.bfloat16
        assert np.abs(_f32(out[b]) - _f32(ref)).max() <= _tol(_f32(ref), ULP)
        assert np.abs(_f32(dz[b]) - _f32(dref)).max() <= _tol(_f32(dref), ULP)


def test_apply_plain_bf16_rounds_an_f32_product_once():
    """The plain bf16 product equals the f32 product of the same bf16
    operands, rounded once to bf16."""
    meta, _, _ = _meta(512, 0.1, seed=4)
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 512, 24))
                         .astype(np.float32)).to(BF16)
    out = tspmm.apply_plain(z, meta.s0, meta.blocks, meta.live, 512, NT, SW)
    ref = tspmm.apply_plain(z.float(), meta.s0, meta.blocks.float(), meta.live, 512, NT, SW)
    assert out.dtype == BF16
    assert torch.equal(out, ref.to(BF16))


@pytest.mark.parametrize("f,sorted_ids", [(1, True), (3, False), (16, False), (33, True)])
def test_segment_sum_bf16_matches_jax(f, sorted_ids):
    """Against ``jax.ops.segment_sum`` on bf16 values, which rounds at every
    add (about 4 entries a bucket here), and against the exact sum: the
    port's f32 sum is rounded once, so it lies within half a bf16 ulp."""
    rng = np.random.default_rng(f)
    b, length, n_out = 2, 600, 150
    ids = rng.integers(0, n_out + 10, (b, length))  # ids >= n_out are dropped
    if sorted_ids:
        ids = np.sort(ids, axis=1)
    vals = torch.from_numpy(rng.standard_normal((b, length, f)).astype(np.float32)).to(BF16)
    out = tseg.segment_sum(vals, torch.from_numpy(ids), n_out)
    assert out.dtype == BF16 and out.shape == (b, n_out, f)
    for i in range(b):
        ref = jax.ops.segment_sum(jnp.asarray(_f32(vals[i]), jnp.bfloat16),
                                  jnp.asarray(np.minimum(ids[i], n_out)), n_out + 1)[:n_out]
        assert np.abs(_f32(out[i]) - _f32(ref)).max() <= _tol(_f32(out[i]), 1e-2)
        exact = np.zeros((n_out + 10, f))
        np.add.at(exact, ids[i], _f32(vals[i]).astype(np.float64))
        assert (np.abs(_f32(out[i]) - exact[:n_out]) <= 2.0**-8 * np.abs(exact[:n_out])).all()


def test_segment_sum_bf16_accumulates_in_f32():
    """300 ones in one bucket: an accumulator in bf16 stalls at 256 (257
    is not a bf16 number), the port's f32 one reaches 300 (which is)."""
    vals = torch.ones((1, 300, 2), dtype=BF16)
    ids = torch.zeros((1, 300), dtype=torch.int64)
    out = tseg.segment_sum_plain(vals, ids, 1)
    assert out.dtype == BF16 and out.flatten().tolist() == [300.0, 300.0]


def test_cpu_bf16_tensors_never_launch_kernels():
    tspmm.reset_launch_counts()
    tseg.reset_launch_counts()
    meta, _, _ = _meta(256, 0.3, seed=1)
    tspmm.spmm_apply(torch.zeros(2, 256, 4, dtype=BF16), meta, 256, NT, SW)
    tseg.segment_sum(torch.zeros(2, 10, 3, dtype=BF16), torch.zeros(2, 10, dtype=torch.int64), 4)
    assert set(tspmm.LAUNCHES.values()) == {0} and tseg.LAUNCHES["segment_sum"] == 0


@pytest.mark.parametrize("f", [16, 17, 20, 32, 64, 65, 128, 129, 300])
def test_apply_plan_bf16_covers_columns_and_features(f):
    """K2's bf16 plan: a warp reads 256 columns at once (8 a lane, 16
    bytes), in ascending order over [0, SW); the features a lane keeps are
    f32's (1, 2, 4 or 8), and F ≤ 256 takes one pass over the row."""
    plan = tspmm.apply_plan(128, 1024, f, 2)
    cols = np.concatenate([np.arange(c0, c1) for c0, c1 in plan.col_chunks])
    assert np.array_equal(cols, np.arange(1024))
    assert all(c1 - c0 == 8 * 32 for c0, c1 in plan.col_chunks)
    feats = np.concatenate([np.arange(f0, f1) for f0, f1 in plan.f_chunks])
    assert np.array_equal(feats, np.arange(f))
    assert all(f1 - f0 <= 32 * plan.fpl for f0, f1 in plan.f_chunks)
    assert (len(plan.f_chunks) == 1) == (f <= 256)
    assert plan.fpl == tspmm.apply_plan(128, 1024, f).fpl


# ---------------------------------------------------------------- cell


@pytest.fixture(scope="module")
def bf16_meshes():
    """bf16 meshes of two frames, built by each package from the same bf16
    image (the port's: one batched build; the JAX package's: one each)."""
    kw = dict(image_shape=(32, 32), max_grid_size=8, thresh=0.2, use_edge_attrs=False,
              n_max=512, e_max=4096, aggregation="pallas", agg_nt=128, agg_eb=512, agg_sw=512)
    img = (np.random.default_rng(0).random((2, 1, 32, 32, 1)) ** 4).astype(np.float32)
    tg, tdata = t_image_to_graph(t_posenc(torch.from_numpy(img).to(BF16)), TGraphConfig(**kw))
    js = [j_image_to_graph(j_posenc(jnp.asarray(img[b], jnp.bfloat16)), JGraphConfig(**kw))
          for b in range(2)]
    return tg, tdata, js


def test_graph_build_bf16_close_to_jax(bf16_meshes):
    """The same quadtree (the criterion is taken in f32 from the bf16
    image); pooled node features and Â blocks in bf16. The port sums the
    pooling and the degrees in f32 and rounds once, the JAX package in bf16
    at every add, so the pooled features differ by at most a bf16 ulp of
    their sums (2⁻⁷ relative) and the Â entries (≤ 1) by a few ulps of the
    degrees they are normalised by."""
    tg, tdata, js = bf16_meshes
    assert tdata.dtype == tg.agg_meta.blocks.dtype == BF16
    for b, (jg, jdata) in enumerate(js):
        assert jdata.dtype == jg.agg_meta.blocks.dtype == jnp.bfloat16
        np.testing.assert_array_equal(tg.pixel_node[b].numpy(), np.asarray(jg.pixel_node))
        np.testing.assert_array_equal(tg.counts[b].numpy(), np.asarray(jg.counts))
        np.testing.assert_array_equal(tg.agg_meta.live[b].numpy(), np.asarray(jg.agg_meta.live)[0])
        ref = _f32(jdata)
        assert np.abs(_f32(tdata[b]) - ref).max() <= _tol(ref, ULP)
        assert np.abs(_f32(tg.agg_meta.blocks[b]) - _f32(jg.agg_meta.blocks)).max() <= 2.0**-6


def test_gconvlstm_step_with_layernorm_bf16_matches_jax(bf16_meshes):
    """One ChebConv GConvLSTM step and the LayerNorm after it, in bf16 on
    the same Â (the JAX package's bf16 blocks in the port's graph): the
    output gate within 1e-2 × max(1, max|ref|), the normalised H and C
    within 2e-2 × max(1, max|ref|). The fused gate stack agrees bit for
    bit on the same Â; the gates' sigmoid does not: XLA lowers a bf16
    logistic to 1/(1 + exp(−x)) rounded to bf16 after each op, torch
    rounds the f32 sigmoid once, so a gate may differ by a bf16 ulp, which
    LayerNorm divides by the row's spread (2.5 ulps of |C| ≈ 3 seen)."""
    import flax.linen as fnn

    tg, _, js = bf16_meshes
    tg = tg.replace(agg_meta=tg.agg_meta._replace(blocks=torch.stack(
        [torch.tensor(_f32(jg.agg_meta.blocks)) for jg, _ in js]).to(BF16)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 512, 4)).astype(np.float32)
    h, c = (0.5 * rng.standard_normal((2, 2, 512, 8))).astype(np.float32)
    jcell = JGConvLSTM(out_channels=8, n_conv_layers=2, convolution_type="ChebConv",
                       dtype=jnp.bfloat16)
    params = jax.tree.map(np.array, jcell.init(jax.random.PRNGKey(7), jnp.asarray(x[0]),
                                               js[0][0], jnp.asarray(h[0]), jnp.asarray(c[0])))
    for name in ("w_c_i", "w_c_f", "w_c_o", "b_i", "b_f", "b_c", "b_o"):  # init zeroes them
        params["params"][name] = (0.3 * rng.standard_normal((1, 8))).astype(np.float32)
    jnorm = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
    nparams = {"params": {"scale": (1 + 0.2 * rng.standard_normal(8)).astype(np.float32),
                          "bias": (0.1 * rng.standard_normal(8)).astype(np.float32)}}
    tcell = TGConvLSTM(4, 8, n_conv_layers=2, dtype=BF16)
    tcell.load_state_dict(state_dict_from_flax(params["params"]))
    tnorm = TLayerNorm(8)
    tnorm.load_state_dict({"weight": torch.from_numpy(nparams["params"]["scale"]),
                           "bias": torch.from_numpy(nparams["params"]["bias"])})
    with torch.no_grad():
        o, hn, cn = tcell(torch.from_numpy(x).to(BF16), tg, torch.from_numpy(h).to(BF16),
                          torch.from_numpy(c).to(BF16))
        outs = (o, tnorm(hn), tnorm(cn))
    assert all(t.dtype == BF16 for t in outs)
    for b, (jg, _) in enumerate(js):
        jo, jh, jc = jcell.apply(params, jnp.asarray(x[b], jnp.bfloat16), jg,
                                 jnp.asarray(h[b], jnp.bfloat16), jnp.asarray(c[b], jnp.bfloat16))
        refs = (jo, jnorm.apply(nparams, jh), jnorm.apply(nparams, jc))
        assert refs[1].dtype == jnp.bfloat16
        for out, ref in zip(outs, refs):
            err = np.abs(_f32(out[b]) - _f32(ref)).max()
            assert err <= _tol(_f32(ref), 1e-2 if out is o else 2e-2)


def test_layernorm_bf16_statistics_are_f32():
    """Rows of near-constant bf16 state: the statistics in f32, as flax's,
    normalise them to the f32 LayerNorm's values rounded once; bf16
    statistics would not."""
    x = (1.0 + 2.0**-6 * torch.arange(16, dtype=torch.float32).remainder(3))[None].to(BF16)
    norm = TLayerNorm(16)
    out = norm(x)
    assert out.dtype == BF16
    assert torch.equal(out, norm(x.float()).to(BF16))


# ---------------------------------------------------------------- model


def _dataset():
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    return ModMovingMNISTDataset(2, T_IN, T_OUT, canvas_size=SHAPE, digit_size=(8, 8),
                                 pixel_noise=0.02, velocity_noise=0.0, seed=1)


def _jax_predictor(tf=0.0):
    return JPredictor(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                      teacher_forcing_ratio=tf,
                      model_kwargs=dict(MODEL, compute_dtype="bfloat16", remat=False),
                      graph_kwargs=dict(GRAPH))


def _port(weights=None, tf=0.0, run_dir="runs", **kw):
    tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", teacher_forcing_ratio=tf, run_dir=str(run_dir),
                               model_kwargs=dict(MODEL), graph_kwargs=dict(GRAPH), **kw)
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


def test_forecast_bf16_matches_jax_until_a_mesh_flips(jax_run):
    """The rollout on the JAX package's meshes: the encoder's and the one
    built from the first decoder step's frame must agree, later steps are
    compared up to the first flip. The first frame within 2e-2 of the JAX
    package's bf16 frame on average and within 0.15 everywhere (the JAX
    package's own bound for bf16 against f32, ``tests/test_bf16.py``): two
    bf16 programs that round at other places differ by about as much as
    bf16 and f32 do (on this seed, port against JAX bf16 0.066 max, 0.013
    mean; the JAX package's bf16 against its f32 0.042 max, 0.011 mean).
    That error compounds through the rollout (the JAX package's bf16
    against its f32: 0.027 mean, 0.082 max at step 1; 0.040, 0.136 at step
    2), so frame t is held within (t + 1) times those bounds."""
    ds, weights, mesh, jy = jax_run
    tp = _port(weights, train_config=TrainConfig(dtype="bfloat16"))
    assert tp.cfg.compute_dtype == "bfloat16"
    y, overflow, meshes = tp.forecast(ds.x)
    assert y.dtype == torch.float32 and jy.dtype == np.float32
    assert int(overflow.max()) == 0
    compared = 0
    for b in range(len(ds.x)):
        # the mesh of each step: the encoder's, then the one built from the
        # JAX package's previous bf16 frame
        want = [mesh(jnp.asarray(ds.x[b], jnp.bfloat16))]
        want += [mesh(jnp.asarray(jy[b, t][None], jnp.bfloat16)) for t in range(T_OUT - 1)]
        for t in range(T_OUT):
            same = np.array_equal(meshes[t, b].numpy(), np.asarray(want[t]))
            if t <= 1:
                assert same, f"sample {b}: the mesh of decoder step {t} flipped"
            if not same:
                break
            err = np.abs(y[b, t].numpy() - jy[b, t])
            assert err.mean() <= 2e-2 * (t + 1) and err.max() <= 0.15 * (t + 1), \
                (b, t, err.mean(), err.max())
            compared += 1
    assert compared >= 2 * len(ds.x)


def _jax_loss_and_grad(weights, x, y):
    model = _jax_predictor(1.0).model
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
    assert all(g.dtype == jnp.float32 for g in jax.tree.leaves(grads))
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def test_train_step_bf16_loss_and_grads_match_jax(jax_run, tmp_path):
    """Teacher forcing 1.0 builds every decoder mesh from the true frame,
    so both programs run on the same meshes; dropout 0."""
    ds, weights, _, _ = jax_run
    j_loss, j_grads = _jax_loss_and_grad(weights, jnp.asarray(ds.x), jnp.asarray(ds.y))
    tp = _port(weights, tf=1.0, run_dir=tmp_path,
               train_config=TrainConfig(dtype="bfloat16"))
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    loss, overflow = tp.train_step(ds.x, ds.y)
    assert int(overflow) == 0 and loss.dtype == torch.float32
    assert abs(float(loss) - j_loss) <= 1e-2 * abs(j_loss)
    grads = {name: p.grad for name, p in tp.model.named_parameters()}
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        ref = j_grads[name]
        err = float((g - ref).abs().max())
        assert err <= 3e-2 * max(1.0, float(ref.abs().max())), (name, err)


def test_bf16_region_and_f32_outputs(tmp_path):
    """As the JAX package's ``test_bf16_region_and_f32_outputs``: bf16
    state inside the model, float32 predictions out, float32 masters
    before and after an Adam step, float32 gradients and loss."""
    ds = _dataset()
    tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", run_dir=str(tmp_path),
                               model_kwargs=dict(MODEL, compute_dtype="bfloat16", dropout=0.1),
                               graph_kwargs=dict(GRAPH))
    model = tp.model
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        state = model.encode(torch.from_numpy(ds.x))
        assert state.x.dtype == BF16
        assert all(h.dtype == BF16 for h in state.hidden + state.cell)
        assert state.graph.agg_meta.blocks.dtype == BF16
        y_hat = model(torch.from_numpy(ds.x))
    assert y_hat.dtype == torch.float32 and torch.isfinite(y_hat).all()
    before = [p.detach().clone() for p in model.parameters()]
    tp.initiate_training(lr=0.01, lr_decay=0.95)
    loss, _ = tp.train_step(ds.x, ds.y)  # dropout 0.1 in training mode
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())
    assert any(not torch.equal(p, q) for p, q in zip(model.parameters(), before))


def test_bf16_train_entry_and_score(tmp_path):
    """``train()`` and ``score()`` with ``TrainConfig(dtype="bfloat16")``:
    one epoch, finite losses, float32 masters after it."""
    from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader

    ds = _dataset()
    tp = _port(run_dir=tmp_path, train_config=TrainConfig(dtype="bfloat16", n_epochs=1))
    assert tp.cfg.compute_dtype == "bfloat16"
    tp.train(DataLoader(ds, batch_size=2), DataLoader(ds, batch_size=2))
    assert np.isfinite(tp.loss["train_loss"] + tp.loss["test_loss"]).all()
    assert np.isfinite(tp.score(DataLoader(ds, batch_size=2))["MSE"])
    assert all(p.dtype == torch.float32 for p in tp.model.parameters())


def test_params_from_jax_keeps_f32_masters(jax_run):
    """A bf16 model loads the JAX package's bf16 model's tree (float32
    masters, as flax keeps them) unchanged: every parameter filled, in
    float32, equal to the tree's values."""
    _, weights, _, _ = jax_run
    assert all(np.asarray(v).dtype == np.float32 for v in jax.tree.leaves(weights))
    tp = _port(weights, train_config=TrainConfig(dtype="bfloat16"))
    assert tp.cfg.compute_dtype == "bfloat16"
    sd = params_from_jax(weights)
    for name, p in tp.model.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p.detach(), sd[name]), name
    assert sum(np.asarray(v).size for v in jax.tree.leaves(weights)) == \
        sum(p.numel() for p in tp.model.parameters())


def test_bf16_forecast_close_to_own_f32():
    """The port's bf16 forecast against its own f32 forecast, in the JAX
    package's setting for the same comparison
    (``tests/test_bf16.py::test_bf16_close_to_f32``: 16×16, base cells of
    4, thresh 0.1, hidden 8, the flax init from PRNGKey(0), uniform noise
    inputs) and at its bounds: max 0.15, mean 0.03."""
    from quadtree_mpnnlstm_tpu.config import ModelConfig as JModelConfig
    from quadtree_mpnnlstm_tpu_torch.config import ModelConfig as TModelConfig
    from quadtree_mpnnlstm_tpu_torch.models.seq2seq import Seq2Seq as TSeq2Seq

    model = dict(hidden_size=8, input_features=1, input_timesteps=2, output_timesteps=3,
                 n_layers=1, n_conv_layers=1, convolution_type="ChebConv", dropout=0.0)
    graph = dict(image_shape=SHAPE, max_grid_size=4, thresh=0.1)
    x = np.random.default_rng(1).random((2, *SHAPE, 1)).astype(np.float32)
    params = JSeq2Seq(JModelConfig(**model), JGraphConfig(**graph)).init(
        jax.random.PRNGKey(0), jnp.asarray(x))
    ys = {}
    for dtype in ("float32", "bfloat16"):
        tm = TSeq2Seq(TModelConfig(**model, compute_dtype=dtype), TGraphConfig(**graph))
        tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
        with torch.no_grad():
            ys[dtype] = tm.eval()(torch.from_numpy(x)[None])[0].numpy()
    assert ys["bfloat16"].dtype == np.float32
    diff = np.abs(ys["float32"] - ys["bfloat16"])
    assert diff.max() < 0.15 and diff.mean() < 0.03, (diff.max(), diff.mean())
