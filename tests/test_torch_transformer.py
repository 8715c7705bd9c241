"""PyTorch port vs JAX package: the TransformerConv slice on attention
windows — the 2-column edge attributes, ``TransformerConv``,
``FusedAttnGateStack``, ``GConvLSTM`` with attention gates (≤1e-5, weights
carried over) and a ``predict`` rollout with a remesh at every step
(≤1e-4 per pixel, on meshes asserted identical first). The Pallas kernels
run in interpret mode on the CPU; the port runs its plain versions. Then
port-only cases: the attention dropout windows, eval determinism, the
predictor's configuration and the options still rejected."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.data.loader import ArrayDataset as JArrayDataset
from quadtree_mpnnlstm_tpu.data.loader import DataLoader as JDataLoader
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models.cells import GConvLSTM as JGConvLSTM
from quadtree_mpnnlstm_tpu.models.conv import TransformerConv as JTransformerConv
from quadtree_mpnnlstm_tpu.models.fused import FusedAttnGateStack as JFusedAttn
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig as TGraphConfig
from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader
from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph as t_image_to_graph
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.models.cells import GConvLSTM as TGConvLSTM
from quadtree_mpnnlstm_tpu_torch.models.fused import FusedAttnGateStack as TFusedAttn
from quadtree_mpnnlstm_tpu_torch.ops import attn as tattn
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from quadtree_mpnnlstm_tpu_torch.utils.weights import state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

N_MAX = 512
BATCH = 2
MESH = dict(image_shape=(32, 32), max_grid_size=8, thresh=0.2, n_max=N_MAX, e_max=4096,
            aggregation="pallas", attn_windows=True, agg_nt=128, agg_eb=1024, agg_sw=512)


def _blobs(seed):
    """(BATCH, 1, 32, 32, 1) frames, a blob plus faint noise each: refined
    near the blob (487 and 274 nodes; the second mesh has a dead tile)."""
    rng = np.random.default_rng(seed)
    r, c = np.arange(32)[:, None], np.arange(32)[None, :]
    frames = []
    for _ in range(BATCH):
        cy, cx = rng.uniform(0, 32), rng.uniform(0, 32)
        blob = np.exp(-((r - cy) ** 2 + (c - cx) ** 2) / (2 * (32 / 5) ** 2))
        frames.append(blob + 0.02 * rng.random((32, 32)))
    return np.stack(frames)[:, None, :, :, None].astype(np.float32)


@pytest.fixture(scope="module")
def meshes():
    x = _blobs(0)
    tg, _ = t_image_to_graph(t_posenc(torch.from_numpy(x)), TGraphConfig(**MESH))
    jgs = [j_image_to_graph(j_posenc(jnp.asarray(x[b])), JGraphConfig(**MESH))[0]
           for b in range(BATCH)]
    assert tg.agg[0] == "pallas_attn" and int(tg.overflow.max()) == 0
    assert int(tg.attn_meta.live.min()) < tg.attn_meta.s0.shape[1]  # a dead tile
    return tg, jgs


def test_fixture_meshes_are_pinned(meshes):
    """The fixture's meshes, pinned: 487 and 274 nodes, 1969 and 1102
    edges in both packages, and every port edge distance the correctly
    rounded f32 square root of its node positions' squared offset
    (numpy). Another mesh or a misrounded distance fails here, by name,
    and not as parity misses of every test on the fixture."""
    tg, jgs = meshes
    assert tg.n_nodes.tolist() == [487, 274] and tg.n_edges.tolist() == [1969, 1102]
    assert [int(jg.n_nodes) for jg in jgs] == [487, 274]
    assert [int(jg.n_edges) for jg in jgs] == [1969, 1102]
    xy = np.concatenate([tg.node_xy.numpy(), np.zeros((BATCH, 1, 2), np.float32)], axis=1)
    src, dst = tg.edge_src.numpy(), tg.edge_dst.numpy()
    for b in range(BATCH):
        dx, dy = (xy[b, src[b], k] - xy[b, dst[b], k] for k in (0, 1))
        dist = np.where(tg.edge_valid[b].numpy(), np.sqrt(dx * dx + dy * dy), np.float32(0))
        assert dist.dtype == np.float32
        np.testing.assert_array_equal(tg.edge_attr[b, :, 1].numpy(), dist)


def test_edge_attributes_match_jax(meshes):
    """The (bearing, distance) columns and the windows built from them:
    node positions and distances bit for bit; the bearing (in [0, 1))
    within 2⁻²³, one f32 ulp of 1, because torch's ``atan2`` and XLA's
    differ in the last bits on a few angles."""
    tg, jgs = meshes
    assert tg.edge_attr.shape[-1] == 2 and tg.sym_coeff is not None  # edges carried
    for b, jg in enumerate(jgs):
        np.testing.assert_array_equal(tg.node_xy[b].numpy(), np.asarray(jg.node_xy))
        for mine, ref in ((tg.edge_attr[b].numpy(), np.asarray(jg.edge_attr)),
                          (tg.attn_meta.attr[b].numpy(),
                           np.asarray(jg.attn_meta.attr_t).transpose(0, 2, 1))):
            np.testing.assert_array_equal(mine[..., 1], ref[..., 1])
            np.testing.assert_allclose(mine[..., 0], ref[..., 0], rtol=0, atol=2.0**-23)


def test_attention_window_misses_count_into_overflow():
    """With windows too small for the mesh, the graph build adds the
    attention-window misses to ``overflow``, as the JAX package does."""
    kw = dict(MESH, agg_nt=64, agg_eb=128, agg_sw=64)
    x = _blobs(0)
    tg, _ = t_image_to_graph(t_posenc(torch.from_numpy(x)), TGraphConfig(**kw))
    _, window_ovf = tattn.attn_tile_meta(tg.edge_src, tg.edge_dst, tg.edge_attr, N_MAX, 64, 128,
                                         64, tg.n_nodes)
    assert (window_ovf > 0).all() and torch.equal(tg.overflow, window_ovf)
    for b in range(BATCH):
        jg = j_image_to_graph(j_posenc(jnp.asarray(x[b])), JGraphConfig(**kw))[0]
        assert int(tg.overflow[b]) == int(jg.overflow)


@pytest.mark.parametrize("windows", ["fixture", "misses"])
def test_slot_view_is_a_stable_sort_of_the_slot_sources(meshes, windows):
    """K4's source-sorted slot view (``attn.slot_view``) equals a numpy
    stable argsort of every slot's source node, per sample, with the slots
    that carry no dk/dv dropped: dead slots, slots of dead tiles (the
    fixture's second mesh has a dead tile) and sources outside the window
    (the too-small windows of ``misses`` have them)."""
    nt, eb, sw = (128, 1024, 512) if windows == "fixture" else (64, 128, 64)
    if windows == "fixture":
        meta = meshes[0].attn_meta
    else:
        tg = meshes[0]
        meta, ovf = tattn.attn_tile_meta(tg.edge_src, tg.edge_dst, tg.edge_attr, N_MAX, nt, eb,
                                         sw, tg.n_nodes)
        assert (ovf > 0).all()
    view = tattn.slot_view(meta, tattn.AttnDims(N_MAX, nt, eb, sw, 1, 1))
    s0, src_rel, dst_rel, live = (x.numpy().astype(np.int64)
                                  for x in (meta.s0, meta.src_rel, meta.dst_rel, meta.live))
    t = np.arange(s0.shape[1])[:, None]
    length = s0.shape[1] * eb
    dropped = 0
    for b in range(BATCH):
        src = s0[b][:, None] + src_rel[b]
        keep = ((dst_rel[b] >= 0) & (t < live[b]) & (t * nt + dst_rel[b] < N_MAX)
                & (src_rel[b] >= 0) & (src_rel[b] < sw) & (src < N_MAX)).reshape(-1)
        src = np.where(keep, src.reshape(-1), N_MAX)
        order = np.argsort(src, kind="stable")[:keep.sum()]
        offsets = np.searchsorted(src[order], np.arange(N_MAX + 1))
        lo, hi = view.offsets[b, 0].item(), view.offsets[b, -1].item()
        np.testing.assert_array_equal(view.order[lo:hi].numpy() - b * length, order)
        np.testing.assert_array_equal(view.offsets[b].numpy() - b * length, offsets)
        dropped += int((~keep & (dst_rel[b] >= 0).reshape(-1)).sum())
    assert (dropped > 0) == (windows == "misses")  # out-of-window sources


@pytest.mark.parametrize("heads,d,dropout", [(8, 16, True), (1, 16, False), (1, 1, True),
                                             (3, 8, True)])
def test_k4_combine_plain_path_matches_the_autograd_backward(meshes, heads, d, dropout):
    """K4's two kernels written out in plain PyTorch: dq, the per-slot
    scalars and dWₑ (``attn_bwd_slots_plain``), then dk and dv gathered per
    source from those scalars (``attn_combine_plain``), equal autograd
    through ``attn_plain`` (``attn_bwd_plain``, the reference K4 is held
    to) within 1e-5 × max(1, max|grad|), with and without numpy keep
    windows."""
    meta = meshes[0].attn_meta
    dims = tattn.AttnDims(N_MAX, 128, 1024, 512, heads, d)
    rng = np.random.default_rng(heads * d)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((BATCH, N_MAX, heads * d))
                                   .astype(np.float32)) for _ in range(4))
    we = torch.from_numpy(rng.standard_normal((2, heads * d)).astype(np.float32))
    keep = None
    if dropout:
        shape = (BATCH, meta.s0.shape[1], heads, 1024)
        keep = torch.from_numpy(((rng.random(shape) < 0.9) / 0.9).astype(np.float32))
    dq, dlog, used, dwe = tattn.attn_bwd_slots_plain(q, k, v, we, keep, meta, dims, g)
    dk, dv = tattn.attn_combine_plain(dlog, used, q, g, meta, dims)
    ref = tattn.attn_bwd_plain(q, k, v, we, keep, meta, dims, g)
    for name, mine, want in zip(("dq", "dk", "dv", "dwe"), (dq, dk, dv, dwe), ref):
        err = float((mine - want).abs().max())
        assert err <= 1e-5 * max(1.0, float(want.abs().max())), (name, err)


def _feats(seed, width, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((BATCH, N_MAX, width))).astype(np.float32)


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


@pytest.mark.parametrize("fin,fout,heads,concat,edge_dim", [
    (17, 16, 1, False, 2), (16, 1, 1, False, 2), (8, 4, 3, True, 2), (8, 4, 1, True, None)])
def test_transformer_conv_matches_jax(meshes, fin, fout, heads, concat, edge_dim):
    tg, jgs = meshes
    x = _feats(fin, fin)
    kw = dict(heads=heads, concat=concat, dropout=0.1, edge_dim=edge_dim)
    jmod = JTransformerConv(out_channels=fout, **kw)
    params = _nonzero_biases(_flax_params(jmod, 1, jnp.asarray(x[0]), jgs[0]), 2)
    tmod = tconv.TransformerConv(fin, fout, **kw).eval()
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), tg).numpy()
    for b, jg in enumerate(jgs):
        ref = jmod.apply(params, jnp.asarray(x[b]), jg)
        np.testing.assert_allclose(out[b], np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("fx,fh,d,layers", [(4, 8, 8, 2), (4, 16, 16, 2), (8, 8, 8, 1)])
def test_fused_attn_gate_stack_matches_jax(meshes, fx, fh, d, layers):
    tg, jgs = meshes
    x, h = _feats(1, fx), _feats(2, fh, 0.5)
    jmod = JFusedAttn("TransformerConv", d, n_layers=layers)
    params = _nonzero_biases(
        _flax_params(jmod, 3, jnp.asarray(x[0]), jnp.asarray(h[0]), jgs[0]), 4)
    tmod = TFusedAttn(fx, fh, d, n_layers=layers).eval()
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), torch.from_numpy(h), tg).numpy()  # (g, B, N, d)
    for b, jg in enumerate(jgs):
        ref = jmod.apply(params, jnp.asarray(x[b]), jnp.asarray(h[b]), jg)
        np.testing.assert_allclose(out[:, b], np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("fx,d,layers", [(4, 8, 2), (8, 8, 1)])
def test_gconvlstm_with_attention_gates_matches_jax(meshes, fx, d, layers):
    tg, jgs = meshes
    x, h, c = _feats(4, fx), _feats(5, d, 0.5), _feats(6, d, 0.5)
    jcell = JGConvLSTM(out_channels=d, n_conv_layers=layers, convolution_type="TransformerConv")
    params = _flax_params(jcell, 7, jnp.asarray(x[0]), jgs[0], jnp.asarray(h[0]),
                          jnp.asarray(c[0]))
    params = _nonzero_biases(params, 8)
    tcell = TGConvLSTM(fx, d, n_conv_layers=layers, convolution_type="TransformerConv").eval()
    tcell.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        outs = tcell(torch.from_numpy(x), tg, torch.from_numpy(h), torch.from_numpy(c))
    for b, jg in enumerate(jgs):
        refs = jcell.apply(params, jnp.asarray(x[b]), jg, jnp.asarray(h[b]), jnp.asarray(c[b]))
        for out, ref in zip(outs, refs):
            np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), atol=1e-5)


# ------------------------------------------------------------ predict

SHAPE = (32, 32)
MODEL = dict(hidden_size=8, n_layers=2, n_conv_layers=2, convolution_type="TransformerConv")
GRAPH = dict(max_grid_size=8, n_max=1024, e_max=8192, node_budget=1024,
             aggregation="pallas", agg_nt=128, agg_eb=1024, agg_sw=512)


def _port(**kw):
    return NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=3, output_timesteps=3,
                                 device="cpu", model_kwargs=dict(MODEL),
                                 graph_kwargs=dict(GRAPH), **kw)


@pytest.fixture(scope="module")
def run():
    ds = ModMovingMNISTDataset(2, 3, 3, canvas_size=SHAPE, digit_size=(12, 12),
                               pixel_noise=0.02, velocity_noise=0.0, seed=3)
    jp = JPredictor(SHAPE, 0.1, input_timesteps=3, output_timesteps=3,
                    model_kwargs=dict(MODEL), graph_kwargs=dict(GRAPH))
    jp._ensure_params()
    jout = jp.predict(JDataLoader(JArrayDataset(ds.x, ds.y, ds.launch_dates), batch_size=2))
    tp = _port()
    tp.load_jax_params(jax.tree.map(np.asarray, jp.params))
    y_hat, overflow, meshes = tp.forecast(ds.x)
    return ds, jp, tp, jout, y_hat.numpy(), overflow, meshes


def test_predict_matches_jax_on_identical_meshes(run):
    ds, jp, _, jout, tout, overflow, meshes = run
    mesh = jax.jit(lambda frames: j_image_to_graph(j_posenc(frames), jp.gcfg)[0].pixel_node)
    for b in range(len(ds.x)):
        want = [mesh(jnp.asarray(ds.x[b]))] + [mesh(jnp.asarray(f[None])) for f in jout[b, :-1]]
        for t in range(3):
            np.testing.assert_array_equal(meshes[t, b].numpy(), np.asarray(want[t]),
                                          err_msg=f"sample {b}, decoder step {t}")
    assert int(overflow.max()) == 0
    assert tout.shape == jout.shape == (2, 3, *SHAPE, 1) and np.isfinite(tout).all()
    np.testing.assert_allclose(tout, jout, atol=1e-4)


def test_predictor_configures_attention_windows_as_jax(run):
    _, jp, tp, _, _, _, _ = run
    assert tp.gcfg.attn_windows is jp.gcfg.attn_windows is True
    assert tp.gcfg.carry_edges is jp.gcfg.carry_edges is False
    assert tp.gcfg.use_edge_attrs is jp.gcfg.use_edge_attrs is True
    n_jax = sum(np.asarray(v).size for v in jax.tree.leaves(jp.params))
    assert n_jax == sum(p.numel() for p in tp.model.parameters())


def test_seeded_init_covers_attention_parameters(run):
    """Every glorot tensor of the port's own init stays inside the flax
    bound for its shape (fan over the last two axes); biases are zero."""
    _, jp, _, _, _, _, _ = run
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jp.params)[0]}
    sd = _port(seed=5).model.state_dict()
    for path, v in flat.items():
        parts = path.split("/")
        key = ".".join([{"enc": "encoder", "dec": "decoder"}[parts[1]]]
                       + [{"kernel": "weight", "scale": "weight"}.get(x, x) for x in parts[3:]])
        mine = sd[key].numpy()
        if parts[-1] == "kernel":
            mine = mine.T
        assert mine.shape == v.shape, key
        if np.all(v == v.flat[0]):
            np.testing.assert_array_equal(mine, v)
        else:
            limit = np.sqrt(6.0 / (v.shape[-2] + v.shape[-1]))
            assert np.abs(mine).max() <= limit and np.abs(mine).max() > 0.5 * limit, key


# ------------------------------------------------------------ port only


def test_attention_keep_windows_come_from_the_generator(meshes, monkeypatch):
    """In training mode every attention call draws a (B, T, heads, EB) keep
    window from the generator: about 10 % zeros, the rest 1/0.9; the same
    seed gives the same windows. Eval mode draws none."""
    tg, _ = meshes
    seen = []
    real = tattn.attn_apply
    monkeypatch.setattr(tattn, "attn_apply", lambda *a: seen.append(a[4]) or real(*a))
    q = torch.from_numpy(_feats(9, 8 * 4))
    call = lambda gen, training: tconv.multi_stream_attention(  # noqa: E731
        q, q, q, None, tg, 8, 4, dropout=0.1, training=training, generator=gen)
    call(torch.Generator().manual_seed(0), True)
    call(torch.Generator().manual_seed(0), True)
    call(torch.Generator().manual_seed(1), True)
    call(None, False)
    keep = seen[0]
    assert keep.shape == (BATCH, tg.attn_meta.s0.shape[1], 8, MESH["agg_eb"])
    zero, kept = keep.unique().tolist()
    assert zero == 0.0 and kept == pytest.approx(1 / 0.9)
    assert abs(float((keep == 0).float().mean()) - 0.1) < 0.01
    assert torch.equal(seen[0], seen[1]) and not torch.equal(seen[0], seen[2])
    assert seen[3] is None
    with pytest.raises(ValueError, match="Generator"):
        call(None, True)


def test_eval_forecast_is_deterministic(run):
    ds, _, tp, _, tout, _, _ = run
    again, _, _ = tp.forecast(ds.x)
    np.testing.assert_array_equal(again.numpy(), tout)


@pytest.mark.parametrize("model,graph", [
    (dict(convolution_type="MHTransformerConv"), {}),
    (dict(convolution_type="GATConv"), {}),
    (dict(convolution_type="GATv2Conv"), {}),
])
def test_unported_attention_options_raise(model, graph):
    with pytest.raises(ValueError, match="not ported"):
        NextFramePredictorS2S(SHAPE, 0.1, device="cpu", model_kwargs=dict(MODEL, **model),
                              graph_kwargs=dict(GRAPH, **graph))
