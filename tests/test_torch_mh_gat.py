"""PyTorch port vs JAX package: MHTransformerConv, GATConv/GATv2Conv, the
α side channel and the attention kernels' head groups.

* ``head_groups``, and the grouped K3/K4 and K5/K6 dispatch with a small
  limit on the plain versions: bit-equal to one call, forward and
  backward (on the card the same split runs the unchanged kernels above
  their widths);
* ``MHTransformerConv`` on attention windows, a quadtree edge list and a
  masked grid, the fused MH gate stack and the per-gate MH cell with its
  gradients, ≤1e-5 (gradients ≤1e-4 × max(1, max|g|)); bf16 MH on
  windows within ``tests/test_torch_bf16_attn.py``'s rounding budget;
* the self-loop list and its mean attributes exactly; ``GATConv`` and
  ``GATv2Conv`` with and without edge features, and the per-gate GAT
  cell with its gradients, on a quadtree edge list, ≤1e-5; GAT on the
  grid raises, and the predictor falls back to ``aggregation="xla"``;
* ``attention_map`` on the edge list and the grid against the JAX
  package's, none on the windows, and ``dump_attention_map``'s records.

The Pallas kernels run in interpret mode on the JAX side; the port runs
its plain versions.
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
from quadtree_mpnnlstm_tpu.models.fused import FusedAttnGateStack as JFusedAttn
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig as TGraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph as t_image_to_graph
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.models.cells import GConvLSTM as TGConvLSTM
from quadtree_mpnnlstm_tpu_torch.models.fused import FusedAttnGateStack as TFusedAttn
from quadtree_mpnnlstm_tpu_torch.ops import attn as tattn
from quadtree_mpnnlstm_tpu_torch.ops import grid_attn as tgrid
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from quadtree_mpnnlstm_tpu_torch.utils.weights import state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

B = 2
CONV_TOL, GRAD_TOL = 1e-5, 1e-4
BF16 = torch.bfloat16
ULP = 2.0**-7  # one bf16 rounding, relative
QUAD = dict(image_shape=(32, 32), max_grid_size=8, thresh=0.2, n_max=512, e_max=4096,
            agg_nt=128, agg_eb=1024, agg_sw=512)
GRID_SHAPE = (24, 32)
MESHES = {
    "windows": dict(QUAD, aggregation="pallas", attn_windows=True),
    "edge_list": dict(QUAD, aggregation="xla"),
    # the JAX package's default grid attention: its XLA chain, which sows α
    "grid": dict(image_shape=GRID_SHAPE, thresh=NEG_INF, aggregation="grid"),
}


@pytest.fixture(autouse=True)
def no_attention_dropout(monkeypatch):
    """Attention dropout off in both registries: the two frameworks draw
    other random numbers."""
    for registry in (jconv.CONVOLUTION_KWARGS, tconv.CONVOLUTION_KWARGS):
        monkeypatch.setitem(registry, "MHTransformerConv",
                            dict(registry["MHTransformerConv"], dropout=0.0))


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


def _graphs(mesh, use_edge_attrs=True, bf16=False):
    """(port graph of the batch, the JAX graph of each sample)."""
    kw = dict(MESHES[mesh], use_edge_attrs=use_edge_attrs)
    shape = kw["image_shape"]
    x = _frames(shape, 0)
    mask = _mask(shape) if kw["thresh"] == NEG_INF else None
    tg, _ = t_image_to_graph(t_posenc(torch.from_numpy(x).to(BF16 if bf16 else torch.float32)),
                             TGraphConfig(**kw),
                             mask=None if mask is None else torch.from_numpy(mask))
    jgs = [j_image_to_graph(j_posenc(jnp.asarray(x[b], jnp.bfloat16 if bf16 else jnp.float32)),
                            JGraphConfig(**kw), mask=None if mask is None else jnp.asarray(mask))[0]
           for b in range(B)]
    assert int(tg.overflow.max()) == 0 and int(tg.n_nodes.min()) > 20
    return tg, jgs


_CACHE = {}


def _mesh(mesh, use_edge_attrs=True):
    key = (mesh, use_edge_attrs)
    if key not in _CACHE:
        _CACHE[key] = _graphs(mesh, use_edge_attrs)
    return _CACHE[key]


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


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------- head groups


@pytest.mark.parametrize("heads,d,limit,groups", [
    (24, 16, 512, ((0, 24),)),                 # MH gate stacks at hidden 16: one launch
    (24, 32, 512, ((0, 12), (12, 24))),        # K3/K4 at the sea-ice widths
    (24, 32, 256, ((0, 8), (8, 16), (16, 24))),  # K5/K6 at the sea-ice widths
    (5, 3, 6, ((0, 2), (2, 4), (4, 5))),       # uneven: the first groups one head more
    (1, 1, 512, ((0, 1),)),
])
def test_head_groups_are_the_fewest_even_groups_of_whole_heads(heads, d, limit, groups):
    assert tattn.head_groups(heads, d, limit) == groups


def test_a_head_wider_than_the_limit_raises():
    with pytest.raises(ValueError, match="wider"):
        tattn.head_groups(2, 300, 256)


def _qkv(n, heads, d, a, seed, extra=()):
    rng = np.random.default_rng(seed)
    shapes = [(B, n, heads * d)] * 3 + [(a, heads * d)] + list(extra)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("kh", [0, 1, 6])
def test_grouped_window_attention_is_bit_equal_to_one_call(kh):
    """K3's and K4's plain versions by head groups of at most 8 features
    (6 heads × d 4 → 3 groups) against one call: the output and dq, dk,
    dv, dWₑ bit for bit, with no keep, one shared keep row and a keep row
    a head."""
    tg, _ = _mesh("windows")
    meta = tg.attn_meta
    n, (_, nt, eb, sw) = tg.n_max, tg.agg
    heads, d = 6, 4
    dims = tattn.AttnDims(n, nt, eb, sw, heads, d)
    q, k, v, we, g = _qkv(n, heads, d, meta.attr.shape[-1], 1, [(B, n, heads * d)])
    keep = None
    if kh:
        u = torch.from_numpy(np.random.default_rng(2).random((B, meta.s0.shape[1], kh, eb)))
        keep = ((u < 0.9).float() / 0.9).float()
    assert len(tattn.head_groups(heads, d, 8)) == 3
    one = tattn.attn_plain(q, k, v, we, keep, meta, dims)
    grouped = tattn.attn_fwd_by_groups(tattn.attn_plain, q, k, v, we, keep, meta, dims, limit=8)
    assert torch.equal(one, grouped)
    ref = tattn.attn_bwd_plain(q, k, v, we, keep, meta, dims, g)
    got = tattn.attn_bwd_by_groups(tattn.attn_bwd_plain, q, k, v, we, keep, meta, dims, g,
                                   limit=8)
    for name, a, b in zip(("dq", "dk", "dv", "dwe"), got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("keep", [False, True])
def test_grouped_grid_attention_is_bit_equal_to_one_call(keep):
    """K5's and K6's plain versions by head groups of at most 8 features
    (6 heads × d 4 → 3 groups) against one call, with and without keep
    planes: the output and dq, dk, dv, d``e_dir`` bit for bit."""
    tg, _ = _mesh("grid")
    _, rows, cols, ndirs = tg.agg
    heads, d = 6, 4
    dims = tgrid.GridAttnDims(rows, cols, heads, d, ndirs)
    q, k, v, e_dir, g = _qkv(rows * cols, heads, d, ndirs, 3, [(B, rows * cols, heads * d)])
    valid = tg.node_valid[0].float()
    planes = None
    if keep:
        u = torch.from_numpy(np.random.default_rng(4).random((B, ndirs, rows * cols, heads)))
        planes = ((u < 0.9).float() / 0.9).float()
    one = tgrid.grid_attn_plain(q, k, v, e_dir, valid, planes, dims)
    grouped = tgrid.grid_fwd_by_groups(tgrid.grid_attn_plain, q, k, v, e_dir, valid, planes,
                                       dims, limit=8)
    assert torch.equal(one, grouped)
    ref = tgrid.grid_attn_bwd_plain(q, k, v, e_dir, valid, planes, dims, g)
    got = tgrid.grid_bwd_by_groups(tgrid.grid_attn_bwd_plain, q, k, v, e_dir, valid, planes,
                                   dims, g, limit=8)
    for name, a, b in zip(("dq", "dk", "dv", "de_dir"), got, ref):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------- MHTransformerConv


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fin,fout", [(17, 16), (16, 1)])
def test_mh_transformer_conv_matches_jax(mesh, fin, fout):
    """The decoder's head convs' shapes: 3 concatenated heads (``conv``)
    mixed back down by ``lin``, within 1e-5 on every mesh."""
    tg, jgs = _mesh(mesh)
    x = _feats(tg.n_max, fin, fin)
    jmod = jconv.MHTransformerConv(out_channels=fout, heads=3, edge_dim=2)
    params = _init(jmod, 1, jnp.asarray(x[0]), jgs[0])
    assert sorted(params["params"]) == ["conv", "lin"]
    tmod = tconv.MHTransformerConv(fin, fout, heads=3, edge_dim=2)
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), tg).numpy()
    for b, jg in enumerate(jgs):
        ref = np.asarray(jmod.apply(params, jnp.asarray(x[b]), jg))
        np.testing.assert_allclose(out[b], ref, rtol=0, atol=CONV_TOL, err_msg=mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fused_mh_gate_stack_matches_jax(mesh):
    """The fused MH stack (2·G streams × 3 heads as the heads of one
    attention call a layer, concatenated, a skip of width 3·d, a
    per-stream head-mixing Dense), two layers, within 1e-5."""
    tg, jgs = _mesh(mesh)
    n, fx, fh, d, layers = tg.n_max, 4, 8, 8, 2
    x, h = _feats(n, 1, fx), _feats(n, 2, fh, 0.5)
    jmod = JFusedAttn("MHTransformerConv", d, n_layers=layers)
    params = _init(jmod, 3, jnp.asarray(x[0]), jnp.asarray(h[0]), jgs[0])
    tmod = TFusedAttn(fx, fh, d, n_layers=layers, convolution_type="MHTransformerConv")
    assert {k: tuple(v.shape) for k, v in tmod.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in state_dict_from_flax(params["params"]).items()}
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), torch.from_numpy(h), tg).numpy()  # (g, B, N, d)
    for b, jg in enumerate(jgs):
        ref = np.asarray(jmod.apply(params, jnp.asarray(x[b]), jnp.asarray(h[b]), jg))
        np.testing.assert_allclose(out[:, b], ref, rtol=0, atol=CONV_TOL, err_msg=mesh)


def _cell_and_gradients(conv, mesh, fx=4, d=8, layers=2):
    """A per-gate cell of ``conv`` loaded leaf for leaf from the JAX
    package's: (O, H, C) within 1e-5, the gradients of a weighted sum of
    them with respect to every leaf and to x, h and c within 1e-4 ×
    max(1, max|g|)."""
    tg, jgs = _mesh(mesh, use_edge_attrs=conv != "GATv2Conv")
    n = tg.n_max
    rng = np.random.default_rng(2)
    x, h, c = (rng.standard_normal((B, n, w)).astype(np.float32) * s
               for w, s in ((fx, 1.0), (d, 0.5), (d, 0.5)))
    wo, wh, wc = (rng.standard_normal((B, n, d)).astype(np.float32) for _ in range(3))
    jcell = JGConvLSTM(out_channels=d, n_conv_layers=layers, convolution_type=conv, fused=False)
    params = _init(jcell, 3, jnp.asarray(x[0]), jgs[0], jnp.asarray(h[0]), jnp.asarray(c[0]))
    assert "conv_x" in params["params"]
    tcell = TGConvLSTM(fx, d, layers, conv, fused_gates=False,
                       attr_dim=tg.edge_attr.shape[-1]).eval()
    tcell.load_state_dict(state_dict_from_flax(params["params"]))

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
                                       atol=CONV_TOL)
        for leaf, ref in zip(xs, (gx, gh, gc)):
            assert _rel_err(leaf.grad[b].numpy(), np.asarray(ref)) <= GRAD_TOL
        for name, g in state_dict_from_flax(jax.tree.map(np.asarray, gp["params"])).items():
            j_params[name] = j_params.get(name, 0.0) + g.numpy()
    mine = dict(tcell.named_parameters())
    assert sorted(mine) == sorted(j_params)
    for name, ref in j_params.items():
        assert _rel_err(mine[name].grad.numpy(), ref) <= GRAD_TOL, name


def test_per_gate_mh_cell_and_gradients_match_jax():
    """The per-gate MH cell (``conv_x/conv_l/conv/lin_*`` at width 3·d and
    ``conv_x/conv_l/lin`` (4, 3·d, d)) on attention windows."""
    _cell_and_gradients("MHTransformerConv", "windows")


@pytest.mark.parametrize("layers", [1, 2])
def test_fused_mh_gate_stack_bf16_matches_jax(layers):
    """The fused MH stack in bf16 on the same bf16 windows: both round the
    projections, the attention (an f32 sum rounded once), the skip add
    and the mixing Dense, so the outputs lie within four bf16 roundings a
    layer, 4 × 2⁻⁷ × max(1, max|ref|) each (three for TransformerConv's
    stack in ``tests/test_torch_bf16_attn.py``, one more for the mix)."""
    tg, jgs = _graphs("windows", bf16=True)
    n, fx, fh, d = tg.n_max, 4, 8, 8
    x, h = _feats(n, 11, fx), _feats(n, 12, fh, 0.5)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    jmod = JFusedAttn("MHTransformerConv", d, n_layers=layers, dtype=jnp.bfloat16)
    params = _init(jmod, 13, bf(x[0]), bf(h[0]), jgs[0])
    tmod = TFusedAttn(fx, fh, d, n_layers=layers, dtype=BF16, convolution_type="MHTransformerConv")
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).to(BF16), torch.from_numpy(h).to(BF16), tg)
    assert out.dtype == BF16
    for b, jg in enumerate(jgs):
        ref = _f32(jmod.apply(params, bf(x[b]), bf(h[b]), jg))
        err = np.abs(_f32(out[:, b]) - ref).max()
        assert err <= layers * 4 * ULP * max(1.0, float(np.abs(ref).max())), err


# ---------------------------------------------------------------- GAT


def test_self_loop_list_matches_jax():
    """One self-edge per valid node after the edge list (the sentinel
    n_max for invalid nodes), its attributes the mean of the sample's
    valid edge attributes: ids, validity and attributes equal. The JAX
    list is built on the port's edge attributes: the bearings of the two
    builds differ in the last bit on a few edges (``atan2``, see
    ``tests/test_torch_transformer.py``)."""
    tg, jgs = _mesh("edge_list")
    loops = tconv.with_self_loops(tg)
    for b, jg in enumerate(jgs):
        jg = jg.replace(edge_attr=jnp.asarray(tg.edge_attr[b].numpy()))
        src, dst, valid, attr = (np.asarray(t) for t in jconv._with_self_loops(jg))
        np.testing.assert_array_equal(loops.src[b].numpy(), src)
        np.testing.assert_array_equal(loops.dst[b].numpy(), dst)
        np.testing.assert_array_equal(loops.valid[b].numpy(), valid)
        np.testing.assert_array_equal(loops.attr[b].numpy(), attr)


@pytest.mark.parametrize("edge_dim", [2, None], ids=["edge-features", "no-edge-features"])
@pytest.mark.parametrize("conv", ["GATConv", "GATv2Conv"])
def test_gat_matches_jax(conv, edge_dim):
    """GATConv and GATv2Conv (one head, self-loops with the mean
    attributes, leaky_relu 0.2, the edge softmax, Σ α·x[src]) on a
    quadtree edge list, with and without edge features, at the head convs'
    widths: within 1e-5, and the gradients of a weighted sum within 1e-4 ×
    max(1, max|g|)."""
    tg, jgs = _mesh("edge_list")
    fin, fout = 17, 16
    x = _feats(tg.n_max, 5, fin)
    w = _feats(tg.n_max, 6, fout)
    jmod = getattr(jconv, conv)(out_channels=fout, edge_dim=edge_dim)
    params = _init(jmod, 7, jnp.asarray(x[0]), jgs[0])
    tmod = getattr(tconv, conv)(fin, fout, edge_dim=edge_dim)
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    params_t = dict(tmod.named_parameters())
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmod(xt, tg)
    (out * torch.from_numpy(w)).sum().backward()

    def j_loss(p, xb, jg, wb):
        o = jmod.apply(p, xb, jg)
        return (o * wb).sum(), o

    grad = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True))
    j_params = {}
    for b, jg in enumerate(jgs):
        (_, ref), (gp, gx) = grad(params, x[b], jg, w[b])
        np.testing.assert_allclose(out[b].detach().numpy(), np.asarray(ref), rtol=0,
                                   atol=CONV_TOL)
        assert _rel_err(xt.grad[b].numpy(), np.asarray(gx)) <= GRAD_TOL
        for name, g in state_dict_from_flax(jax.tree.map(np.asarray, gp["params"])).items():
            j_params[name] = j_params.get(name, 0.0) + g.numpy()
    assert sorted(params_t) == sorted(j_params)
    for name, ref in j_params.items():
        assert _rel_err(params_t[name].grad.numpy(), ref) <= GRAD_TOL, name


@pytest.mark.parametrize("conv", ["GATConv", "GATv2Conv"])
def test_per_gate_gat_cell_and_gradients_match_jax(conv):
    """The per-gate GAT cell (the JAX package's vmapped ``GraphConv``; the
    port runs its 2·G gate streams as heads of one self-loop pass a
    layer) on a quadtree edge list; GATv2Conv's graph carries 1 attribute
    column, as its config uses no edge attributes."""
    _cell_and_gradients(conv, "edge_list")


def test_gat_needs_an_edge_list_and_the_predictor_falls_back(capsys, tmp_path):
    """On the grid GAT raises the JAX package's error; the predictor takes
    ``aggregation="grid"`` to ``"xla"`` with the JAX predictor's
    message."""
    tg, _ = _mesh("grid")
    x = torch.zeros(B, tg.n_max, 4)
    with pytest.raises(ValueError, match="edge-list mesh"):
        tconv.GATConv(4, 4, edge_dim=2)(x, tg)
    tp = NextFramePredictorS2S(GRID_SHAPE, NEG_INF, device="cpu", run_dir=str(tmp_path),
                               model_kwargs=dict(convolution_type="GATConv", hidden_size=4,
                                                 n_layers=1, n_conv_layers=1),
                               graph_kwargs=dict(aggregation="grid"))
    assert tp.gcfg.aggregation == "xla"
    assert "falling back to aggregation='xla'" in capsys.readouterr().out


# ---------------------------------------------------------------- α side channel


@pytest.mark.parametrize("mesh", ["edge_list", "grid"])
def test_attention_map_matches_jax(mesh, tmp_path):
    """A two-layer ``GraphConv`` of TransformerConv sows each layer's α;
    ``attention_map`` reduces the first to the max over each node's
    incoming edges (the grid: directions) and heads, 0 at invalid nodes,
    within 1e-6 of the JAX package's map; ``dump_attention_map`` writes x
    and the map as two ``np.save`` records."""
    tg, jgs = _mesh(mesh)
    x = _feats(tg.n_max, 8, 4)
    jmod = jconv.GraphConv(convolution_type="TransformerConv", out_channels=5, n_layers=2)
    params = _init(jmod, 9, jnp.asarray(x[0]), jgs[0])
    tmod = tconv.GraphConv("TransformerConv", 4, 5, n_layers=2).eval()
    tmod.load_state_dict(state_dict_from_flax(params["params"]))
    inter = {}
    with torch.no_grad():
        tmod(torch.from_numpy(x), tg, intermediates=inter)
    assert len(inter["alpha"]) == 2
    att = tconv.attention_map(inter, tg)
    assert att.shape == (B, tg.n_max, 1)
    for b, jg in enumerate(jgs):
        _, state = jmod.apply(params, jnp.asarray(x[b]), jg, mutable=["intermediates"])
        ref = np.asarray(jconv.attention_map(state["intermediates"], jg))
        np.testing.assert_allclose(att[b].numpy(), ref, rtol=0, atol=1e-6, err_msg=mesh)
    assert (att[~tg.node_valid] == 0).all() and float(att.max()) > 0
    path = tmp_path / "attention_map.npy"
    tconv.dump_attention_map(path, torch.from_numpy(x), att)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(np.load(f), x)
        np.testing.assert_array_equal(np.load(f), att.numpy())


def test_attention_windows_sow_no_alpha():
    """The attention windows never hold α (K3 is flash-style), as in the
    JAX package: nothing is sown and ``attention_map`` says so."""
    tg, _ = _mesh("windows")
    inter = {}
    with torch.no_grad():
        tconv.TransformerConv(4, 5, edge_dim=2)(torch.zeros(B, tg.n_max, 4), tg,
                                                intermediates=inter)
    with pytest.raises(ValueError, match="no sown 'alpha'"):
        tconv.attention_map(inter, tg)
