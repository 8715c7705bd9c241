"""PyTorch port vs JAX package: the preset meshes of the sea-ice
experiments 9 and 10 (``graph/static.py``) and the model on them.

* ``create_static_heterogeneous_graph`` (with and without a mask and a
  high-interest region) and ``create_static_homogeneous_graph`` on a
  masked 24×32 grid with ``max_grid_size=4``, ``resolution=1/12`` (the
  experiments' ``GraphConfig``): node map, counts, node and edge ids,
  validity and their order bit for bit; ``edge_attr`` within 2⁻²³,
  ``node_xy`` and the symmetric norm within 1e-6;
* ``predict`` on each preset with climatology and the region
  (TransformerConv on the edge list, the experiments' model cut to hidden
  8) against the JAX predictor, ≤1e-4 per pixel;
* one ``train_step`` on each preset, full BPTT and TBPTT 2: the loss
  within 1e-5 relative and every gradient leaf within 1e-4 × max(1,
  max|g|) of ``jax.value_and_grad`` (dropout 0 on both sides);
* a batch rides the preset as views, and a preset of other capacities
  raises.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.data.loader import DataLoader as JDataLoader
from quadtree_mpnnlstm_tpu.graph import static as jstatic
from quadtree_mpnnlstm_tpu.models import conv as jconv
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu_torch.config import NEG_INF, GraphConfig
from quadtree_mpnnlstm_tpu_torch.data.ice_dataset import (
    IceDataset,
    climatology_from_dataset,
    synthetic_dataset,
)
from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader
from quadtree_mpnnlstm_tpu_torch.graph import static
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (24, 32)
B, VARS, T_IN, T_OUT = 2, 5, 3, 4
MESH = dict(image_shape=SHAPE, max_grid_size=4, resolution=1 / 12, use_edge_attrs=True)
X_VARS = ["siconc", "t2m", "v10", "u10", "sshf"]
TOL, GRAD_TOL = 1e-4, 1e-4
EXACT = ("pixel_node", "counts", "n_nodes", "node_valid", "edge_src", "edge_dst", "edge_valid",
         "n_edges")


def _mask():
    mask = np.random.default_rng(0).random(SHAPE) < 0.15
    mask[:3] = True
    mask[10:14, 20:30] = True
    return mask


def _hir():
    yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1]]
    return np.abs(yy / SHAPE[0] - xx / SHAPE[1]) < 0.08


def _jax_preset(kind, mask, hir=None):
    cfg = JGraphConfig(**MESH)
    if kind == "heterogeneous":
        return jstatic.create_static_heterogeneous_graph(
            cfg, mask=None if mask is None else jnp.asarray(mask),
            high_interest_region=None if hir is None else jnp.asarray(hir))
    return jstatic.create_static_homogeneous_graph(cfg, jnp.asarray(mask))


def _port_preset(kind, mask, hir=None):
    cfg = GraphConfig(**MESH)
    if kind == "heterogeneous":
        return static.create_static_heterogeneous_graph(
            cfg, mask=None if mask is None else torch.from_numpy(mask),
            high_interest_region=None if hir is None else torch.from_numpy(hir), device="cpu")
    return static.create_static_homogeneous_graph(cfg, torch.from_numpy(mask), device="cpu")


@pytest.mark.parametrize("kind,masked,hir", [
    ("heterogeneous", False, False), ("heterogeneous", True, False),
    ("heterogeneous", False, True), ("heterogeneous", True, True), ("homogeneous", True, False),
], ids=["heterogeneous", "heterogeneous-mask", "heterogeneous-hir", "heterogeneous-mask-hir",
        "homogeneous-mask"])
def test_preset_builders_match_jax(kind, masked, hir):
    mask = _mask() if masked else None
    region = _hir() if hir else None
    want = _jax_preset(kind, mask, region)
    got = _port_preset(kind, mask, region)
    assert got.counts.shape == (1, SHAPE[0] * SHAPE[1])
    for name in EXACT:
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.edge_attr[0].numpy(), np.asarray(want.edge_attr), rtol=0,
                               atol=2.0**-23)
    np.testing.assert_allclose(got.node_xy[0].numpy(), np.asarray(want.node_xy), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.sym_coeff[0].numpy(), np.asarray(want.sym_coeff), rtol=0,
                               atol=1e-6)
    assert int(got.overflow[0]) == 0
    valid = int(got.n_edges[0])
    dst = got.edge_dst[0]
    assert (dst[:valid] < got.n_max).all() and (dst[valid:] == got.n_max).all()
    if mask is not None:  # every node keeps an unmasked pixel
        keep = torch.from_numpy(~mask).reshape(-1).float()
        pn = got.pixel_node[0]
        per_node = torch.zeros(got.n_max + 1).index_add_(0, pn, keep)[:int(got.n_nodes[0])]
        assert (per_node > 0).all()
    if hir:  # the region forces splits: more nodes than without it
        assert int(got.n_nodes[0]) > int(_port_preset(kind, mask).n_nodes[0])


def test_preset_builders_follow_the_mask_and_default_to_the_card():
    """Without ``device`` a preset lands where its mask (or region) lies,
    and on the card when neither is a torch tensor, as the port's other
    entry points do; ``device`` given wins."""
    cfg = GraphConfig(**MESH)
    mask, hir = torch.from_numpy(_mask()), torch.from_numpy(_hir())
    assert static.create_static_heterogeneous_graph(cfg, mask=mask).counts.device.type == "cpu"
    assert static.create_static_heterogeneous_graph(
        cfg, high_interest_region=hir).counts.device.type == "cpu"
    assert static.create_static_homogeneous_graph(cfg, mask).counts.device.type == "cpu"
    assert static.preset_device(None) == torch.device("cuda")
    assert static.preset_device(None, None, _hir()) == torch.device("cuda")  # numpy: the card
    assert static.preset_device(None, torch.zeros(2, device="meta")) == torch.device("meta")
    assert static.preset_device("cpu", torch.zeros(2, device="meta")) == torch.device("cpu")


def test_homogeneous_cells_are_uniform_and_relabelled_in_order():
    """Every node of the homogeneous mesh is one max_grid_size cell (16
    pixels, partly masked cells keep their masked pixels), and the
    relabel keeps the raster order of the cells."""
    mask = _mask()
    graph = _port_preset("homogeneous", mask)
    n = int(graph.n_nodes[0])
    assert (graph.counts[0, :n] == 16).all() and (graph.counts[0, n:] == 0).all()
    pn = graph.pixel_node[0].reshape(SHAPE)
    firsts = [int(torch.nonzero(pn.reshape(-1) == i)[0]) for i in range(n)]
    assert firsts == sorted(firsts)


def _ice_windows():
    ds, band = synthetic_dataset(shape=SHAPE, years=(2016, 2017), seed=3)
    data = IceDataset(ds, [2016], 6, T_IN, T_OUT, X_VARS, ["siconc"])
    sub = ArrayDataset(data.x[:B], data.y[:B], data.launch_dates[:B])
    return sub, climatology_from_dataset(ds), band | _mask()


KW = dict(thresh=NEG_INF, decompose=False, input_features=VARS, input_timesteps=T_IN,
          output_timesteps=T_OUT, use_climatology=True)


@pytest.mark.parametrize("kind", ["heterogeneous", "homogeneous"])
def test_predict_on_a_preset_matches_jax(kind):
    """Experiments 9 and 10 cut to size: the preset replaces the pixelwise
    mesh, the node size channel is counts / 4; climatology and the region
    (which a fixed mesh does not read) as ``ice_exp.py`` passes them."""
    sub, clim, mask = _ice_windows()
    hir = _hir()
    kw = dict(KW, model_kwargs=dict(hidden_size=8, n_layers=1, n_conv_layers=3,
                                    convolution_type="TransformerConv"))
    jp = JPredictor(SHAPE, **kw)
    jp._ensure_params()
    jout = jp.predict(JDataLoader(sub, batch_size=B), climatology=clim, mask=mask,
                      high_interest_region=hir, graph_structure=_jax_preset(kind, mask))
    tp = NextFramePredictorS2S(SHAPE, device="cpu", **kw)
    tp.load_jax_params(jax.tree.map(np.asarray, jp.params))
    preset = _port_preset(kind, mask)
    tout = tp.predict(DataLoader(sub, batch_size=B), climatology=clim, mask=mask,
                      high_interest_region=hir, graph_structure=preset)
    assert tout.shape == jout.shape == (B, T_OUT, *SHAPE, 1) and tp.last_overflow == 0
    np.testing.assert_allclose(tout, jout, rtol=0, atol=TOL)
    # the preset differs from the pixelwise mesh, so it was read
    pixelwise = tp.predict(DataLoader(sub, batch_size=B), climatology=clim, mask=mask)
    assert np.abs(pixelwise - tout).max() > 1e-3


def _jax_loss_and_grads(jp, x, y, clim, mask, gs, truncated):
    model = jp.model
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}
    m = jnp.asarray(mask)
    chunks = jp._chunks(truncated)

    def sample_loss(params, xb, yb, cb):
        total = 0.0
        for t0, n in chunks:
            state = model.apply(params, xb, mask=m, graph_structure=gs,
                                method=JSeq2Seq.encode, rngs=rngs)
            _, y_hat = model.apply(params, state, t0, n, yb[t0:t0 + n], cb[t0:t0 + n], m,
                                   method=JSeq2Seq.decode, rngs=rngs)
            total = total + J_LOSSES["MSE"](y_hat, yb[t0:t0 + n], m)
        return total

    def loss(params):
        return jnp.mean(jax.vmap(lambda xb, yb, cb: sample_loss(params, xb, yb, cb))(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(clim)))

    value, grads = jax.jit(jax.value_and_grad(loss))(jp.params)
    clip = optax.clip_by_global_norm(10.0)
    clipped, _ = clip.update(grads, clip.init(jp.params))
    return float(value), params_from_jax(jax.tree.map(np.asarray, clipped))


@pytest.mark.parametrize("kind,truncated", [("heterogeneous", 0), ("homogeneous", 2)],
                         ids=["heterogeneous-full-bptt", "homogeneous-tbptt-2"])
def test_train_step_on_a_preset_matches_jax(kind, truncated, tmp_path, monkeypatch):
    for registry in (jconv.CONVOLUTION_KWARGS, tconv.CONVOLUTION_KWARGS):
        monkeypatch.setitem(registry, "TransformerConv",
                            dict(registry["TransformerConv"], dropout=0.0))
    rng = np.random.default_rng(4)
    x = rng.random((B, T_IN, *SHAPE, VARS)).astype(np.float32)
    y = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    clim = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    mask = _mask()
    model = dict(hidden_size=8, n_layers=1, n_conv_layers=2, dropout=0.0,
                 convolution_type="TransformerConv")
    jp = JPredictor(SHAPE, model_kwargs=dict(model, remat=False), **KW)
    jp._ensure_params()
    j_loss, j_grads = _jax_loss_and_grads(jp, x, y, clim, mask, _jax_preset(kind, mask),
                                          truncated)
    tp = NextFramePredictorS2S(SHAPE, device="cpu", model_kwargs=model, run_dir=str(tmp_path),
                               **KW)
    tp.load_jax_params(jax.tree.map(np.asarray, jp.params))
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    loss, overflow = tp.train_step(x, y, mask=mask, truncated_backprop=truncated,
                                   climatology=clim, high_interest_region=_hir(),
                                   graph_structure=_port_preset(kind, mask))
    assert int(overflow) == 0
    assert abs(float(loss) - j_loss) <= 1e-5 * abs(j_loss)
    grads = {name: p.grad for name, p in tp.model.named_parameters()}
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        r = j_grads[name]
        err = float((g - r).abs().max())
        assert err <= GRAD_TOL * max(1.0, float(r.abs().max())), (name, err)


def test_a_batch_rides_the_preset_as_views():
    """``expand_graph`` makes views of the one mesh (no copy of its
    tensors) and rebases its CSR views for the batch; the model builds the
    batch's graph once per preset and batch size."""
    from quadtree_mpnnlstm_tpu_torch.ops.segment_sum import segment_sum_plain, segment_view

    preset = _port_preset("homogeneous", _mask())
    preset = preset.replace(dst_view=segment_view(preset.edge_dst, preset.n_max, True),
                            src_view=segment_view(preset.edge_src, preset.n_max))
    graph = static.expand_graph(preset, 3)
    assert graph.edge_src.shape == (3, preset.edge_src.shape[1])
    assert graph.edge_src.data_ptr() == preset.edge_src.data_ptr()
    assert graph.edge_src.stride(0) == 0 and graph.counts.stride(0) == 0
    want = segment_view(preset.edge_src.expand(3, -1).contiguous(), preset.n_max)
    assert torch.equal(graph.src_view.order, want.order)
    assert torch.equal(graph.src_view.offsets, want.offsets)
    assert torch.equal(graph.dst_view.offsets,
                       segment_view(preset.edge_dst.expand(3, -1).contiguous(), preset.n_max,
                                    True).offsets)
    values = torch.randn(3, preset.edge_src.shape[1], 2)
    assert torch.equal(segment_sum_plain(values, graph.edge_dst, preset.n_max),
                       segment_sum_plain(values, graph.edge_dst.contiguous(), preset.n_max))
    assert static.expand_graph(graph, 3) is graph
    with pytest.raises(ValueError, match="one mesh"):
        static.expand_graph(graph, 2)

    tp = NextFramePredictorS2S(SHAPE, device="cpu", **dict(
        KW, model_kwargs=dict(hidden_size=4, n_layers=1, n_conv_layers=1,
                              convolution_type="GCNConv")))
    x = np.random.default_rng(0).random((2, T_IN, *SHAPE, VARS)).astype(np.float32)
    tp.forecast(x, graph_structure=preset)
    first = tp.model._preset_cache[2]
    tp.forecast(x, graph_structure=preset)
    assert tp.model._preset_cache[2] is first


def test_a_preset_of_other_capacities_raises():
    """The model's n_max/e_max must be the preset's; a preset built at
    other capacities raises before any step."""
    preset = static.create_static_heterogeneous_graph(
        GraphConfig(**dict(MESH, n_max=512, e_max=2048)), mask=torch.from_numpy(_mask()))
    tp = NextFramePredictorS2S(SHAPE, device="cpu", **dict(
        KW, model_kwargs=dict(hidden_size=4, n_layers=1, n_conv_layers=1,
                              convolution_type="GCNConv")))
    x = np.zeros((1, T_IN, *SHAPE, VARS), np.float32)
    with pytest.raises(ValueError, match="n_max=512, e_max=2048"):
        tp.forecast(x, graph_structure=preset)
