"""PyTorch port vs JAX package: shared-mesh batched training
(``TrainConfig.shared_mesh``; ``Seq2Seq.encode(..., shared_mesh=True)``).

The whole batch rides one mesh a step: the encoder's from the max of the
criterion over every sample and input frame, each decoder remesh's from
the batch's frames of the step (the JAX package's batch analogue of the
builder's timestep max). The port keeps its (B, n_max, F) layout and
expands a mesh built once (batch 1) to the batch; the JAX package moves to
the batch-middle layout and folds the batch into features or heads.

* a rollout of distinct samples (so the batch max matters) runs every
  decoder step on the JAX package's shared mesh (asserted) and matches its
  frames within 1e-4, for fused GCN on Â blocks and fused TransformerConv
  on attention windows; one train step's loss (1e-5 relative) and clipped
  gradients (1e-4 × max(1, max|g|)) match ``jax.value_and_grad`` of the
  JAX package's shared-mesh loss, with full BPTT and TBPTT chunks, for
  fused GCN and TransformerConv on the edge list (teacher forcing 1.0,
  dropout 0 — attention dropout too —, f32);
* B identical samples through the shared mesh give the per-sample path's
  forecast and train step bit for bit, on every mesh kind and for GAT, MH
  and GRU models;
* scheduled sampling draws one coin a step for the batch;
* every remat mode is the plain step bit for bit under shared meshes with
  ``remesh_input``, ``remesh_every`` 2, TBPTT chunks and a region, and the
  debug mode names a NaN on them;
* the kernels' plain versions (K2 and K3/K4's) take a shared mesh's
  metadata (batch 1) for a batch of B;
* ``NextFramePredictorS2S(train_config=TrainConfig(shared_mesh=True))``
  trains (each training mesh built once for the batch, each eval mesh per
  sample).
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import TrainConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.graph.static import expand_graph
from quadtree_mpnnlstm_tpu_torch.ops import attn as tattn
from quadtree_mpnnlstm_tpu_torch.ops import spmm as tspmm
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax
from quadtree_mpnnlstm_tpu.models import conv as jconv
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (16, 16)
B, T_IN, T_OUT = 3, 3, 4
ROLLOUT_TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
GRAPHS = {
    "blocks": dict(max_grid_size=4, n_max=128, e_max=1024, aggregation="pallas", agg_nt=64,
                   agg_eb=512, agg_sw=128),
    "windows": dict(max_grid_size=4, n_max=128, e_max=1024, aggregation="pallas",
                    agg_nt=64, agg_eb=512, agg_sw=128),
    "edge_list": dict(max_grid_size=4, n_max=256, e_max=2048, aggregation="xla"),
    "grid": dict(aggregation="grid"),
}


@pytest.fixture(scope="module", autouse=True)
def _no_attention_dropout():
    """Attention dropout 0 in both registries: parity runs without
    dropout, and identical samples stay identical in training mode (each
    sample draws masks of its own, and the shared mesh is the batch's)."""
    with pytest.MonkeyPatch.context() as mp:
        for registry in (jconv.CONVOLUTION_KWARGS, tconv.CONVOLUTION_KWARGS):
            for conv in ("TransformerConv", "MHTransformerConv"):
                mp.setitem(registry, conv, dict(registry[conv], dropout=0.0))
        yield


def _model(conv, **kw):
    return dict(dict(hidden_size=6, n_layers=2, n_conv_layers=1, dropout=0.0,
                     convolution_type=conv, remat=False), **kw)


def _data(seed, b=B):
    """Faint noise with a bright 3×3 square that drifts, at a place of its
    own in each sample: the samples' meshes differ, and the shared mesh
    refines around every sample's square."""
    rng = np.random.default_rng(seed)
    t = T_IN + T_OUT
    frames = 0.05 * rng.random((b, t, *SHAPE, 1))
    for i in range(b):
        r, c = rng.integers(1, SHAPE[0] - 4 - t // 2, size=2)
        for s in range(t):
            frames[i, s, r + s // 2:r + s // 2 + 3, c:c + 3] = 0.9
    frames = frames.astype(np.float32)
    return frames[:, :T_IN], frames[:, T_IN:]


def _pair(conv, graph, tf=0.0, thresh=0.2, **model):
    jp = JPredictor(SHAPE, thresh, input_timesteps=T_IN, output_timesteps=T_OUT,
                    teacher_forcing_ratio=tf, model_kwargs=_model(conv, **model),
                    graph_kwargs=dict(GRAPHS[graph]), shared_mesh=True)
    jp._ensure_params()
    tp = NextFramePredictorS2S(SHAPE, thresh, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", teacher_forcing_ratio=tf,
                               model_kwargs=_model(conv, **model),
                               graph_kwargs=dict(GRAPHS[graph]), shared_mesh=True)
    tp.load_jax_params(jax.tree.map(np.asarray, jp.params))
    return jp, tp


def _jax_mesh(gcfg, frames):
    """The JAX package's node map of frames (N, rows, cols, 1): one mesh
    from the max over all N."""
    return np.asarray(j_image_to_graph(j_posenc(jnp.asarray(frames)), gcfg)[0].pixel_node)


@pytest.mark.parametrize("conv,graph", [("GCNConv", "blocks"), ("TransformerConv", "windows")])
def test_shared_rollout_matches_jax(conv, graph):
    jp, tp = _pair(conv, graph, n_layers=1)
    x, _ = _data(1)
    xt = jnp.moveaxis(jnp.asarray(x), 0, 1)  # (T, B, ...)

    @jax.jit
    def rollout(params, xb):
        state = jp.eval_model.apply(params, xb, method=JSeq2Seq.encode)
        return jp.eval_model.apply(params, state, 0, T_OUT, method=JSeq2Seq.decode)[1]

    jy = np.moveaxis(np.asarray(rollout(jp.params, xt)), 1, 0)  # (B, T, ...)
    model = tp.model.eval()
    with torch.no_grad():
        state = model.encode(torch.from_numpy(x), shared_mesh=True)
        assert state.shared and state.graph.counts.stride(0) == 0
        _, y, meshes = model.decode(state, T_OUT)
    want = _jax_mesh(jp.gcfg, x.reshape(B * T_IN, *SHAPE, 1))
    for t in range(T_OUT):
        for b in range(B):
            np.testing.assert_array_equal(meshes[t, b].numpy(), want, err_msg=f"step {t}")
        want = _jax_mesh(jp.gcfg, jy[:, t])
    assert len({m.tobytes() for m in (_jax_mesh(jp.gcfg, x[b]) for b in range(B))}) > 1
    np.testing.assert_allclose(y.numpy(), jy, atol=ROLLOUT_TOL)


def _jax_shared_loss_and_grad(jp, x, y, truncated):
    model, chunks = jp.model, jp._chunks(truncated)
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}
    xt, yt = jnp.moveaxis(jnp.asarray(x), 0, 1), jnp.moveaxis(jnp.asarray(y), 0, 1)

    def loss_fn(params):
        total = 0.0
        for t0, n in chunks:
            state = model.apply(params, xt, method=JSeq2Seq.encode, rngs=rngs)
            _, y_hat = model.apply(params, state, t0, n, yt[t0:t0 + n], method=JSeq2Seq.decode,
                                   rngs=rngs)
            total = total + J_LOSSES["MSE"](y_hat, yt[t0:t0 + n], None)
        return total

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp.params)
    clip = optax.clip_by_global_norm(10.0)
    grads, _ = clip.update(grads, clip.init(jp.params))
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("conv,graph,truncated", [
    ("GCNConv", "edge_list", 0), ("TransformerConv", "edge_list", 2),
], ids=["gcn-edge-list-full-bptt", "transformer-edge-list-tbptt-2"])
def test_shared_train_step_matches_jax(conv, graph, truncated, tmp_path):
    jp, tp = _pair(conv, graph, tf=1.0)
    x, y = _data(2)
    j_loss, j_grads = _jax_shared_loss_and_grad(jp, x, y, truncated)
    tp.run_dir = str(tmp_path)
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    loss, overflow = tp.train_step(x, y, truncated_backprop=truncated)
    assert int(overflow) == 0
    assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    grads = {name: p.grad for name, p in tp.model.named_parameters()}
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        ref = j_grads[name]
        err = float((g - ref).abs().max())
        assert err <= GRAD_TOL * max(1.0, float(ref.abs().max())), (name, err)


def _port(conv, graph, thresh=0.2, tf=0.0, run_dir="runs", **model):
    tp = NextFramePredictorS2S(SHAPE, thresh, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", teacher_forcing_ratio=tf, run_dir=str(run_dir),
                               model_kwargs=_model(conv, **model),
                               graph_kwargs=dict(GRAPHS[graph]))
    return tp


@pytest.mark.parametrize("conv,graph,model", [
    ("GCNConv", "blocks", {}), ("TransformerConv", "windows", {}),
    ("ChebConv", "edge_list", {}), ("GATConv", "edge_list", dict(rnn_type="GRU")),
    ("MHTransformerConv", "windows", dict(fused_gates=False)),
    ("TransformerConv", "grid", {}),
], ids=["gcn-blocks", "transformer-windows", "cheb-edge-list", "gat-gru", "mh-per-gate",
        "transformer-grid"])
def test_identical_samples_match_the_per_sample_path_bit_for_bit(conv, graph, model,
                                                                 tmp_path):
    thresh = float("-inf") if graph == "grid" else 0.2
    x1, y1 = _data(3, b=1)
    x, y = np.repeat(x1, B, 0), np.repeat(y1, B, 0)
    runs = []
    for shared in (False, True):
        tp = _port(conv, graph, thresh, run_dir=tmp_path, **model)
        tp.shared_mesh = shared
        m = tp.model.eval()
        with torch.no_grad():
            state = m.encode(torch.from_numpy(x), shared_mesh=shared)
            _, yh, meshes = m.decode(state, T_OUT)
        tp.initiate_training(lr=0.01, lr_decay=0.95)
        loss, _ = tp.train_step(x, y, generator=torch.Generator().manual_seed(0))
        grads = [p.grad.clone() for p in tp.model.parameters()]
        runs.append((yh, meshes, loss, grads))
    (y_a, m_a, l_a, g_a), (y_b, m_b, l_b, g_b) = runs
    assert torch.equal(m_a, m_b) and torch.equal(y_a, y_b) and torch.equal(l_a, l_b)
    assert all(torch.equal(a, b) for a, b in zip(g_a, g_b))


@pytest.mark.parametrize("shared,coins", [(True, 1), (False, B)])
def test_scheduled_sampling_draws_one_coin_a_step_for_the_batch(shared, coins):
    tp = _port("GCNConv", "blocks", tf=0.5, remesh_every=2)
    x, y = _data(4)
    gen = torch.Generator().manual_seed(5)
    m = tp.model.train()
    with torch.no_grad():
        state = m.encode(torch.from_numpy(x), shared_mesh=shared)
        m.decode(state, T_OUT, y=torch.from_numpy(y), teacher_forcing_ratio=0.5, generator=gen)
    ref = torch.Generator().manual_seed(5)
    for _ in range(T_OUT):
        torch.rand(coins, generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())


@pytest.mark.parametrize("mode", ["full", "mesh", "dots"])
def test_remat_modes_under_shared_meshes_are_bit_for_bit(mode, tmp_path):
    """With ``remesh_input``, ``remesh_every`` 2, TBPTT chunks of 3, a
    high-interest region and scheduled sampling at 0.5."""
    x, y = _data(6)
    yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1]]
    hir = np.abs(yy / SHAPE[0] - xx / SHAPE[1]) < 0.1
    runs = []
    for remat in ("none", mode):
        tp = _port("GCNConv", "blocks", tf=0.5, run_dir=tmp_path, remat=remat, remesh_every=2)
        tp = NextFramePredictorS2S(SHAPE, 0.2, input_timesteps=T_IN, output_timesteps=T_OUT,
                                   device="cpu", teacher_forcing_ratio=0.5, remesh_input=True,
                                   run_dir=str(tmp_path), shared_mesh=True,
                                   model_kwargs=_model("GCNConv", remat=remat, remesh_every=2,
                                                       dropout=0.1),
                                   graph_kwargs=dict(GRAPHS["blocks"]))
        tp.initiate_training(lr=0.01, lr_decay=0.95)
        gen = torch.Generator().manual_seed(7)
        loss, overflow = tp.train_step(x, y, generator=gen, truncated_backprop=3,
                                       high_interest_region=hir)
        runs.append((loss, [p.grad.clone() for p in tp.model.parameters()], gen.get_state(),
                     [p.detach().clone() for p in tp.model.parameters()]))
    (l_a, g_a, s_a, p_a), (l_b, g_b, s_b, p_b) = runs
    assert torch.equal(l_a, l_b) and torch.equal(s_a, s_b)
    assert all(torch.equal(a, b) for a, b in zip(g_a, g_b))
    assert all(torch.equal(a, b) for a, b in zip(p_a, p_b))


def test_debug_mode_names_the_nan_on_shared_meshes(tmp_path):
    """``debug=True`` with shared meshes: a NaN decoder weight is named by
    the debug replay (from the step's start, on the shared meshes), and the
    update does not run."""
    x, y = _data(12)
    tp = NextFramePredictorS2S(SHAPE, 0.2, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", run_dir=str(tmp_path), debug=True,
                               shared_mesh=True, model_kwargs=_model("GCNConv"),
                               graph_kwargs=dict(GRAPHS["blocks"]))
    tp.initiate_training(lr=0.01, lr_decay=0.95)
    with torch.no_grad():
        tp.model.decoder.fc_out2.bias.fill_(float("nan"))
    before = [p.detach().clone() for p in tp.model.parameters()]
    with pytest.raises(ValueError, match="module=decoder at rollout step t=0"):
        tp.train_step(x, y)
    for a, b in zip(tp.model.parameters(), before):
        assert torch.equal(a, b) or torch.isnan(b).all()


def test_plain_kernels_take_shared_metadata():
    """K2's and K3/K4's plain versions on a shared mesh's metadata (batch
    1) give the per-sample results on its expanded copy."""
    x, _ = _data(8, b=1)
    frames = add_positional_encoding(torch.from_numpy(x))
    gcfg = GRAPHS["blocks"]
    from quadtree_mpnnlstm_tpu_torch.config import GraphConfig

    cfg = GraphConfig(image_shape=SHAPE, thresh=0.2, use_edge_attrs=True, **gcfg)
    graph, _ = image_to_graph(frames, cfg)
    wide = expand_graph(graph, B)
    assert wide.agg_meta.blocks.shape[0] == 1 and wide.pixel_node.shape[0] == B
    meta = graph.agg_meta
    n = gcfg["n_max"]
    z = torch.from_numpy(np.random.default_rng(9).normal(size=(B, n, 7)).astype(np.float32))
    copy = [t.expand((B,) + t.shape[1:]).contiguous() for t in meta]
    args = (n, gcfg["agg_nt"], gcfg["agg_sw"])
    assert torch.equal(tspmm.apply_plain(z, *meta, *args), tspmm.apply_plain(z, *copy, *args))
    wg, _ = image_to_graph(frames, cfg.replace(attn_windows=True, carry_edges=False))
    am = wg.attn_meta
    am_copy = tattn.AttnMeta(*(t.expand((B,) + t.shape[1:]).contiguous() for t in am))
    dims = tattn.AttnDims(n, gcfg["agg_nt"], gcfg["agg_eb"], gcfg["agg_sw"], 2, 4)
    rng = np.random.default_rng(10)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, n, 8)).astype(np.float32))
                  for _ in range(4))
    we = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    assert torch.equal(tattn.attn_plain(q, k, v, we, None, am, dims),
                       tattn.attn_plain(q, k, v, we, None, am_copy, dims))
    for a, b in zip(tattn.attn_bwd_plain(q, k, v, we, None, am, dims, g),
                    tattn.attn_bwd_plain(q, k, v, we, None, am_copy, dims, g)):
        assert torch.equal(a, b)
    dq, dlog, used, dwe = tattn.attn_bwd_slots_plain(q, k, v, we, None, am, dims, g)
    assert torch.equal(tattn.attn_combine_plain(dlog, used, q, g, am, dims)[0],
                       tattn.attn_combine_plain(dlog, used, q, g, am_copy, dims)[0])


def test_trainer_trains_on_shared_meshes(tmp_path, monkeypatch):
    """``train`` with ``TrainConfig(shared_mesh=True)``: finite losses; K1's
    plain version builds every training mesh once for the batch (batch 1)
    and every eval mesh per sample."""
    x, y = _data(11, b=4)
    launch = np.array(["2010-01-0%d" % (i + 1) for i in range(4)])
    loader = [(x[i:i + 2], y[i:i + 2], launch[i:i + 2]) for i in (0, 2)]
    tp = NextFramePredictorS2S(SHAPE, 0.2, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", run_dir=str(tmp_path),
                               model_kwargs=_model("GCNConv", remat=True),
                               graph_kwargs=dict(GRAPHS["blocks"]),
                               train_config=TrainConfig(shared_mesh=True, n_epochs=1))
    assert tp.shared_mesh
    builds = []
    real = tspmm.build_blocks_plain

    def spy(src_rel, *args):
        builds.append((tp.model.training, src_rel.shape[0]))
        return real(src_rel, *args)

    monkeypatch.setattr(tspmm, "build_blocks_plain", spy)
    tp.train(loader, loader, divergence_threshold=float("inf"))
    assert np.isfinite(tp.loss["train_loss"]).all() and np.isfinite(tp.loss["test_loss"]).all()
    assert {b for training, b in builds if training} == {1}
    assert {b for training, b in builds if not training} == {2}
