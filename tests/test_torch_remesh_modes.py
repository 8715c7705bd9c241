"""PyTorch port vs JAX package: the remeshing modes of ``Seq2Seq``.

``remesh_input`` (the encoder's first mesh from input frame 0, then a
remesh onto each next frame, the last step keeping its mesh) and
``remesh_every`` 2 and 3 (the decoder remeshes after step t when (t + 1)
% remesh_every == 0, else keeps the mesh with the current value as its
concat channel; a teacher-forced kept step appends the raw pixel count),
on ChebConv models on Â blocks and edge lists; a high-interest region on
``predict`` and on a train step; ``test_threshold``; every remat mode's
step bit for bit the step without remat under both modes.

Forecasts ≤1e-4 per pixel on meshes asserted identical to the JAX
package's at every step; train-step losses ≤1e-5 relative and gradients
≤1e-4 × max(1, max|g|) against ``jax.value_and_grad`` (teacher forcing
1.0, so both sides remesh on the true frames, with truncated-BPTT chunks
whose ``t0`` falls between remeshes). f32, dropout 0, the same weights.
"""

import sys

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.data.loader import ArrayDataset as JArrayDataset
from quadtree_mpnnlstm_tpu.data.loader import DataLoader as JDataLoader
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.data.loader import DataLoader
from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (16, 16)
B, T_IN, T_OUT = 2, 3, 5
MODEL = dict(hidden_size=8, n_layers=1, n_conv_layers=1, dropout=0.0,
             convolution_type="ChebConv")
GRAPHS = {
    "blocks": dict(max_grid_size=8, n_max=256, e_max=2048, node_budget=256,
                   aggregation="pallas", agg_nt=128, agg_eb=1024, agg_sw=256),
    "edge_list": dict(max_grid_size=8, n_max=256, e_max=2048, node_budget=256,
                      aggregation="xla"),
}
ROLLOUT_TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5, 1e-4


def _hir():
    """A diagonal band, as the JAX package's synthetic corridor."""
    yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1]]
    return np.abs(yy / SHAPE[0] - xx / SHAPE[1]) < 0.1


@pytest.fixture(scope="module")
def data():
    return ModMovingMNISTDataset(B, T_IN, T_OUT, canvas_size=SHAPE, digit_size=(8, 8),
                                 pixel_noise=0.02, velocity_noise=0.0, seed=1)


def _jax(graph, tf=0.0, remesh_input=False, remesh_every=1):
    jp = JPredictor(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                    teacher_forcing_ratio=tf, remesh_input=remesh_input,
                    model_kwargs=dict(MODEL, remesh_every=remesh_every, remat=False),
                    graph_kwargs=dict(GRAPHS[graph]))
    jp._ensure_params()
    return jp


def _port(jp, graph, tf=0.0, remesh_input=False, remesh_every=1, remat=False, run_dir="runs"):
    tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", teacher_forcing_ratio=tf,
                               remesh_input=remesh_input, run_dir=str(run_dir),
                               model_kwargs=dict(MODEL, remesh_every=remesh_every, remat=remat),
                               graph_kwargs=dict(GRAPHS[graph]))
    tp.load_jax_params(jax.tree.map(np.asarray, jp.params))
    return tp


def _mesh(gcfg, frames, hir=None):
    """The JAX package's node map of frames (T, rows, cols, 1)."""
    kw = {} if hir is None else dict(high_interest_region=jnp.asarray(hir))
    return np.asarray(j_image_to_graph(j_posenc(jnp.asarray(frames)), gcfg, **kw)[0].pixel_node)


def _expected_meshes(gcfg, x, frames, remesh_input, every, hir=None):
    """The JAX package's mesh of each decoder step of one sample: the
    encoder's last (with ``remesh_input`` the last input frame's, else all
    input frames'), then after each step t with (t + 1) % every == 0 the
    mesh of that step's frame."""
    current = _mesh(gcfg, x[-1:] if remesh_input else x, hir)
    out = []
    for t in range(T_OUT):
        out.append(current)
        if (t + 1) % every == 0:
            current = _mesh(gcfg, frames[t][None], hir)
    return out


@pytest.mark.parametrize("graph,remesh_input,every", [
    ("blocks", True, 1), ("edge_list", True, 1), ("blocks", False, 2), ("blocks", False, 3),
    ("edge_list", True, 2),
], ids=["remesh_input-blocks", "remesh_input-edge_list", "remesh_every-2", "remesh_every-3",
        "remesh_input-remesh_every-2-edge_list"])
def test_remesh_mode_forecast_matches_jax(data, graph, remesh_input, every):
    jp = _jax(graph, remesh_input=remesh_input, remesh_every=every)
    forecast = jax.jit(jax.vmap(lambda xb: jp.eval_model.apply(jp.params, xb)))
    jy = np.asarray(forecast(jnp.asarray(data.x)))
    tp = _port(jp, graph, remesh_input=remesh_input, remesh_every=every)
    y, overflow, meshes = tp.forecast(data.x)
    assert int(overflow.max()) == 0
    for b in range(B):
        want = _expected_meshes(jp.gcfg, data.x[b], jy[b], remesh_input, every)
        for t in range(T_OUT):
            np.testing.assert_array_equal(meshes[t, b].numpy(), want[t],
                                          err_msg=f"sample {b}, decoder step {t}")
    np.testing.assert_allclose(y.numpy(), jy, atol=ROLLOUT_TOL)


def _jax_loss_and_grad(jp, x, y, truncated, hir=None):
    model = jp.model
    chunks = jp._chunks(truncated)
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}
    hir_j = None if hir is None else jnp.asarray(hir)

    def sample_loss(params, xb, yb):
        total = 0.0
        for t0, n in chunks:
            state = model.apply(params, xb, high_interest_region=hir_j,
                                method=JSeq2Seq.encode, rngs=rngs)
            _, y_hat = model.apply(params, state, t0, n, yb[t0:t0 + n],
                                   high_interest_region=hir_j, method=JSeq2Seq.decode,
                                   rngs=rngs)
            total = total + J_LOSSES["MSE"](y_hat, yb[t0:t0 + n], None)
        return total

    def batch_loss(params):
        return jnp.mean(jax.vmap(lambda xb, yb: sample_loss(params, xb, yb))(x, y))

    loss, grads = jax.jit(jax.value_and_grad(batch_loss))(jp.params)
    clip = optax.clip_by_global_norm(10.0)
    grads, _ = clip.update(grads, clip.init(jp.params))
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("graph,remesh_input,every,truncated,hir", [
    ("blocks", False, 2, 3, True), ("blocks", False, 3, 2, False),
    ("edge_list", True, 2, 0, False),
], ids=["remesh_every-2-tbptt-3-hir", "remesh_every-3-tbptt-2",
        "remesh_input-remesh_every-2-edge_list"])
def test_teacher_forced_train_step_matches_jax(data, graph, remesh_input, every, truncated,
                                               hir, tmp_path):
    """Chunks (0, 3), (3, 2) at remesh_every 2 and (0, 2), (2, 2), (4, 1)
    at 3: the chunks from t0 3 and 4 start on steps that keep the mesh
    after the re-encode, so a chunk that lost the global step index
    would remesh at other steps."""
    region = _hir() if hir else None
    jp = _jax(graph, tf=1.0, remesh_input=remesh_input, remesh_every=every)
    j_loss, j_grads = _jax_loss_and_grad(jp, jnp.asarray(data.x), jnp.asarray(data.y),
                                         truncated, region)
    tp = _port(jp, graph, tf=1.0, remesh_input=remesh_input, remesh_every=every,
               run_dir=tmp_path)
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    loss, overflow = tp.train_step(data.x, data.y, truncated_backprop=truncated,
                                   high_interest_region=region)
    assert int(overflow) == 0
    assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    grads = {name: p.grad for name, p in tp.model.named_parameters()}
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        ref = j_grads[name]
        err = float((g - ref).abs().max())
        assert err <= GRAD_TOL * max(1.0, float(ref.abs().max())), (name, err)


def test_predict_with_high_interest_region_matches_jax(data):
    """The region reaches the encoder's mesh and every remesh (on both
    sides), and its meshes hold more nodes than the meshes without it."""
    hir = _hir()
    jp = _jax("blocks")
    loader = JDataLoader(JArrayDataset(data.x, data.y, data.launch_dates), batch_size=B)
    jy = jp.predict(loader, high_interest_region=hir)
    tp = _port(jp, "blocks")
    y = tp.predict(DataLoader(data, batch_size=B), high_interest_region=hir)
    np.testing.assert_allclose(y, jy, atol=ROLLOUT_TOL)
    _, _, with_hir = tp.forecast(data.x, high_interest_region=hir)
    _, _, without = tp.forecast(data.x)
    for t in range(T_OUT):
        for b in range(B):
            assert with_hir[t, b].max() > without[t, b].max(), (t, b)
    for b in range(B):
        want = _expected_meshes(jp.gcfg, data.x[b], jy[b], False, 1, hir)
        for t in range(T_OUT):
            np.testing.assert_array_equal(with_hir[t, b].numpy(), want[t])


def test_train_passes_the_region_and_preset_to_every_step(data, monkeypatch, tmp_path):
    """``train`` hands ``high_interest_region`` and ``graph_structure`` to
    every train step and every test-loss forecast."""
    jp = _jax("blocks")
    tp = _port(jp, "blocks", run_dir=tmp_path)
    hir, seen = _hir(), []
    step, forecast = tp.train_step, tp.forecast

    def spy(fn, kind):
        def call(*a, **kw):
            seen.append((kind, kw["high_interest_region"] is hir, kw["graph_structure"]))
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(tp, "train_step", spy(step, "step"))
    monkeypatch.setattr(tp, "forecast", spy(forecast, "forecast"))
    loader = DataLoader(data, batch_size=1)
    tp.train(loader, loader, n_epochs=1, high_interest_region=hir,
             divergence_threshold=float("inf"))
    assert sorted(k for k, _, _ in seen) == ["forecast"] * B + ["step"] * B
    assert all(same and gs is None for _, same, gs in seen)
    assert np.isfinite(tp.train_loss[0])


@pytest.mark.parametrize("thresh", [0.05, 0.2, 0.5])
def test_test_threshold_matches_jax(data, monkeypatch, thresh):
    """Without matplotlib both packages return (reconstruction, labels);
    the labels are the same node map and the reconstructions agree to
    1e-6. The grid backend falls back to the edge list for a quadtree
    threshold on both sides."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    mask = np.zeros(SHAPE, bool)
    mask[:, :2] = True
    jp = JPredictor(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                    model_kwargs=dict(MODEL), graph_kwargs=dict(GRAPHS["blocks"]))
    j_recon, j_labels = jp.test_threshold(data.x[0], thresh, mask=mask,
                                          high_interest_region=_hir())
    tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", model_kwargs=dict(MODEL),
                               graph_kwargs=dict(GRAPHS["blocks"]))
    recon, labels = tp.test_threshold(data.x[0], thresh, mask=mask, high_interest_region=_hir())
    np.testing.assert_array_equal(labels, j_labels)
    assert recon.shape == j_recon.shape == (T_IN, *SHAPE, 1)
    np.testing.assert_allclose(recon, j_recon, atol=1e-6)
    grid = dict(max_grid_size=4, aggregation="grid")
    jg = JPredictor((12, 20), 0.1, decompose=False, model_kwargs=dict(MODEL),
                    graph_kwargs=dict(grid))
    tg = NextFramePredictorS2S((12, 20), 0.1, decompose=False, device="cpu",
                               model_kwargs=dict(MODEL), graph_kwargs=dict(grid))
    x = (np.random.default_rng(0).random((2, 12, 20, 1)) ** 4).astype(np.float32)
    j_recon, j_labels = jg.test_threshold(x, thresh)
    recon, labels = tg.test_threshold(x, thresh)
    np.testing.assert_array_equal(labels, j_labels)
    np.testing.assert_allclose(recon, j_recon, atol=1e-6)


def _remat_step(remat, remesh_input, every, run_dir):
    """(loss, {name: grad}, generator state after) of one seeded step
    with dropout 0.1, teacher forcing 0.5 and TBPTT 2."""
    tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", seed=3, teacher_forcing_ratio=0.5,
                               remesh_input=remesh_input, run_dir=str(run_dir),
                               model_kwargs=dict(MODEL, dropout=0.1, remesh_every=every,
                                                 remat=remat),
                               graph_kwargs=dict(GRAPHS["blocks"]))
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    rng = np.random.default_rng(4)
    x = (rng.random((B, T_IN, *SHAPE, 1)) ** 2).astype(np.float32)
    y = (rng.random((B, T_OUT, *SHAPE, 1)) ** 2).astype(np.float32)
    gen = torch.Generator().manual_seed(5)
    loss, _ = tp.train_step(x, y, generator=gen, truncated_backprop=2)
    grads = {n: p.grad for n, p in tp.model.named_parameters() if p.grad is not None}
    return loss, grads, gen.get_state()


@pytest.mark.parametrize("remat", ["full", "mesh", "dots"])
@pytest.mark.parametrize("remesh_input,every", [(True, 1), (False, 2)],
                         ids=["remesh_input", "remesh_every-2"])
def test_remat_step_equals_the_step_without_it(remesh_input, every, remat, tmp_path):
    loss_n, grads_n, gen_n = _remat_step("none", remesh_input, every, tmp_path)
    loss, grads, gen = _remat_step(remat, remesh_input, every, tmp_path)
    assert torch.isfinite(loss) and torch.equal(loss, loss_n)
    assert sorted(grads) == sorted(grads_n) and len(grads) > 0
    for name, g in grads.items():
        assert torch.equal(g, grads_n[name]), name
    assert torch.equal(gen, gen_n), "the caller's generator advanced differently"


def test_mesh_remat_keeps_the_encoders_meshes_out_of_the_replay(monkeypatch, tmp_path):
    """Under ``"mesh"`` remat a ``remesh_input`` step builds each encoder
    mesh once (T_IN of them; no replay rebuilds one), under ``"full"``
    the backward builds every mesh after the first again."""
    from quadtree_mpnnlstm_tpu_torch.models import seq2seq

    builds, real = {}, seq2seq.image_to_graph
    for remat in ("mesh", "full"):
        calls = []
        monkeypatch.setattr(seq2seq, "image_to_graph",
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
        tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=1,
                                   device="cpu", remesh_input=True, run_dir=str(tmp_path),
                                   model_kwargs=dict(MODEL, remat=remat),
                                   graph_kwargs=dict(GRAPHS["blocks"]))
        tp.initiate_training(lr=0.0, lr_decay=0.95)
        x = np.random.default_rng(0).random((1, T_IN, *SHAPE, 1)).astype(np.float32)
        tp.train_step(x, x[:, :1])
        builds[remat] = len(calls)
    # T_IN encoder meshes and 1 decoder remesh; "full" replays the
    # T_IN − 1 encoder remeshes and the decoder's
    assert builds == {"mesh": T_IN + 1, "full": T_IN + 1 + T_IN - 1 + 1}
