"""Per-step remat (``remat``, ``models/seq2seq.py``): a train step under
every remat mode equals the step without it, bit for bit.

``"full"``, ``"mesh"`` and ``"dots"`` replay the forward of each step in
the backward (``torch.utils.checkpoint``), drawing their dropout masks and
scheduled-sampling coins from a copy of the caller's generator at the
state the step started from. The loss, every gradient leaf and the
caller's generator after the step must equal those of ``"none"`` exactly,
on Â blocks, attention windows, the grid and the edge list, in f32 and
bf16, with full BPTT and TBPTT 2, dropout 0.1 and teacher forcing 0.5.
Then the knob's values, and one step at ``remat=True`` against the JAX
package's (remat on both sides), ≤1e-4 × max(1, max|g|).
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
from quadtree_mpnnlstm_tpu_torch.config import NEG_INF
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import remat_mode
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

B, T_IN, T_OUT = 2, 2, 3
QUAD_SHAPE, PIXEL_SHAPE = (16, 16), (12, 20)
QUAD = dict(max_grid_size=8, n_max=256, e_max=2048, node_budget=256, agg_nt=128,
            agg_eb=1024, agg_sw=256)
# mesh → (convolution, shape, thresh, graph kwargs, climatology); the
# edge list is the pixelwise one (the ice-xla workload) in f32 and a
# quadtree one in bf16, the edge list bf16 runs on
MESHES = {
    "blocks": ("ChebConv", QUAD_SHAPE, 0.1, dict(QUAD, aggregation="pallas"), False),
    "windows": ("TransformerConv", QUAD_SHAPE, 0.1, dict(QUAD, aggregation="pallas"), False),
    "grid": ("TransformerConv", PIXEL_SHAPE, NEG_INF, dict(aggregation="grid"), True),
    "edge_list": ("TransformerConv", PIXEL_SHAPE, NEG_INF, dict(aggregation="xla"), True),
    "edge_list_bf16": ("ChebConv", QUAD_SHAPE, 0.1, dict(QUAD, aggregation="xla"), False),
}
CASES = [("blocks", "float32"), ("blocks", "bfloat16"), ("windows", "float32"),
         ("windows", "bfloat16"), ("grid", "float32"), ("grid", "bfloat16"),
         ("edge_list", "float32"), ("edge_list_bf16", "bfloat16")]


def _step(mesh, dtype, truncated, remat, run_dir):
    """(loss, overflow, {name: grad}, generator state after the step) of
    one train step from seeded weights, inputs and generator."""
    conv, shape, thresh, graph, clim = MESHES[mesh]
    pixelwise = thresh == NEG_INF
    tp = NextFramePredictorS2S(
        shape, thresh, decompose=not pixelwise, input_timesteps=T_IN, output_timesteps=T_OUT,
        device="cpu", seed=3, teacher_forcing_ratio=0.5, use_climatology=clim,
        run_dir=str(run_dir),
        model_kwargs=dict(hidden_size=8, n_layers=1 if pixelwise else 2, n_conv_layers=2,
                          dropout=0.1, convolution_type=conv, compute_dtype=dtype,
                          remat=remat),
        graph_kwargs=dict(graph))
    assert tp.model.remat == remat_mode(remat)
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    rng = np.random.default_rng(4)
    x = (rng.random((B, T_IN, *shape, 1)) ** 2).astype(np.float32)
    y = (rng.random((B, T_OUT, *shape, 1)) ** 2).astype(np.float32)
    mask = None
    if pixelwise:
        mask = rng.random(shape) < 0.15
        mask[:2] = True
    c = rng.random((B, T_OUT, *shape, 1)).astype(np.float32) if clim else None
    gen = torch.Generator().manual_seed(5)
    loss, overflow = tp.train_step(x, y, mask=mask, generator=gen, climatology=c,
                                   truncated_backprop=truncated)
    grads = {n: p.grad for n, p in tp.model.named_parameters() if p.grad is not None}
    return loss, overflow, grads, gen.get_state()


_REFERENCE = {}


@pytest.mark.parametrize("remat", ["full", "mesh", "dots"])
@pytest.mark.parametrize("truncated", [0, 2])
@pytest.mark.parametrize("mesh,dtype", CASES, ids=[f"{m}-{d}" for m, d in CASES])
def test_remat_step_equals_the_step_without_it(mesh, dtype, truncated, remat, tmp_path):
    key = (mesh, dtype, truncated)
    if key not in _REFERENCE:
        _REFERENCE[key] = _step(mesh, dtype, truncated, "none", tmp_path)
    loss_n, ovf_n, grads_n, gen_n = _REFERENCE[key]
    loss, ovf, grads, gen = _step(mesh, dtype, truncated, remat, tmp_path)
    assert torch.isfinite(loss) and torch.equal(loss, loss_n)
    assert torch.equal(ovf, ovf_n)
    assert sorted(grads) == sorted(grads_n) and len(grads) > 0
    for name, g in grads.items():
        assert torch.equal(g, grads_n[name]), name
    assert torch.equal(gen, gen_n), "the caller's generator advanced differently"


def test_remat_values():
    """The JAX package's values and default (True, full); anything else
    raises."""
    for value, mode in ((True, "full"), ("full", "full"), ("mesh", "mesh"), ("dots", "dots"),
                        (False, "none"), ("none", "none")):
        assert remat_mode(value) == mode
    for bad in ("partial", 1.5, None):
        with pytest.raises(ValueError, match="remat"):
            remat_mode(bad)
    tp = NextFramePredictorS2S(QUAD_SHAPE, 0.1, device="cpu",
                               model_kwargs=dict(convolution_type="ChebConv"))
    assert tp.model.remat == "full"
    off = NextFramePredictorS2S(QUAD_SHAPE, 0.1, device="cpu",
                                model_kwargs=dict(convolution_type="ChebConv", remat=False))
    assert off.model.remat == "none"


def test_forecast_runs_no_checkpoint(monkeypatch):
    """A forecast records no gradient, so no step is checkpointed."""
    import quadtree_mpnnlstm_tpu_torch.models.seq2seq as seq2seq

    def refuse(*args, **kw):
        raise AssertionError("checkpoint called in a no-grad forecast")

    monkeypatch.setattr(seq2seq, "checkpoint", refuse)
    tp = NextFramePredictorS2S(QUAD_SHAPE, 0.1, device="cpu", input_timesteps=T_IN,
                               output_timesteps=T_OUT,
                               model_kwargs=dict(convolution_type="ChebConv", hidden_size=8,
                                                 n_layers=1, n_conv_layers=1),
                               graph_kwargs=dict(QUAD, aggregation="pallas"))
    y, _, _ = tp.forecast(np.zeros((1, T_IN, *QUAD_SHAPE, 1), np.float32))
    assert torch.isfinite(y).all()


# ------------------------------------------------------------ vs JAX

J_MODEL = dict(hidden_size=8, n_layers=2, n_conv_layers=2, dropout=0.0,
               convolution_type="ChebConv")
J_T_OUT = 2


def test_remat_step_matches_jax_remat(tmp_path):
    """One full-BPTT train step with remat on both sides (the JAX
    predictor's default, ``remat=True``): the loss within 1e-5 and every
    clipped gradient within 1e-4 × max(1, max|g|) of
    ``jax.value_and_grad``, on meshes asserted identical first."""
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    graph = dict(QUAD, aggregation="pallas")
    ds = ModMovingMNISTDataset(B, T_IN, J_T_OUT, canvas_size=QUAD_SHAPE, digit_size=(8, 8),
                               pixel_noise=0.02, velocity_noise=0.0, seed=1)
    jp = JPredictor(QUAD_SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=J_T_OUT,
                    model_kwargs=dict(J_MODEL, remat=True), graph_kwargs=dict(graph))
    assert jp.model.remat is True
    jp._ensure_params()
    weights = jax.tree.map(np.asarray, jp.params)
    model = jp.model
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}

    def sample_loss(params, xb, yb):
        state = model.apply(params, xb, method=JSeq2Seq.encode, rngs=rngs)
        _, y_hat = model.apply(params, state, 0, J_T_OUT, yb, method=JSeq2Seq.decode,
                               rngs=rngs)
        return J_LOSSES["MSE"](y_hat, yb, None), y_hat

    def batch_loss(params):
        losses, y_hat = jax.vmap(lambda xb, yb: sample_loss(params, xb, yb))(
            jnp.asarray(ds.x), jnp.asarray(ds.y))
        return jnp.mean(losses), y_hat

    params = jax.tree.map(jnp.asarray, weights)
    (j_loss, j_frames), j_grads = jax.jit(jax.value_and_grad(batch_loss, has_aux=True))(params)
    clip = optax.clip_by_global_norm(10.0)
    j_grads, _ = clip.update(j_grads, clip.init(params))
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_grads))

    tp = NextFramePredictorS2S(QUAD_SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=J_T_OUT,
                               device="cpu", run_dir=str(tmp_path), model_kwargs=dict(J_MODEL),
                               graph_kwargs=dict(graph))
    assert tp.model.remat == "full"
    tp.load_jax_params(weights)
    mesh = jax.jit(lambda f: j_image_to_graph(j_posenc(f), jp.gcfg)[0].pixel_node)
    with torch.no_grad():
        state = tp.model.encode(torch.from_numpy(ds.x))
        _, _, meshes = tp.model.decode(state, J_T_OUT)
    for b in range(B):
        want = [mesh(jnp.asarray(ds.x[b])), mesh(jnp.asarray(np.asarray(j_frames)[b, :1]))]
        for t in range(J_T_OUT):
            np.testing.assert_array_equal(meshes[t, b].numpy(), np.asarray(want[t]))
    tp.initiate_training(lr=0.0, lr_decay=0.95)
    loss, overflow = tp.train_step(ds.x, ds.y)
    assert int(overflow) == 0
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    grads = {n: p.grad for n, p in tp.model.named_parameters()}
    assert sorted(grads) == sorted(j_grads)
    for name, g in grads.items():
        ref = j_grads[name]
        err = float((g - ref).abs().max())
        assert err <= 1e-4 * max(1.0, float(ref.abs().max())), (name, err)
