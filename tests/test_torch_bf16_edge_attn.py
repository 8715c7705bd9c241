"""PyTorch port vs JAX package: bf16 attention on edge lists
(``compute_dtype="bfloat16"`` with TransformerConv on the pixelwise edge
list, the JAX package's ``ice-xla`` workload at ``bench.py``'s default
dtype, and on a quadtree edge list without attention windows).

The edge-list branch gathers q, k and v, adds the edge term ``edge_attr ·
Wₑ`` to keys and values, takes the logits ``q·(k + e)/√d``, the masked
edge softmax and its keep-scales, and sums ``α·(v + e)`` at the
destinations, all in the compute dtype (the keep-scales cast to α's dtype,
as the JAX package casts them). The JAX package's XLA sums the softmax
denominators and the messages in bf16, rounding at every add; the port
sums them in f32 and rounds once (``segment_sum_plain`` here, K7 on the
card). So the two bf16 programs differ by a few bf16 roundings of each
sum, and, as in ``tests/test_torch_bf16.py``, each test states its bound
and why.

* the branch against the JAX branch on bf16 q, k, v and Wₑ over a masked
  24×32 pixelwise edge list built by each package from the same bf16
  frames, without and with a bf16 keep injected from numpy, forward and
  gradients;
* training-mode edge attention with dropout returns bf16 (its f32
  keep-scales used to promote the messages and the whole sum to f32);
* a pixelwise edge-list forecast with climatology, and a teacher-forced
  step's loss and gradients, gated as ``tests/test_torch_bf16_grid.py``
  gates them;
* TransformerConv on a quadtree edge list in bf16: the forecast until a
  mesh flips.
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
from quadtree_mpnnlstm_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
from quadtree_mpnnlstm_tpu.ops import segment as jseg
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.train.losses import LOSSES as J_LOSSES
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig, ModelConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import Seq2Seq
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

BF16 = torch.bfloat16
ULP = 2.0**-7  # one bf16 rounding, relative
SHAPE = (24, 32)
B = 2
EDGE_LIST = dict(image_shape=SHAPE, thresh=NEG_INF, aggregation="xla", use_edge_attrs=True)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(ref, rel):
    return rel * max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))


def _mask():
    mask = np.random.default_rng(0).random(SHAPE) < 0.2
    mask[:3, :5] = True
    return mask


@pytest.fixture(scope="module")
def meshes():
    """The pixelwise edge list of both packages, built from bf16 frames:
    the edge attributes in bf16, the ids and validity identical."""
    x = np.random.default_rng(1).random((B, 2, *SHAPE, 3)).astype(np.float32)
    mask = _mask()
    tg, _ = image_to_graph(t_posenc(torch.from_numpy(x).to(BF16)), GraphConfig(**EDGE_LIST),
                           mask=torch.from_numpy(mask))
    jgs = [j_image_to_graph(j_posenc(jnp.asarray(x[b], jnp.bfloat16)),
                            JGraphConfig(**EDGE_LIST), mask=jnp.asarray(mask))[0]
           for b in range(B)]
    assert tg.edge_attr.dtype == BF16
    for b, jg in enumerate(jgs):
        assert jg.edge_attr.dtype == jnp.bfloat16
        for name in ("edge_src", "edge_dst", "edge_valid"):
            np.testing.assert_array_equal(getattr(tg, name)[b].numpy(),
                                          np.asarray(getattr(jg, name)), err_msg=name)
        np.testing.assert_array_equal(_f32(tg.edge_attr[b]), _f32(jg.edge_attr))
    return tg, jgs


def _feats(seed, width, n, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((B, n, width))).astype(np.float32)


def _jax_attention(q, k, v, we, jg, heads, d, keep):
    """The JAX package's edge-list branch in bf16: the function itself
    without dropout, else its own primitives with the bf16 keep-scales
    (E, heads) injected where it draws them."""
    if keep is None:
        return jconv.multi_stream_attention(q, k, v, we, jg, heads, d)[0]
    n = jg.n_max
    e = (jg.edge_attr.astype(q.dtype) @ we).reshape(-1, heads, d)
    kj = jseg.gather_src(k.reshape(n, heads, d), jg) + e
    vj = jseg.gather_src(v.reshape(n, heads, d), jg) + e
    logits = jnp.sum(jseg.gather_dst(q.reshape(n, heads, d), jg) * kj, axis=-1) / jnp.sqrt(
        jnp.asarray(d, q.dtype))
    alpha = jseg.edge_softmax_graph(logits, jg)
    return jseg.aggregate_to_dst((alpha * keep)[..., None] * vj, jg)


@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("heads,d", [(8, 4), (1, 4), (1, 1)])
def test_edge_list_attention_bf16_matches_jax(meshes, heads, d, with_keep):
    """Forward and the gradients of q, k, v and Wₑ in bf16 against the
    JAX branch's. A bf16 output is the sum of up to four messages α·(v +
    e), each from a chain of bf16 roundings (the edge term, k + e, the
    logit, exp, the denominator, α, the keep, the product), and JAX rounds
    the sum at every add where the port rounds once: within 3 bf16
    roundings of max(1, max|ref|) (1.4 seen). The gradients run the same
    chain backwards through the gathers' sums (the softmax's cotangent
    sums twice over a destination's edges, dWₑ over every edge): within 6
    (3.1 seen)."""
    tg, jgs = meshes
    n, hd = tg.n_max, heads * d
    bf = lambda a: torch.from_numpy(a).to(BF16)  # noqa: E731
    q, k, v = (_feats(s, hd, n) for s in (1, 2, 3))
    we = _feats(4, hd, 2)[0]
    cot = _feats(5, hd, n)
    keep = None
    if with_keep:
        u = np.random.default_rng(6).random((B, tg.edge_src.shape[1], heads))
        keep = ((u < 0.9) / 0.9).astype(np.float32)
    leaves = [bf(a).requires_grad_(True) for a in (q, k, v, we)]
    out = tconv.edge_attention(*leaves, tg, heads, d, None if keep is None else bf(keep))
    assert out.dtype == BF16
    grads = torch.autograd.grad(out, leaves, bf(cot).reshape(B, n, heads, d))
    assert all(g.dtype == BF16 for g in grads)
    out = _f32(out).reshape(B, n, hd)
    jwe = 0.0  # dWₑ sums over the batch
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    for b, jg in enumerate(jgs):
        kb = None if keep is None else jb(keep[b])

        def loss(q_, k_, v_, we_, b=b, jg=jg, kb=kb):
            o = _jax_attention(q_, k_, v_, we_, jg, heads, d, kb)
            return jnp.sum(o.reshape(n, hd).astype(jnp.float32) * cot[b]), o

        (_, ref), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
            jb(q[b]), jb(k[b]), jb(v[b]), jb(we))
        assert ref.dtype == jnp.bfloat16
        ref = _f32(ref).reshape(n, hd)
        assert np.abs(out[b] - ref).max() <= _tol(ref, 3 * ULP)
        for name, mine, r in zip("qkv", grads[:3], jgrads[:3]):
            r = _f32(r)
            assert np.abs(_f32(mine[b]) - r).max() <= _tol(r, 6 * ULP), name
        jwe = jwe + _f32(jgrads[3])
    assert np.abs(_f32(grads[3]) - jwe).max() <= _tol(jwe, 6 * ULP)


def test_training_edge_attention_with_dropout_stays_bf16(meshes):
    """TransformerConv in training mode on the edge list, attention dropout
    0.1 from the generator: the output, the keep-scaled messages and their
    sum stay bf16, and so does every gradient of a bf16 input."""
    tg, _ = meshes
    conv = tconv.TransformerConv(8, 8, heads=2, concat=False, dropout=0.1, edge_dim=2,
                                 dtype=BF16).train()
    x = torch.from_numpy(_feats(7, 8, tg.n_max)).to(BF16).requires_grad_(True)
    seen = []
    aggregate = tconv.aggregate_to_dst

    def spy(messages, graph):
        seen.append(messages.dtype)
        return aggregate(messages, graph)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconv, "aggregate_to_dst", spy)
        out = conv(x, tg, torch.Generator().manual_seed(0))
    assert seen == [BF16] and out.dtype == BF16
    out.float().square().sum().backward()
    assert x.grad.dtype == BF16
    with torch.no_grad():  # the keep reached the output: eval mode differs
        assert not torch.equal(out, conv.eval()(x, tg))


# ---------------------------------------------------------------- Seq2Seq

VARS, T_IN, T_OUT = 5, 3, 4
MODEL = dict(hidden_size=8, dropout=0.0, input_features=VARS, input_timesteps=T_IN,
             output_timesteps=T_OUT, n_layers=1, n_conv_layers=2,
             convolution_type="TransformerConv")


@pytest.fixture(autouse=True)
def no_attention_dropout(monkeypatch):
    """Attention dropout off in both registries: the two frameworks draw
    other random numbers."""
    for registry in (jconv.CONVOLUTION_KWARGS, tconv.CONVOLUTION_KWARGS):
        monkeypatch.setitem(registry, "TransformerConv",
                            dict(registry["TransformerConv"], dropout=0.0))


def _nonzero_biases(params, seed):
    rng = np.random.default_rng(seed)

    def fill(path, v):
        name = str(path[-1].key)
        if name == "bias" or name.startswith("b_"):
            return (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        return np.asarray(v)

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.fixture(scope="module")
def pixelwise():
    rng = np.random.default_rng(4)
    x = rng.random((B, T_IN, *SHAPE, VARS)).astype(np.float32)
    y = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    clim = rng.random((B, T_OUT, *SHAPE, 1)).astype(np.float32)
    jm = JSeq2Seq(JModelConfig(**MODEL, compute_dtype="bfloat16"), JGraphConfig(**EDGE_LIST),
                  use_climatology=True)
    weights = _nonzero_biases(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x[0]), None, jnp.asarray(clim[0]),
        jnp.asarray(_mask()))), 1)
    return x, y, clim, _mask(), jm, weights


def _port_model(weights, dtype):
    model = Seq2Seq(ModelConfig(**MODEL, compute_dtype=dtype), GraphConfig(**EDGE_LIST),
                    use_climatology=True).eval()
    model.load_state_dict(params_from_jax(weights))
    return model


def test_pixelwise_edge_list_rollout_with_climatology_bf16_matches_jax(pixelwise):
    """The bf16 rollout on the fixed pixelwise edge list with climatology
    against the JAX package's, same weights: frame t within (t + 1) × 2e-2
    on average and (t + 1) × 0.15 at most (the bounds of the bf16
    forecasts on quadtrees, ``tests/test_torch_bf16.py``) or, where larger,
    within the distance of the JAX bf16 frame from the f32 one (the port's
    f32 rollout, which the f32 edge-list tests hold to the JAX package's
    within 1e-4): two bf16 programs that round at other places differ by
    about as much as bf16 and f32 do. The port's bf16 frames against its
    own f32 ones: the first within 2e-2 on average."""
    x, _, clim, mask, jm, weights = pixelwise
    t = torch.from_numpy
    ys = {}
    for dtype in ("bfloat16", "float32"):
        with torch.no_grad():
            ys[dtype] = _port_model(weights, dtype).rollout(
                t(x), mask=t(mask), climatology=t(clim))[0]
    y16, y32 = ys["bfloat16"], ys["float32"].numpy()
    assert y16.dtype == torch.float32 and y16.shape == (B, T_OUT, *SHAPE, 1)
    apply = jax.jit(lambda xb, cb: jm.apply(weights, xb, None, cb, jnp.asarray(mask)))
    ref = np.stack([np.asarray(apply(jnp.asarray(x[b]), jnp.asarray(clim[b])))
                    for b in range(B)])
    assert ref.dtype == np.float32
    for step in range(T_OUT):
        err = np.abs(y16[:, step].numpy() - ref[:, step])
        spread = np.abs(y32[:, step] - ref[:, step])
        assert err.mean() <= max(2e-2 * (step + 1), spread.mean()), (step, err.mean())
        assert err.max() <= max(0.15 * (step + 1), spread.max()), (step, err.max())
    assert float(np.abs(y16[:, 0].numpy() - y32[:, 0]).mean()) <= 2e-2


def _jax_loss_and_grads(jm, weights, x, y, clim, mask):
    """(loss, clipped gradients as a port state_dict) of one teacher-forced
    step of the JAX package's bf16 model."""
    m = jnp.asarray(mask)
    rngs = {"dropout": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}
    jm = jm.clone(teacher_forcing_ratio=1.0)

    def sample_loss(params, xb, yb, cb):
        state = jm.apply(params, xb, mask=m, method=JSeq2Seq.encode, rngs=rngs)
        _, y_hat = jm.apply(params, state, 0, T_OUT, yb, cb, m, method=JSeq2Seq.decode,
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


def test_pixelwise_edge_list_train_step_bf16_matches_jax(pixelwise, tmp_path):
    """One teacher-forced (ratio 1.0) full-BPTT bf16 step with climatology
    on the pixelwise edge list, dropout 0: the loss within 1e-2 relative
    of the JAX package's bf16 loss, and the whole gradient (every leaf as
    one vector) no further, in L2 norm, from the f32 gradient than 3 × the
    JAX package's own bf16 gradient is (``tests/test_torch_bf16_grid.py``'s
    gate: at this size the gradients are small sums of large cancelling
    terms, so bf16 moves them far in both packages; a lost cast or a wrong
    bf16 formula moves the gradient by its whole norm). The f32 gradient
    is the port's f32 step, which ``tests/test_torch_edge_list_model.py``
    holds to ``jax.value_and_grad`` within 1e-4."""
    x, y, clim, mask, jm, weights = pixelwise
    j_loss, j_grads = _jax_loss_and_grads(jm, weights, x, y, clim, mask)
    steps = {}
    for dtype in ("bfloat16", "float32"):
        tp = NextFramePredictorS2S(SHAPE, device="cpu", run_dir=str(tmp_path),
                                   thresh=NEG_INF, decompose=False, input_features=VARS,
                                   input_timesteps=T_IN, output_timesteps=T_OUT,
                                   use_climatology=True, teacher_forcing_ratio=1.0,
                                   model_kwargs=dict(
                                       {k: v for k, v in MODEL.items()
                                        if k not in ("input_features", "input_timesteps",
                                                     "output_timesteps")},
                                       compute_dtype=dtype, remat=False),
                                   graph_kwargs=dict(aggregation="xla"))
        tp.load_jax_params(weights)
        tp.initiate_training(lr=0.0, lr_decay=0.95)
        loss, overflow = tp.train_step(x, y, mask=mask, climatology=clim)
        assert int(overflow) == 0 and loss.dtype == torch.float32
        steps[dtype] = (float(loss), {n: p.grad for n, p in tp.model.named_parameters()})
    loss16, g16 = steps["bfloat16"]
    g32 = steps["float32"][1]
    assert abs(loss16 - j_loss) <= 1e-2 * abs(j_loss)
    assert set(g16) == set(j_grads) == set(g32)
    assert all(g.dtype == torch.float32 for g in g16.values())
    dist = lambda a: sum(float(((a[n] - g32[n]) ** 2).sum()) for n in g32) ** 0.5  # noqa: E731
    assert dist(g16) <= 3 * dist(j_grads), (dist(g16), dist(j_grads))


# ---------------------------------------------------------------- quadtree

QT_SHAPE = (16, 16)
QT_MODEL = dict(hidden_size=8, n_layers=1, n_conv_layers=2, convolution_type="TransformerConv",
                dropout=0.0)
QT_GRAPH = dict(max_grid_size=4, n_max=256, e_max=2048, aggregation="xla")


def test_transformer_conv_on_a_quadtree_edge_list_bf16_matches_jax():
    """TransformerConv in bf16 on ``xla`` quadtree meshes (no attention
    windows), a remesh every decoder step: the port's forecast against the
    JAX package's bf16 forecast while the mesh of each step is the one the
    JAX package's previous frame gives, within (t + 1) × (2e-2 mean, 0.15
    max), the bounds of ``tests/test_torch_bf16_edge_list.py``."""
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    ds = ModMovingMNISTDataset(B, 3, 3, canvas_size=QT_SHAPE, digit_size=(8, 8),
                               pixel_noise=0.02, velocity_noise=0.0, seed=4)
    jp = JPredictor(QT_SHAPE, 0.1, input_timesteps=3, output_timesteps=3,
                    model_kwargs=dict(QT_MODEL, compute_dtype="bfloat16", remat=False),
                    graph_kwargs=dict(QT_GRAPH))
    jp._ensure_params()
    weights = _nonzero_biases(jax.tree.map(np.asarray, jp.params), 2)
    jy = np.asarray(jax.jit(jax.vmap(lambda xb: jp.eval_model.apply(weights, xb)))(
        jnp.asarray(ds.x)))
    tp = NextFramePredictorS2S(QT_SHAPE, 0.1, input_timesteps=3, output_timesteps=3,
                               device="cpu", graph_kwargs=dict(QT_GRAPH),
                               model_kwargs=dict(QT_MODEL, compute_dtype="bfloat16"))
    assert tp.gcfg.aggregation == "xla" and not tp.gcfg.attn_windows and tp.gcfg.carry_edges
    tp.load_jax_params(weights)
    y, overflow, meshes = tp.forecast(ds.x)
    assert y.dtype == torch.float32 and int(overflow.max()) == 0
    mesh = jax.jit(lambda frames: j_image_to_graph(j_posenc(frames), jp.gcfg)[0].pixel_node)
    compared = 0
    for b in range(B):
        want = [mesh(jnp.asarray(ds.x[b], jnp.bfloat16))]
        want += [mesh(jnp.asarray(jy[b, t][None], jnp.bfloat16)) for t in range(2)]
        for t in range(3):
            same = np.array_equal(meshes[t, b].numpy(), np.asarray(want[t]))
            assert same or t > 0, f"sample {b}: the encoder's mesh differs"
            if not same:
                break
            err = np.abs(y[b, t].numpy() - jy[b, t])
            assert err.mean() <= 2e-2 * (t + 1) and err.max() <= 0.15 * (t + 1), \
                (b, t, err.mean(), err.max())
            compared += 1
    assert compared >= B + 1 and len(np.unique(meshes[0, 0].numpy())) > 20
