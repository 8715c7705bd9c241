"""bf16 ChebConv on a quadtree edge list (``aggregation="xla"``), port vs
JAX package, and the launch plan of the segment-sum kernel K7 that carries
that path's sums on the card.

The JAX package's xla aggregation multiplies each message by its Â
coefficient in bf16 and sums the messages with ``jax.ops.segment_sum`` in
bf16, rounding at every add; the port rounds the same products and sums
them in f32 (K7, or its plain version here), rounding once. The degrees
are summed from the f32 edge weights by both. So the two programs differ
by a few bf16 roundings of each aggregate, as on the Â-block path
(``tests/test_torch_bf16.py``), and the tolerances are that file's, for
the same reasons: the first frame within 2e-2 on average and 0.15
everywhere (the JAX package's own bound for bf16 against f32), one train
step's loss within 1e-2 relative and its gradients within 3e-2 ×
max(1, max|g|), on asserted-identical meshes.

K7's plan (``ops/segment_sum.py`` ``segment_plan``) is replayed in numpy:
every (row, feature) of every sample is summed exactly once, over its
bucket's entries in ascending entry order, and an f32 sum in that order
equals ``segment_sum_plain`` bit for bit; in the spans layout no CTA
stages more than its span and one row, on coarse and on fine meshes.
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
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph as t_image_to_graph
from quadtree_mpnnlstm_tpu_torch.ops import segment_sum as tseg
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

BF16 = torch.bfloat16
SHAPE = (16, 16)
T_IN, T_OUT = 2, 3
MODEL = dict(hidden_size=8, n_layers=1, n_conv_layers=1, dropout=0.0,
             convolution_type="ChebConv")
GRAPH = dict(max_grid_size=8, n_max=256, e_max=2048, node_budget=256, aggregation="xla")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _dataset():
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    return ModMovingMNISTDataset(2, T_IN, T_OUT, canvas_size=SHAPE, digit_size=(8, 8),
                                 pixel_noise=0.02, velocity_noise=0.0, seed=1)


def _jax_predictor(tf=0.0):
    return JPredictor(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                      teacher_forcing_ratio=tf,
                      model_kwargs=dict(MODEL, compute_dtype="bfloat16", remat=False),
                      graph_kwargs=dict(GRAPH))


def _port(weights, tf=0.0, run_dir="runs"):
    tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=T_IN, output_timesteps=T_OUT,
                               device="cpu", teacher_forcing_ratio=tf, run_dir=str(run_dir),
                               model_kwargs=dict(MODEL), graph_kwargs=dict(GRAPH),
                               train_config=TrainConfig(dtype="bfloat16"))
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
    return ds, weights, mesh, jp.gcfg, y_hat


def test_graph_build_bf16_on_the_edge_list_close_to_jax(jax_run):
    """The same quadtree and edge list from the same bf16 frames. The port
    sums the pooling in f32 and rounds once, the JAX package rounds every
    add (a mean of 64 positions moves by up to 2⁻⁴ on this seed), so the
    port's node positions, edge attributes and Â coefficients lie within
    one bf16 rounding (2⁻⁷ × max(1, max|ref|)) of the JAX package's f32
    build from the same frames, and no further from its bf16 build than
    that build lies from its f32 one, plus that rounding. The pooled node
    features within 2⁻⁷ × max(1, max|ref|) of the bf16 build's."""
    ds, weights, _, jcfg, _ = jax_run
    port = _port(weights)
    assert port.gcfg.aggregation == "xla" and port.gcfg.carry_edges
    tg, tdata = t_image_to_graph(t_posenc(torch.from_numpy(ds.x).to(BF16)), port.gcfg)
    assert tdata.dtype == tg.edge_attr.dtype == tg.sym_coeff.dtype == BF16
    for b in range(len(ds.x)):
        frames = jnp.asarray(ds.x[b], jnp.bfloat16)
        jg, jdata = j_image_to_graph(j_posenc(frames), jcfg)
        jf, _ = j_image_to_graph(j_posenc(frames.astype(jnp.float32)), jcfg)
        assert jdata.dtype == jg.edge_attr.dtype == jg.sym_coeff.dtype == jnp.bfloat16
        for name in ("pixel_node", "counts", "edge_src", "edge_dst", "edge_valid"):
            np.testing.assert_array_equal(getattr(tg, name)[b].numpy(),
                                          np.asarray(getattr(jg, name)), err_msg=name)
            np.testing.assert_array_equal(np.asarray(getattr(jf, name)),
                                          np.asarray(getattr(jg, name)), err_msg=name)
        ref = _f32(jdata)
        assert np.abs(_f32(tdata[b]) - ref).max() <= 2.0**-7 * max(1.0, np.abs(ref).max())
        for name in ("node_xy", "edge_attr", "sym_coeff"):
            got, jbf, jf32 = (_f32(getattr(g, name)) for g in (tg, jg, jf))
            got = got[b]
            one = 2.0**-7 * max(1.0, np.abs(jf32).max())
            assert np.abs(got - jf32).max() <= one, name
            assert np.abs(got - jbf).max() <= np.abs(jbf - jf32).max() + one, name


def test_forecast_bf16_on_the_edge_list_matches_jax_until_a_mesh_flips(jax_run):
    """The rollout against the JAX package's bf16 rollout, on its meshes:
    the encoder's mesh must agree, and frame t is compared while the mesh
    it was decoded on agrees, within (t + 1) × (2e-2 mean, 0.15 max) as on
    the Â-block path. On this seed the mesh built from sample 0's first
    frame flips a cell (156 nodes against 153): the JAX package's own bf16
    and f32 rollouts flip it too (first frames 0.059 apart at most), as
    bf16 rounding does near the threshold."""
    ds, weights, mesh, _, jy = jax_run
    tp = _port(weights)
    assert tp.cfg.compute_dtype == "bfloat16"
    y, overflow, meshes = tp.forecast(ds.x)
    assert y.dtype == torch.float32 and int(overflow.max()) == 0
    compared = 0
    for b in range(len(ds.x)):
        # the mesh of each step: the encoder's, then the one built from the
        # JAX package's previous bf16 frame
        want = [mesh(jnp.asarray(ds.x[b], jnp.bfloat16))]
        want += [mesh(jnp.asarray(jy[b, t][None], jnp.bfloat16)) for t in range(T_OUT - 1)]
        for t in range(T_OUT):
            same = np.array_equal(meshes[t, b].numpy(), np.asarray(want[t]))
            assert same or t > 0, f"sample {b}: the encoder's mesh differs"
            if not same:
                break
            err = np.abs(y[b, t].numpy() - jy[b, t])
            assert err.mean() <= 2e-2 * (t + 1) and err.max() <= 0.15 * (t + 1), \
                (b, t, err.mean(), err.max())
            compared += 1
    assert compared >= len(ds.x) + 2


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
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def test_train_step_bf16_on_the_edge_list_matches_jax(jax_run, tmp_path):
    """Teacher forcing 1.0 (every decoder mesh from the true frame, so both
    programs run on the same meshes), dropout 0: the loss within 1e-2
    relative, every gradient leaf within 3e-2 × max(1, max|g|)."""
    ds, weights, _, _, _ = jax_run
    j_loss, j_grads = _jax_loss_and_grad(weights, jnp.asarray(ds.x), jnp.asarray(ds.y))
    tp = _port(weights, tf=1.0, run_dir=tmp_path)
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


# ---------------------------------------------------------------- K7's plan


def _segment_case(kind, seed):
    """Ids (B, L) of one shape K7 meets: ``pooling`` (a quadtree's pixel
    view: compact node ids, each row 1-64 pixels, most of the n_out rows
    empty, reached through an unsorted view), ``fine`` (a detailed frame's
    mesh: mostly single pixels, a few leaves of 64 late in the rows),
    ``long`` (one bucket of 1100 entries, longer than any batch),
    ``hidden`` (one bucket of 400 entries among short ones), ``sorted`` (an
    edge list: ascending ids, 0-3 a row, sentinels last) and ``empty`` (a
    sample whose ids are all dropped beside one that is not)."""
    rng = np.random.default_rng(seed)
    if kind == "pooling":
        b, length, n_out = 3, 1024, 512
        ids = np.full((b, length), n_out)
        for i, nodes in enumerate((16, 40, 300)):
            sizes = rng.integers(1, 65, nodes)
            cells = np.repeat(np.arange(nodes), sizes)[:length]
            ids[i, :len(cells)] = cells
            ids[i] = rng.permutation(ids[i])
    elif kind == "fine":
        b, length, n_out = 2, 1024, 1024
        sizes = np.ones(700, np.int64)
        sizes[[400, 500, 650]] = 64
        cells = np.repeat(np.arange(700), sizes)[:length]
        ids = np.stack([rng.permutation(np.pad(cells, (0, length - len(cells)),
                                               constant_values=n_out)) for _ in range(b)])
    elif kind == "long":
        b, length, n_out = 2, 1500, 100
        ids = rng.integers(0, n_out + 5, (b, length))
        ids[:, :1100] = 7
        ids = np.stack([rng.permutation(r) for r in ids])
        ids[0, 3] = -1
    elif kind == "hidden":
        b, length, n_out = 2, 1200, 512
        ids = rng.integers(0, 300, (b, length))
        ids[:, :400] = 200
        ids = np.stack([rng.permutation(r) for r in ids])
    elif kind == "sorted":
        b, length, n_out = 2, 800, 300
        ids = np.sort(np.concatenate([np.repeat(np.arange(n_out), rng.integers(0, 4, n_out)),
                                      np.full(length, n_out)])[:length].reshape(1, -1)
                      .repeat(b, 0), axis=1)
    else:
        b, length, n_out = 2, 600, 200
        ids = rng.integers(0, n_out, (b, length))
        ids[1] = n_out
    return torch.from_numpy(ids), n_out, kind == "sorted"


def _replay(plan, offsets, f, length, batch_entries=97):
    """K7's walk of the CSR ``offsets`` (B, n_out + 1) under ``plan``, as
    csrc/segment.cu takes it: {(b, n, feature): [CSR positions in the
    order they are added]}, {(b, n, feature): stores} and, in the spans
    layout, the most entries a CTA staged beyond its span. The kernel's
    batch of staged entries is private to it (and witnessed by the card
    tests); the walk is the same for any, so a small one (``batch_entries``)
    exercises rows that run over several batches."""
    batch, n_out = offsets.shape[0], offsets.shape[1] - 1
    adds, stores, overhang = {}, {}, 0

    def store(b, n, feat):
        stores[(b, n, feat)] = stores.get((b, n, feat), 0) + 1

    if plan.route == "lanes":
        for b in range(batch):
            for n in range(n_out):
                for sub in range(plan.lanes):
                    for f0 in range(0, f, plan.lanes * tseg.LANES_PER_LANE):
                        if plan.vec > 1:
                            first = f0 + sub * plan.vec
                            feats = range(first, first + plan.vec) if first < f else ()
                        else:
                            feats = [g for g in range(f0 + sub, f0 + sub + plan.lanes
                                                      * tseg.LANES_PER_LANE, plan.lanes) if g < f]
                        for g in feats:
                            if offsets[b, n + 1] > offsets[b, n]:
                                adds.setdefault((b, n, g), []).extend(
                                    range(offsets[b, n], offsets[b, n + 1]))
                            store(b, n, g)
        return adds, stores, overhang
    span, vec = plan.span, plan.vec
    assert span * f <= tseg.SPAN_PAIRS and span * (f // vec) <= tseg.SPAN_LOADS
    ctas = max(1, -(-length // span))
    group = tseg.SPAN_PAIRS // f  # rows whose pairs the threads hold at once
    for b in range(batch):
        off = offsets[b].tolist()
        s0 = off[0]

        def first_row_at(x):
            return next((n for n in range(n_out) if off[n] - s0 >= x), n_out)

        for c in range(ctas):
            share = -(-n_out // ctas)
            for n in range(c * share, min(n_out, (c + 1) * share)):  # the zeros
                if off[n + 1] == off[n]:
                    for g in range(f):
                        store(b, n, g)
            n_lo, n_hi = first_row_at(c * span), first_row_at((c + 1) * span)
            overhang = max(overhang, off[n_hi] - off[n_lo] - span)
            for g0 in range(n_lo, n_hi, group):
                g1 = min(n_hi, g0 + group)
                for p0 in range(off[g0], off[g1], batch_entries):
                    nb = min(batch_entries, off[g1] - p0)
                    staged = np.full((nb, f), -1)
                    for q in range(nb * (f // vec)):  # one load an (entry, vector) pair
                        t, v = divmod(q, f // vec)
                        assert (staged[t, v * vec:(v + 1) * vec] == -1).all()
                        staged[t, v * vec:(v + 1) * vec] = p0 + t
                    assert (staged >= 0).all()
                    for q in range((g1 - g0) * f):  # the (row, feature) pairs
                        r, g = g0 + q // f, q % f
                        lo, hi = max(off[r], p0) - p0, min(off[r + 1], p0 + nb) - p0
                        if hi > lo:
                            adds.setdefault((b, r, g), []).extend(staged[lo:hi, g].tolist())
                for r in range(g0, g1):
                    if off[r + 1] > off[r]:
                        for g in range(f):
                            store(b, r, g)
    return adds, stores, overhang


@pytest.mark.parametrize("itemsize,align", [(4, 16), (4, 4), (2, 16), (2, 2)])
@pytest.mark.parametrize("f", [1, 3, 4, 12, 16, 32])
def test_segment_plan_sums_every_row_once_in_entry_order(f, itemsize, align):
    """On each kind of ids (``_segment_case``): every (row, feature) of
    every sample is stored once, and a non-empty one adds its bucket's CSR
    positions once each, ascending, which is ascending entry order (the
    view's order is stable); an f32 sum of the values in that order,
    rounded once to their dtype, is ``segment_sum_plain``'s bit for bit. In
    the spans layout a CTA stages at most one row's length beyond its span
    on every kind of mesh."""
    dtype = torch.float32 if itemsize == 4 else BF16
    for seed, kind in enumerate(("pooling", "fine", "long", "hidden", "sorted", "empty")):
        ids, n_out, sorted_ids = _segment_case(kind, seed)
        batch, length = ids.shape
        plan = tseg.segment_plan(f, itemsize, n_out, sorted_ids, align)
        assert plan.route == ("spans" if f <= 16 and not sorted_ids else "lanes")
        view = tseg.segment_view(ids, n_out, sorted_ids=sorted_ids)
        assert (view.order is None) == sorted_ids
        offsets = view.offsets.numpy().astype(np.int64)
        adds, stores, overhang = _replay(plan, offsets, f, length)
        assert set(stores) == {(b, n, g) for b in range(batch) for n in range(n_out)
                               for g in range(f)} and set(stores.values()) == {1}
        for (b, n, g), pos in adds.items():
            assert pos == list(range(offsets[b, n], offsets[b, n + 1])), (kind, b, n, g)
        assert len(adds) == f * int((np.diff(offsets, axis=1) > 0).sum())
        assert overhang <= int(np.diff(offsets, axis=1).max()), kind
        vals = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (batch, length, f)).astype(np.float32)).to(dtype)
        flat = vals.reshape(batch * length, f).float().numpy()
        entry = (np.arange(batch * length) if view.order is None
                 else view.order.numpy().astype(np.int64))
        out = np.zeros((batch, n_out, f), np.float32)
        for (b, n, g), pos in adds.items():
            acc = np.float32(0)
            for j in pos:
                acc = np.float32(acc + flat[entry[j], g])
            out[b, n, g] = acc
        want = tseg.segment_sum_plain(vals, ids, n_out)
        assert torch.equal(torch.from_numpy(out).to(dtype), want), kind


def test_segment_plan_layouts():
    """The layouts of the main path's sums: its pixel views (F 1, 3, 12, 16
    in f32 and bf16, 2048 rows a sample) take the spans layout, its degrees
    (sorted) the lanes layout; every sum of the pixelwise edge list (68,096
    rows: the sorted messages at F 1, 32, 256, the gathers by source, the
    pixel view) the lanes layout. The plan reads nothing but the shapes,
    the dtype, the view's kind and the alignment."""
    def plan(f, itemsize, n_out, sorted_ids=False, align=16):
        return tseg.segment_plan(f, itemsize, n_out, sorted_ids, align)

    assert plan(16, 4, 2048) == tseg.SegmentPlan("spans", 4, 256, 0)
    assert plan(16, 2, 2048) == tseg.SegmentPlan("spans", 8, 256, 0)
    assert plan(16, 2, 2048, align=2) == tseg.SegmentPlan("spans", 1, 128, 0)
    assert plan(12, 4, 2048) == plan(12, 2, 2048) == tseg.SegmentPlan("spans", 4, 256, 0)
    assert plan(3, 4, 2048) == plan(3, 2, 2048) == tseg.SegmentPlan("spans", 1, 512, 0)
    assert plan(1, 4, 2048) == tseg.SegmentPlan("spans", 1, 1024, 0)
    assert plan(1, 4, 2048, True) == tseg.SegmentPlan("lanes", 1, 0, 1)
    assert plan(1, 4, tseg.SPANS_MAX_N)[0] == "spans"
    assert plan(1, 4, 68096) == plan(1, 4, 68096, True) == tseg.SegmentPlan("lanes", 1, 0, 1)
    assert plan(6, 4, 68096) == tseg.SegmentPlan("lanes", 1, 0, 8)
    assert plan(32, 4, 68096, True) == plan(256, 4, 68096) == tseg.SegmentPlan("lanes", 1, 0, 32)
    assert plan(32, 2, 68096, True) == tseg.SegmentPlan("lanes", 8, 0, 4)
    assert plan(256, 2, 68096, True) == tseg.SegmentPlan("lanes", 8, 0, 32)
    assert plan(256, 2, 68096, True, align=8) == tseg.SegmentPlan("lanes", 1, 0, 32)
    for f in range(1, 17):
        for itemsize in (4, 2):
            for align in (16, 8, 4, 2):
                q = plan(f, itemsize, 100, align=max(align, itemsize))
                assert q.route == "spans" and f % q.vec == 0 and q.vec * itemsize <= 16
                assert q.span * f <= tseg.SPAN_PAIRS and q.span * f // q.vec <= tseg.SPAN_LOADS
                assert q.span * 2 * f > tseg.SPAN_PAIRS or q.span * 2 * f // q.vec > tseg.SPAN_LOADS \
                    or q.span == 1024
