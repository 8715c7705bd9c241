"""Data parallelism in the port (``parallel/``, ``NextFramePredictorS2S(
dp_devices=N)``) on the CPU: two gloo ranks, spawned once for the whole
file (``tests/torch_dp_workers.py`` ``dp_worker``), against the JAX
predictor's ``dp_devices=2`` steps from the same weights (carried across
by ``utils/weights.py``) at dropout 0, for full BPTT and ``shared_mesh``,
and against the port's one-process ``train_step`` on the same global
batches in every scenario, dropout 0.1 too, where the two packages'
masks differ by design.

The tolerances are the JAX package's own (``tests/test_parallel.py``):
the loss rtol 1e-5, every parameter rtol 1e-4 / atol 1e-6 after two
steps; each step's gradients are held to the same, since Adam's first
steps hide a gradient's scale. With dropout 0.1 each rank draws what one
device draws for its rows, so the data-parallel step equals the
one-process step there too, and no two ranks share a mask.

The first step's gradients, from the same weights in both runs, are also
held per parameter tensor, and each weight to that rtol / atol plus twice Adam's first-order response to the measured
gradient difference (``torch_dp_workers.hold_to_one_process``): a
gradient that is zero but for rounding (the attention models' key
biases, since softmax ignores a shift of all logits) takes a step that
Adam's per-entry scaling draws from that rounding, which the order of
the sums decides (two shard means averaged, or one mean). Seen at most
here: 0.04 of the first gradients' allowance and 0.42 of the weights'."""

import os
import pickle

import numpy as np
import pytest
import torch

import torch_dp_workers as w
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import dropout
from quadtree_mpnnlstm_tpu_torch.parallel import dp, mesh
from quadtree_mpnnlstm_tpu_torch.train.predictor import CLIP_NORM, clip_by_global_norm_
from quadtree_mpnnlstm_tpu_torch.utils import draws
from quadtree_mpnnlstm_tpu_torch.utils.weights import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 2
LR = 0.01
INDIVISIBLE = "global batch 3 not divisible by dp_devices=2 (use drop_last=True)"


def _plain_tree(tree):
    """A flax parameter tree as nested dicts of numpy arrays, which a rank
    unpickles without JAX."""
    if hasattr(tree, "items"):
        return {k: _plain_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def jax_dp(tmp_path_factory):
    """The JAX predictor with ``dp_devices=2`` (``shard_map`` over two of
    the host's virtual devices, Pallas in interpret mode) on the global
    batches: its initial weights, and per scenario of
    :data:`torch_dp_workers.JAX_SCENARIOS` its losses and weights after
    two steps."""
    import jax
    import jax.numpy as jnp

    from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor

    cwd, weights, runs = os.getcwd(), None, {}
    os.chdir(tmp_path_factory.mktemp("jax_dp"))  # its metrics writer opens runs/ here
    try:
        for name in w.JAX_SCENARIOS:
            model_kw, graph_kw, kw, _ = w.SCENARIOS[name]
            jp = JPredictor(w.SHAPE, 0.3, input_timesteps=w.T_IN, output_timesteps=w.T_OUT,
                            seed=w.SEED, dp_devices=WORLD,
                            model_kwargs=dict(hidden_size=4, n_layers=1, n_conv_layers=1,
                                              remat=False, **model_kw),
                            graph_kwargs=dict(w.GRAPH, **graph_kw), **kw)
            if weights is not None:
                jp.params = jax.tree.map(jnp.asarray, weights)
            jp.initiate_training(lr=LR, lr_decay=0.95)
            jp._set_lr()
            weights = _plain_tree(jp.params)
            step = jp._get_train_step(False, 0)
            params, opt_state, losses = jp.params, jp.opt_state, []
            clim = jnp.zeros((w.BATCH, w.T_OUT, *w.SHAPE, 1))
            mask = jnp.zeros(w.SHAPE, bool)
            for x, y in w.batches():
                params, opt_state, loss, aux = step(params, opt_state, jnp.asarray(x),
                                                    jnp.asarray(y), clim, mask, mask, None,
                                                    jax.random.PRNGKey(0))
                assert int(aux["mesh_overflow"]) == 0
                losses.append(float(loss))
            runs[name] = (losses, _plain_tree(params))
    finally:
        os.chdir(cwd)
    return weights, runs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_dp):
    """Rank 0's report of :func:`torch_dp_workers.dp_worker` on two gloo
    ranks (one spawn for the file)."""
    root = tmp_path_factory.mktemp("dp")
    path = root / "jax_weights.pkl"
    path.write_bytes(pickle.dumps(jax_dp[0]))
    return dp.launch(w.dp_worker, WORLD, backend="gloo", device="cpu",
                     args=(str(root), str(path)), timeout=600)


@pytest.mark.parametrize("name", w.JAX_SCENARIOS)
def test_dp_step_matches_the_jax_predictor(ranks, jax_dp, tmp_path, name):
    """Two gloo ranks of the port against the JAX predictor's
    ``dp_devices=2`` step (JAX ``test_dp_through_predictor_api_matches_
    single_device``'s tolerances), from the same weights on the same
    global batches."""
    got = ranks["jax_" + name]
    losses, params = jax_dp[1][name]
    assert got["replicas_equal"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    pred = w.make_predictor(name, str(tmp_path))
    state = params_from_jax(params, fuse_gates=pred.cfg.fused_gates)
    want = np.concatenate([state[n].reshape(-1).numpy() for n, _ in pred.model.named_parameters()])
    np.testing.assert_allclose(got["params"], want, rtol=1e-4, atol=1e-6)


def _one_process(name: str, run_dir: str):
    """The scenario on one process: ``train_step`` on the global batches,
    or, under ``shared_mesh``, each shard's forward and backward on its own
    mesh with the shard gradients averaged, as the ranks compute it."""
    pred = w.make_predictor(name, run_dir)
    pred.initiate_training(lr=LR, lr_decay=0.95)
    step_kw = w.SCENARIOS[name][3]
    losses, grads = [], []
    for x, y in w.batches():
        if not pred.shared_mesh:
            loss, _ = pred.train_step(x, y, **step_kw)
            losses.append(float(loss))
            grads.append(w.flat_grads(pred).numpy())
            continue
        model = pred.model.train()
        pred.optimizer.zero_grad(set_to_none=True)
        per, total = len(x) // WORLD, 0.0
        for r in range(WORLD):
            xs = torch.as_tensor(x[r * per:(r + 1) * per])
            ys = torch.as_tensor(y[r * per:(r + 1) * per])
            for loss, _ in pred._chunk_losses(model, xs, ys, None, None, pred.generator,
                                              0, None, None):
                loss.backward()
                total += float(loss.detach())
        shard_sum = [p.grad for p in model.parameters() if p.grad is not None]
        for g in shard_sum:
            g /= WORLD
        clip_by_global_norm_(shard_sum, CLIP_NORM)
        pred.optimizer.step()
        losses.append(total / WORLD)
        grads.append(w.flat_grads(pred).numpy())
    return pred, losses, grads


@pytest.mark.parametrize("name", list(w.SCENARIOS))
def test_dp_step_matches_one_process(ranks, tmp_path, name):
    got = ranks[name]
    pred, losses, grads = _one_process(name, str(tmp_path))
    assert got["replicas_equal"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for g, ref in zip(got["grads"], grads):
        np.testing.assert_allclose(g, ref, rtol=1e-4, atol=1e-6)
    w.hold_to_one_process(got, grads, w.flat_params(pred).numpy(),
                          [p.numel() for p in pred.model.parameters()], LR)
    # every rank's generator advanced as the one process's did
    assert np.array_equal(got["generator"], pred.generator.get_state().numpy())


def test_dp_train_matches_one_process(ranks, tmp_path):
    """``train()`` over a loader of global batches (JAX
    ``test_dp_through_predictor_api_matches_single_device``); rank 0 alone
    writes its metrics and weights."""
    got = ranks["train_api"]
    x = np.concatenate([b[0] for b in w.batches()])
    y = np.concatenate([b[1] for b in w.batches()])
    loader = w.DataLoader(w.ArrayDataset(x, y, np.zeros(len(x), np.int64)), batch_size=w.BATCH)
    pred = w.make_predictor("full_bptt", str(tmp_path))
    pred.train(loader, loader, n_epochs=2, lr=0.01, lr_decay=0.95)
    assert got["replicas_equal"]
    np.testing.assert_allclose(got["train_loss"], pred.train_loss, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["test_loss"], pred.test_loss, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["params"], w.flat_params(pred).numpy(), rtol=1e-4, atol=1e-6)
    assert len(ranks["run_dirs"]) == 1  # one metrics directory: rank 0's
    assert got["written"] == [got["saved"]] == ["full_bptt.pt"]


def test_dp_rejects_an_indivisible_batch(ranks):
    assert ranks["indivisible_step"] == INDIVISIBLE
    assert ranks["indivisible_train"] == INDIVISIBLE
    with pytest.raises(ValueError, match="not divisible"):
        dp.shard_batch(np.zeros((3, 2)), 0, WORLD)


def test_dp_needs_a_group_of_its_size(ranks, tmp_path):
    assert "needs an initialised torch.distributed group of 3 ranks" in ranks["wrong_world"]
    with pytest.raises(RuntimeError, match="parallel.dp.launch"):
        w.make_predictor("full_bptt", str(tmp_path), dp_devices=2)
    with pytest.raises(ValueError, match="at least 1"):
        w.make_predictor("full_bptt", str(tmp_path), dp_devices=0)


def test_ranks_draw_the_global_batch_rows(ranks):
    """Rank r's draws are rows [2r, 2r+2) of one device's draws for the
    global batch of 4 from the same seed, and the two ranks' masks
    differ."""
    gen = torch.Generator().manual_seed(w.SEED)
    u = torch.rand((WORLD * 2, 3, 5), generator=gen).numpy()
    keep = (dropout(torch.ones(WORLD * 2, 16, 4), 0.1, True, gen) != 0).numpy()
    got = ranks["masks"]
    for r in range(WORLD):
        np.testing.assert_array_equal(got["uniform"][r], u[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["keep"][r], keep[2 * r:2 * r + 2])
    assert not np.array_equal(got["uniform"][0], got["uniform"][1])
    assert not np.array_equal(got["keep"][0], got["keep"][1])


def test_draws_outside_a_shard_are_torch_rand():
    a = draws.uniform((3, 4), torch.Generator().manual_seed(1), "cpu")
    b = torch.rand((3, 4), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and draws.sample_offset(3) == 0
    with draws.batch_shard(1, 2):
        assert draws.sample_offset(3) == 3
    assert draws.sample_offset(3) == 0


def test_shard_batch_rows():
    x = np.arange(12).reshape(6, 2)
    xs, none = dp.shard_batch((x, None), 2, 3)
    np.testing.assert_array_equal(xs, x[4:6])
    assert none is None


def test_backends_are_named_and_checked():
    with pytest.raises(ValueError, match="one of"):
        mesh.check_world(2, "mpi")
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"this machine has {cards}"):
        dp.launch(w.dp_worker, cards + 1, backend="nccl")


def test_launch_raises_a_rank_failure():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank 1 fails on purpose"):
        dp.launch(w.raise_on_rank_1, WORLD, backend="gloo", timeout=300)
