"""The rank side of ``tests/test_torch_parallel.py``: functions that
``parallel/dp.py`` ``launch`` runs on each spawned rank. They live outside
the test file so that a rank imports torch and the port, not the test
module's imports."""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils import draws

SHAPE = (8, 8)
T_IN, T_OUT, BATCH, STEPS = 2, 4, 4, 2
SEED = 7
GRAPH = dict(max_grid_size=4, n_max=64, e_max=512, node_budget=64, agg_nt=64, agg_eb=512,
             agg_sw=64)
# name: (model_kwargs, graph_kwargs, predictor kwargs, train_step kwargs)
SCENARIOS = {
    "full_bptt": (dict(convolution_type="GCNConv", dropout=0.0), dict(aggregation="pallas"),
                  {}, {}),
    "tbptt_2": (dict(convolution_type="ChebConv", dropout=0.0), dict(aggregation="pallas"),
                {}, dict(truncated_backprop=2)),
    "shared_mesh": (dict(convolution_type="GCNConv", dropout=0.0), dict(aggregation="xla"),
                    dict(shared_mesh=True), {}),
    # dropout 0.1 on every kind of draw: the attention windows' keep, the
    # edge list's hash, the grid's planes, the head's dropout and the
    # scheduled-sampling coins
    "dropout_windows": (dict(convolution_type="TransformerConv", dropout=0.1),
                        dict(aggregation="pallas"), dict(teacher_forcing_ratio=0.5), {}),
    "dropout_edges": (dict(convolution_type="TransformerConv", dropout=0.1),
                      dict(aggregation="xla"), {}, dict(truncated_backprop=2)),
    "dropout_grid": (dict(convolution_type="TransformerConv", dropout=0.1),
                     dict(aggregation="grid"), dict(decompose=False), {}),
}
# the scenarios that also run from the JAX predictor's initial weights,
# held to its dp_devices=2 steps
JAX_SCENARIOS = ("full_bptt", "shared_mesh")


def batches(n: int = STEPS, batch: int = BATCH, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(rng.random((batch, T_IN, *SHAPE, 1), dtype=np.float32),
             rng.random((batch, T_OUT, *SHAPE, 1), dtype=np.float32)) for _ in range(n)]


def make_predictor(name: str, run_dir: str, dp_devices: int = 1, device: str = "cpu"):
    model_kw, graph_kw, kw, _ = SCENARIOS[name]
    return NextFramePredictorS2S(
        SHAPE, 0.3, experiment_name=name, input_timesteps=T_IN, output_timesteps=T_OUT,
        device=device, seed=SEED, run_dir=run_dir, dp_devices=dp_devices,
        model_kwargs=dict(hidden_size=4, n_layers=1, n_conv_layers=1, remat=False, **model_kw),
        graph_kwargs=dict(GRAPH, **graph_kw), **kw)


def flat_params(pred) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in pred.model.parameters()])


def flat_grads(pred) -> torch.Tensor:
    """The clipped gradients the last step applied, flattened."""
    return torch.cat([p.grad.detach().reshape(-1) for p in pred.model.parameters()])


def hold_to_one_process(got: dict, grads, params, sizes, lr: float = 0.01) -> None:
    """A data-parallel run ``got`` (each step's gradients and the final
    weights, flattened) against the one-process run's ``grads`` and
    ``params``, ``sizes`` the parameter tensors' entries in order.

    The first step's gradients, where both runs start from the same
    weights and differ only in the order of their sums, per parameter
    tensor: within 1e-4 of the tensor's largest, and never tighter than
    2⁻²³ of the step's largest (the f32 rounding of its sums, where a
    tensor's gradient is zero but for rounding). Later steps start from
    weights that Adam has already moved apart, and their gradients are
    held by the caller. Every weight within the JAX package's rtol 1e-4 /
    atol 1e-6 plus twice Adam's first-order response to the measured
    gradient difference: Adam divides each entry's step by the entry's
    own gradient, so a rounding of a small gradient moves its weight by
    that rounding's share of lr. That response bounds a step's update
    change by Σ_{s≤t} |Δg_s| / (√v̂_t + ε), for m̂ is a weighted mean of
    the gradients so far and √v̂ their weighted root mean square."""
    g, r = np.asarray(got["grads"], np.float64), np.asarray(grads, np.float64)
    start = 0
    for n in sizes:
        allow = max(1e-4 * np.abs(r[0, start:start + n]).max(), 2.0**-23 * np.abs(r[0]).max())
        err = np.abs(g[0, start:start + n] - r[0, start:start + n]).max()
        assert err <= allow, f"first gradient of entries [{start}, {start + n}): {err} > {allow}"
        start += n
    v = np.zeros(r.shape[1])
    acc, response = np.zeros_like(v), np.zeros_like(v)
    for t in range(len(r)):
        v = 0.999 * v + 0.001 * r[t] ** 2
        acc += np.abs(g[t] - r[t])
        response += lr * acc / (np.sqrt(v / (1 - 0.999 ** (t + 1))) + 1e-8)
    err = np.abs(got["params"] - params)
    allow = 1e-6 + 1e-4 * np.abs(params) + 2 * response
    worst = int(np.argmax(err / allow))
    assert err[worst] <= allow[worst], f"weight {worst}: {err[worst]} against {allow[worst]}"


def replicas_equal(pred) -> bool:
    """Every rank's weights equal rank 0's, bit for bit."""
    mine = flat_params(pred)
    theirs = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(theirs, mine)
    return all(torch.equal(theirs[0], t) for t in theirs)


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return str(exc)
    return ""


def rank_masks(rank: int, device, world: int):
    """The draws a rank makes from the predictor's seed for a shard of 2
    samples: a (2, 3, 5) uniform and the head dropout's keep."""
    from quadtree_mpnnlstm_tpu_torch.models.seq2seq import dropout

    gen = torch.Generator(device=device).manual_seed(SEED)
    with draws.batch_shard(rank, world):
        u = draws.uniform((2, 3, 5), gen, device)
        keep = dropout(torch.ones(2, 16, 4), 0.1, True, gen) != 0
    return u, keep


def run_scenarios(device, names, run_root: str, weights=None) -> dict:
    """Each scenario's two steps on the global batches with ``dp_devices``
    the group's size, from the JAX package's parameter tree ``weights``
    when given: the losses, the weights, each step's gradients, the
    generator's state and whether the replicas agree."""
    world = dist.get_world_size()
    out = {}
    for name in names:
        step_kw = SCENARIOS[name][3]
        pred = make_predictor(name, os.path.join(run_root, name), world, device)
        if weights is not None:
            pred.load_jax_params(weights)
        pred.initiate_training(lr=0.01, lr_decay=0.95)
        losses, grads = [], []
        for x, y in batches():
            loss, overflow = pred.train_step(x, y, **step_kw)
            losses.append(float(loss))
            grads.append(flat_grads(pred).cpu().numpy())
            assert int(overflow) == 0
        out[name] = dict(losses=losses, params=flat_params(pred).cpu().numpy(), grads=grads,
                         generator=pred.generator.get_state().numpy(),
                         replicas_equal=replicas_equal(pred))
    return out


def card_worker(rank: int, device, names, run_root: str) -> dict:
    """The scenarios ``names`` on the card (``tests/test_torch_kernels_cuda.py``)."""
    return run_scenarios(device, names, run_root)


def dp_worker(rank: int, device, run_root: str, jax_weights: str) -> dict:
    """Everything ``test_torch_parallel.py`` asks of two gloo ranks, in one
    spawn: each scenario's losses, weights and gradients after two steps
    of the global batch (those of :data:`JAX_SCENARIOS` once more from the
    JAX parameter tree pickled at ``jax_weights``, under ``jax_<name>``),
    whether the replicas agree, the masks each rank draws, the errors, and
    what the ranks wrote."""
    torch.set_num_threads(1)
    world = dist.get_world_size()
    out = dict(run_scenarios(device, list(SCENARIOS), run_root), world=world)
    with open(jax_weights, "rb") as f:
        weights = pickle.load(f)
    for name, run in run_scenarios(device, JAX_SCENARIOS, os.path.join(run_root, "jax"),
                                   weights).items():
        out["jax_" + name] = run
    # train() over a loader of the global batches, rank 0 alone writing
    x = np.concatenate([b[0] for b in batches()])
    y = np.concatenate([b[1] for b in batches()])
    loader = DataLoader(ArrayDataset(x, y, np.zeros(len(x), np.int64)), batch_size=BATCH)
    pred = make_predictor("full_bptt", os.path.join(run_root, "train_api"), world, device)
    pred.train(loader, loader, n_epochs=2, lr=0.01, lr_decay=0.95)
    path = pred.save(os.path.join(run_root, "weights"))
    out["train_api"] = dict(train_loss=pred.train_loss, test_loss=pred.test_loss,
                            params=flat_params(pred).numpy(), replicas_equal=replicas_equal(pred),
                            written=sorted(os.listdir(os.path.join(run_root, "weights"))),
                            saved=os.path.basename(path))
    dist.barrier()
    out["run_dirs"] = sorted(os.listdir(os.path.join(run_root, "train_api")))
    # the errors: a batch the ranks cannot split, a group of another size
    odd = DataLoader(ArrayDataset(x[:3], y[:3], np.zeros(3, np.int64)), batch_size=3)
    out["indivisible_step"] = _error(lambda: pred.train_step(x[:3], y[:3]))
    out["indivisible_train"] = _error(lambda: pred.train(odd, odd, n_epochs=1))
    out["wrong_world"] = _error(lambda: make_predictor("full_bptt", run_root, world + 1, device))
    # the masks: every rank's, gathered on rank 0
    u, keep = rank_masks(rank, device, world)
    us = [torch.empty_like(u) for _ in range(world)]
    keeps = [torch.empty_like(keep, dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(us, u)
    dist.all_gather(keeps, keep.to(torch.uint8))
    out["masks"] = dict(uniform=[t.numpy() for t in us], keep=[t.bool().numpy() for t in keeps])
    return out


def raise_on_rank_1(rank: int, device) -> str:
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return "rank 0 result"


WINDOWS = 4  # the windows a CLI test keeps of each IceDataset
CLI_HIDDEN = 4  # the CLI tests' model width


def few_windows(dataset_cls):
    """``dataset_cls`` (an IceDataset) cut to :data:`WINDOWS` windows
    spread over its span, for the CLI runs of ``test_torch_cli.py``."""
    def make(*args, **kw):
        data = dataset_cls(*args, **kw)
        step = max(1, len(data) // WINDOWS)
        keep = slice(0, step * WINDOWS, step)
        return ArrayDataset(data.x[keep], data.y[keep], data.launch_dates[keep])
    return make


def small_ice_exp_rank(rank: int, device, argv):
    """A rank of ``cli/ice_exp.py`` ``--dp-devices`` at the CLI tests' size
    (:data:`CLI_HIDDEN` wide, the cut datasets), which a spawned rank does
    not inherit from the launching test."""
    from quadtree_mpnnlstm_tpu_torch.cli import ice_exp

    torch.set_num_threads(1)
    ice_exp.MODEL_KWARGS = dict(ice_exp.MODEL_KWARGS, hidden_size=CLI_HIDDEN)
    ice_exp.IceDataset = few_windows(ice_exp.IceDataset)
    return ice_exp._rank_main(rank, device, argv)
