"""Data-parallel training over a ``torch.distributed`` group.

Counterpart of ``quadtree_mpnnlstm_tpu/parallel/dp.py``. The JAX package
shards the global batch over a device mesh under ``shard_map`` and
averages the gradients with ``lax.pmean``; here each rank is a process
that holds the whole global batch (every rank's loader yields the same
batches), runs the forward and backward on its contiguous rows
(:func:`shard_batch`), and :func:`all_reduce_step` averages the gradients
and the loss with one ``all_reduce`` after the step's last backward and
takes the overflow's maximum (``pmax``). The clip and the Adam update then
run on every rank on identical gradients, so the replicas stay equal.
``NextFramePredictorS2S(dp_devices=N)`` runs this step
(``train/predictor.py``).

Not ``DistributedDataParallel``: a truncated-BPTT step runs ``backward()``
once a decoder chunk, and DDP would reduce in every chunk (its bucket
hooks fire in autograd's order) unless each chunk but the last ran under
``no_sync``; one reduction of the summed chunks is the JAX step's one
``pmean``.

:func:`launch` runs a function on N ranks (``torch.multiprocessing``,
spawned) and returns rank 0's result; the CLIs and the tests use it.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import traceback
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from quadtree_mpnnlstm_tpu_torch.parallel.mesh import check_world, close_mesh, make_mesh


def check_divisible(batch: int, world: int) -> None:
    """The JAX predictor's error for a batch the ranks cannot split."""
    if batch % world:
        raise ValueError(f"global batch {batch} not divisible by dp_devices={world} "
                         "(use drop_last=True)")


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s rows ``[r·B/N, (r+1)·B/N)`` of a global batch (an
    array or tensor with the batch axis first, or a tuple of them; None
    stays None)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(a, rank, world) for a in batch)
    if batch is None:
        return None
    check_divisible(len(batch), world)
    per = len(batch) // world
    return batch[rank * per:(rank + 1) * per]


def all_reduce_step(params: Sequence[torch.Tensor], loss: torch.Tensor,
                    overflow: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Average every parameter's gradient and the loss over the group in
    one ``all_reduce`` of their flattened concatenation (the shards are
    equal, so the mean of their means is the global batch's mean), and
    take the overflow's maximum in a second. The gradients are written
    back in place; returns (loss, overflow)."""
    world = dist.get_world_size()
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    overflow = overflow.clone()
    dist.all_reduce(overflow, op=dist.ReduceOp.MAX)
    return flat[offset].to(loss.dtype), overflow


def _run_rank(rank: int, world: int, backend: str, device: Optional[str], init_method: str,
              fn: Callable, args: tuple, results) -> None:
    """One rank: join the group, run ``fn(rank, device, *args)``, report
    its result (rank 0) or its traceback, leave the group."""
    try:
        dev = make_mesh(rank, world, backend, init_method, device)
        out = fn(rank, dev, *args)
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        close_mesh()


def launch(fn: Callable, world_size: int, backend: str = "nccl", device: Optional[str] = None,
           args: tuple = (), timeout: float = 3600.0) -> Any:
    """Run ``fn(rank, device, *args)`` on ``world_size`` spawned ranks
    joined over ``backend`` (``parallel/mesh.py``: NCCL one card a rank,
    gloo on ``device``) and return rank 0's result, which must pickle.
    ``fn`` must be importable by the children (a module-level function).
    A rank that raises, or dies, makes this raise with its traceback after
    the other ranks are stopped."""
    check_world(world_size, backend)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="qtm_dp_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_run_rank, args=(rank, world_size, backend, device,
                                                     init_method, fn, args, results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        reports, waited = {}, 0.0
        try:
            while len(reports) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue_mod.Empty:
                    waited += 1.0
                    dead = [r for r, p in enumerate(procs)
                            if r not in reports and not p.is_alive()]
                    if dead and results.empty():
                        raise RuntimeError(f"data-parallel rank(s) {dead} exited with "
                                           f"{[procs[r].exitcode for r in dead]} and no report")
                    if waited > timeout:
                        raise TimeoutError(f"data-parallel ranks gave no report in {timeout} s")
                    continue
                reports[rank] = (ok, payload)
                if not ok:
                    raise RuntimeError(f"data-parallel rank {rank} failed:\n{payload}")
        finally:
            for p in procs:
                p.join(timeout=None if len(reports) == world_size else 5.0)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return reports[0][1]
