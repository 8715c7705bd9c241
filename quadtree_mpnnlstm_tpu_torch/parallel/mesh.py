"""The process group of data-parallel training.

Counterpart of ``quadtree_mpnnlstm_tpu/parallel/mesh.py``: where the JAX
package lays a 1-D device mesh over the first N devices of one
controller, the port runs one process a rank and joins them in a
``torch.distributed`` group. The caller names the backend and the
rendezvous; nothing here picks either.

- ``"nccl"``: rank r runs on ``cuda:r``, one card a rank. NCCL refuses
  two ranks on one card, so a world larger than the card count raises,
  naming the count.
- ``"gloo"``: each rank runs on the ``device`` the caller gives, the CPU
  (the ranks split the host's cores between their torch threads) or one
  card that the ranks share (gloo reduces CUDA tensors through the host).

``init_method`` is a rendezvous URL; ``parallel/dp.py`` ``launch`` uses a
``file://`` store in a temporary directory, so that concurrent groups on
one host never meet on a port.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def check_world(world_size: int, backend: str) -> None:
    """Raise when ``backend`` cannot run ``world_size`` ranks here."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    if world_size < 1:
        raise ValueError(f"world_size={world_size}: expected at least 1")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"{world_size} NCCL ranks need {world_size} CUDA cards, one a rank; "
                f"this machine has {cards}")


def make_mesh(rank: int, world_size: int, backend: str, init_method: str,
              device: Optional[str] = None) -> torch.device:
    """Join rank ``rank`` of ``world_size`` to the default process group
    and return its device: ``cuda:<rank>`` under NCCL (``device`` must be
    None), ``device`` (default the CPU) under gloo."""
    check_world(world_size, backend)
    if backend == "nccl":
        if device is not None:
            raise ValueError("an NCCL rank runs on its own card, cuda:<rank>; pass no device")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu" if device is None else device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        else:  # CPU ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return dev


def close_mesh() -> None:
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()
