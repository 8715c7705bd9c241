"""Minimal host-side dataset and loader yielding numpy batches, and
``prefetch_to_device``, which keeps the next batches' copies to the card
in flight while the consumer computes."""

from __future__ import annotations

import collections
from typing import Iterator, Tuple

import numpy as np
import torch


class ArrayDataset:
    """In-memory (x, y, launch_date) triplet dataset."""

    def __init__(self, x: np.ndarray, y: np.ndarray, launch_dates: np.ndarray):
        if not len(x) == len(y) == len(launch_dates):
            raise ValueError("x, y and launch_dates differ in length")
        self.x = x
        self.y = y
        self.launch_dates = launch_dates
        self.image_shape = tuple(x.shape[2:4])  # (rows, cols)

    def __len__(self) -> int:
        return len(self.y)

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx], self.launch_dates[idx]


class DataLoader:
    """Batching iterator with optional seeded shuffling."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield (
                self.dataset.x[idx],
                self.dataset.y[idx],
                self.dataset.launch_dates[idx],
            )


def prefetch_to_device(loader, size: int = 2, device="cuda"):
    """Yield ``loader``'s (x, y, launch_dates) batches in order with x and
    y as tensors on ``device``, keeping ``size`` batches in flight ahead of
    the consumer; launch dates stay host numpy (the climatology lookup is
    host math).

    On a CUDA device each x and y is copied into pinned host memory and
    sent with a ``non_blocking`` copy on a side stream, so the transfer
    overlaps the consumer's kernels; before a batch is yielded the
    consumer's stream waits on its copy's event, and ``record_stream``
    keeps the caching allocator from reusing its memory while the
    consumer's stream may still read it. On the CPU the tensors share the
    numpy arrays' memory."""
    device = torch.device(device)
    queue = collections.deque()
    it = iter(loader)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def enqueue():
        x, y, launch = next(it)
        if side is None:
            queue.append((torch.as_tensor(x, device=device),
                          torch.as_tensor(y, device=device), launch, None))
            return
        host = [torch.as_tensor(a).pin_memory() for a in (x, y)]
        with torch.cuda.stream(side):
            xd, yd = (h.to(device, non_blocking=True) for h in host)
            done = torch.cuda.Event()
            done.record(side)
        queue.append((xd, yd, launch, done))

    try:
        for _ in range(max(size, 1)):
            enqueue()
    except StopIteration:
        pass
    while queue:
        x, y, launch, done = queue.popleft()
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            x.record_stream(consumer)
            y.record_stream(consumer)
        try:
            enqueue()
        except StopIteration:
            pass
        yield x, y, launch
