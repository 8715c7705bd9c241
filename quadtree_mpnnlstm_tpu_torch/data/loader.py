"""Minimal host-side dataset/loader yielding numpy batches."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


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
