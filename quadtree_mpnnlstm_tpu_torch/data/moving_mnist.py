"""Modified Moving-MNIST synthetic video generator (numpy).

Bouncing digits on a canvas with velocity noise, multi-digit
max-compositing and additive pixel noise; returns x (N, T_in, w, h, 1),
y (N, T_out, w, h, 1). The default sprites are the committed set of real
handwritten digits in ``digit_sprites.npz`` (50 digits, 5 per class,
28×28); ``sprites="font"`` selects a 5×7 bitmap font. Same generator and
random stream as ``quadtree_mpnnlstm_tpu/data/moving_mnist.py``, so one
seed gives the same videos in both packages; ``backend="native"`` renders
through the port's C++ generator (``native_ext.py``), as the JAX
package's native backend renders through its own.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset

# 5x7 bitmap font, digits 0-9 (rows of 5 bits each).
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _font_digit(d: int) -> np.ndarray:
    return np.array(
        [[float(b) for b in row] for row in _FONT[d]], dtype=np.float32
    )


def _resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    h, w = img.shape
    out_h, out_w = size
    ri = (np.arange(out_h) * h // out_h).clip(0, h - 1)
    ci = (np.arange(out_w) * w // out_w).clip(0, w - 1)
    return img[np.ix_(ri, ci)]


def _resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    h, w = img.shape
    out_h, out_w = size
    yi = np.linspace(0.0, h - 1.0, out_h)
    xi = np.linspace(0.0, w - 1.0, out_w)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (yi - y0).astype(np.float32)[:, None]
    fx = (xi - x0).astype(np.float32)[None, :]
    top = img[np.ix_(y0, x0)] * (1 - fx) + img[np.ix_(y0, x1)] * fx
    bot = img[np.ix_(y1, x0)] * (1 - fx) + img[np.ix_(y1, x1)] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def load_digit_sprites() -> list:
    """The committed handwriting sprites: 50 × 28×28 float32 in [0, 1]."""
    path = os.path.join(os.path.dirname(__file__), "digit_sprites.npz")
    with np.load(path) as z:
        return [s.astype(np.float32) / 255.0 for s in z["sprites"]]


class ModMovingMNIST:
    """Digit-sprite video generator."""

    def __init__(
        self,
        canvas_size: Tuple[int, int] = (32, 32),
        digit_size: Tuple[int, int] = (12, 12),
        pixel_noise: float = 0.05,
        velocity_noise: float = 0.25,
        sprites: Optional[Union[str, Sequence[np.ndarray]]] = None,
        seed: int = 0,
    ):
        self.canvas_size = tuple(canvas_size)
        self.digit_size = tuple(digit_size)
        self.pixel_noise = pixel_noise
        self.velocity_noise = velocity_noise
        self.rng = np.random.default_rng(seed)
        self._smooth = True  # bilinear resize for grayscale handwriting
        if sprites is None:
            sprites = load_digit_sprites()
        elif isinstance(sprites, str):
            if sprites != "font":
                raise ValueError(f"unknown sprite set {sprites!r}")
            sprites = [_font_digit(d) for d in range(10)]
            self._smooth = False  # nearest keeps the bitmap font crisp
        self.sprites = [np.asarray(s, dtype=np.float32) for s in sprites]

    def get_rand_digit(self) -> np.ndarray:
        s = self.sprites[self.rng.integers(len(self.sprites))]
        resize = _resize_bilinear if self._smooth else _resize_nearest
        return resize(s, self.digit_size)

    def get_random_trajectory(self, seq_length: int):
        """Bouncing trajectory with per-step velocity noise."""
        inner = np.array(self.canvas_size) - np.array(self.digit_size)
        y, x = self.rng.random(2) * inner
        v_y = self.rng.choice([-1.0, 1.0])
        v_x = self.rng.choice([-1.0, 1.0])
        ys, xs = [], []
        for _ in range(seq_length):
            ny, nx = self.rng.normal(0.0, self.velocity_noise, 2)
            y += v_y + ny
            x += v_x + nx
            if x <= 0:
                x, v_x = 0.0, -v_x
            if x >= inner[1]:
                x, v_x = float(inner[1]), -v_x
            if y <= 0:
                y, v_y = 0.0, -v_y
            if y >= inner[0]:
                y, v_y = float(inner[0]), -v_y
            ys.append(int(y))
            xs.append(int(x))
        return np.array(ys), np.array(xs)

    def generate_moving_digit(self, n_frames: int) -> np.ndarray:
        digit = self.get_rand_digit()
        ys, xs = self.get_random_trajectory(n_frames)
        dh, dw = self.digit_size
        canvas = np.zeros((n_frames, *self.canvas_size), dtype=np.float32)
        for i, (y, x) in enumerate(zip(ys, xs)):
            canvas[i, y : y + dh, x : x + dw] = digit
        return canvas

    def generate_moving_digits(self, n_frames: int, n_digits: int = 1):
        """Multi-digit max composite."""
        return np.max(
            [self.generate_moving_digit(n_frames) for _ in range(n_digits)],
            axis=0,
        )

    def create_dataset(
        self,
        num_samples: int,
        input_timesteps: int,
        output_timesteps: int = 1,
        n_digits: int = 1,
        gap: int = 0,
        backend: str = "numpy",
    ):
        """(x, y) videos with additive white noise.

        ``backend="native"`` renders through the C++ generator
        (``native_ext.py``, ``csrc/qtm_host.cpp``): the same dynamics, a
        different random stream, as the JAX package's native backend."""
        t_total = input_timesteps + output_timesteps + gap
        if backend == "native":
            from quadtree_mpnnlstm_tpu_torch import native_ext

            if self.canvas_size[0] != self.canvas_size[1]:
                raise ValueError(f"the native generator draws square canvases, not "
                                 f"{tuple(self.canvas_size)}")
            resize = _resize_bilinear if self._smooth else _resize_nearest
            sprites = np.stack([resize(s, self.digit_size) for s in self.sprites])
            vids = native_ext.moving_sprites(
                sprites, num_samples, t_total, self.canvas_size[0], n_digits=n_digits,
                pixel_noise=self.pixel_noise, velocity_noise=self.velocity_noise,
                seed=int(self.rng.integers(2**63)))
            vids = np.swapaxes(vids, 2, 3)
            x = vids[:, :input_timesteps, :, :, None]
            y = vids[:, t_total - output_timesteps:, :, :, None]
            return x, y
        if backend != "numpy":
            raise ValueError(f"backend={backend!r}: expected 'numpy' or 'native'")
        xs, ys = [], []
        for _ in range(num_samples):
            vid = self.generate_moving_digits(t_total, n_digits)
            vid = vid + self.rng.normal(
                0.0, self.pixel_noise, vid.shape
            ).astype(np.float32)
            # (T, rows, cols) → (T, cols, rows), the reference's orientation
            vid = np.swapaxes(vid, 1, 2)
            xs.append(vid[:input_timesteps])
            ys.append(vid[t_total - output_timesteps :])
        x = np.expand_dims(np.array(xs, dtype=np.float32), -1)
        y = np.expand_dims(np.array(ys, dtype=np.float32), -1)
        return x, y


class ModMovingMNISTDataset(ArrayDataset):
    """Dataset wrapper around :class:`ModMovingMNIST`."""

    def __init__(
        self,
        n_samples: int,
        input_timesteps: int,
        output_timesteps: int,
        n_digits: int = 1,
        gap: int = 0,
        canvas_size: Tuple[int, int] = (32, 32),
        digit_size: Tuple[int, int] = (12, 12),
        pixel_noise: float = 0.05,
        velocity_noise: float = 0.25,
        seed: int = 0,
        sprites=None,
        backend: str = "numpy",
    ):
        gen = ModMovingMNIST(
            canvas_size, digit_size, pixel_noise, velocity_noise,
            sprites=sprites, seed=seed,
        )
        x, y = gen.create_dataset(
            n_samples, input_timesteps, output_timesteps, n_digits, gap, backend=backend
        )
        frame_id = np.arange(len(y), dtype=np.int64)
        super().__init__(x, y, frame_id)
