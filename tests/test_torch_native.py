"""The port's native host toolkit (``quadtree_mpnnlstm_tpu_torch/
native_ext.py`` over its own ``csrc/qtm_host.cpp``, built with g++ into
``build/native/``) against the JAX package's (``native_ext`` over
``native/libqtmhost.so``), bit for bit, on the cases of
``tests/test_native.py``; the ``backend="native"`` Moving-MNIST datasets
of both packages; a failed build raises with the compiler's stderr."""

import os

import numpy as np
import pytest

import oracle
from quadtree_mpnnlstm_tpu import native_ext as jax_native
from quadtree_mpnnlstm_tpu.data.moving_mnist import ModMovingMNISTDataset as JaxMNIST
from quadtree_mpnnlstm_tpu_torch import native_ext
from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

QUADTREE_CASES = [
    ((16, 16), 8, 0.5, 0, "max_larger_than", False),
    ((16, 16), 8, 0.5, 1, "max_larger_than", True),
    ((12, 20), 4, 0.3, 0, "min_smaller_than", True),
]


@pytest.mark.parametrize("case", range(len(QUADTREE_CASES)))
def test_quadtree_equals_the_jax_library(case):
    shape, max_size, thresh, pad, cond, with_mask = QUADTREE_CASES[case]
    rng = np.random.default_rng(case)
    img = rng.random(shape)
    mask = (rng.random(shape) < 0.2) if with_mask else None
    hir = rng.random(shape) < 0.05
    for region in (None, hir):
        kw = dict(thresh=thresh, max_size=max_size, mask=mask, high_interest_region=region,
                  padding=pad, condition=cond)
        ours, n = native_ext.quadtree_decompose(img, **kw)
        ref, n_ref = jax_native.quadtree_decompose(img, **kw)
        np.testing.assert_array_equal(ours, ref)
        assert n == n_ref
    # and the oracle's partition, as test_native.py holds the JAX library
    ref = oracle.quadtree_labels(img, thresh=thresh, max_size=max_size, mask=mask,
                                 padding=pad, condition=cond)
    ours, n = native_ext.quadtree_decompose(img, thresh=thresh, max_size=max_size, mask=mask,
                                            padding=pad, condition=cond)
    assert oracle.partition_bijection(ref, ours) is not None
    assert n == len(np.unique(ref[ref >= 0]))


@pytest.mark.parametrize("corners", [False, True])
def test_adjacency_equals_the_jax_library(corners):
    rng = np.random.default_rng(1)
    img = rng.random((16, 16))
    mask = rng.random((16, 16)) < 0.15
    labels = oracle.quadtree_labels(img, thresh=0.5, max_size=8, mask=mask)
    src, dst = native_ext.adjacency(labels, corners=corners)
    ref_src, ref_dst = jax_native.adjacency(labels, corners=corners)
    np.testing.assert_array_equal(src, ref_src)
    np.testing.assert_array_equal(dst, ref_dst)
    if not corners:
        assert set(zip(src.tolist(), dst.tolist())) == oracle.adjacency_pairs(labels)
    key = dst * (labels.max() + 2) + src
    assert np.all(np.diff(key) > 0)  # sorted by (dst, src)


@pytest.mark.parametrize("noise", [(0.0, 0.0), (0.05, 0.25)])
def test_moving_sprites_equal_the_jax_library(noise):
    sprites = np.zeros((2, 4, 4), np.float32)
    sprites[:, 1:3, 1:3] = 1.0
    kw = dict(n_samples=3, t_total=5, canvas=16, n_digits=2, pixel_noise=noise[0],
              velocity_noise=noise[1], seed=42)
    vids = native_ext.moving_sprites(sprites, **kw)
    np.testing.assert_array_equal(vids, jax_native.moving_sprites(sprites, **kw))
    np.testing.assert_array_equal(vids, native_ext.moving_sprites(sprites, **kw))
    assert vids.shape == (3, 5, 16, 16)
    if noise[0] == 0.0:
        assert (vids.reshape(3, 5, -1).max(-1) == 1.0).all()


def test_native_dataset_equals_the_jax_one():
    kw = dict(n_samples=4, input_timesteps=3, output_timesteps=2, canvas_size=(24, 24),
              digit_size=(10, 10), seed=5, backend="native")
    ours, ref = ModMovingMNISTDataset(**kw), JaxMNIST(**kw)
    np.testing.assert_array_equal(ours.x, ref.x)
    np.testing.assert_array_equal(ours.y, ref.y)
    assert ours.x.shape == (4, 3, 24, 24, 1) and ours.y.shape == (4, 2, 24, 24, 1)
    again = ModMovingMNISTDataset(**kw)
    np.testing.assert_array_equal(ours.x, again.x)
    numpy = ModMovingMNISTDataset(**dict(kw, backend="numpy"))
    assert not np.array_equal(ours.x, numpy.x)  # another random stream
    with pytest.raises(ValueError, match="square"):
        ModMovingMNISTDataset(**dict(kw, canvas_size=(24, 32)))
    with pytest.raises(ValueError, match="backend"):
        ModMovingMNISTDataset(**dict(kw, backend="cuda"))


def test_the_library_builds_into_build_native():
    path = native_ext.build()
    assert path.parent == native_ext.BUILD_DIR and path.name.startswith("libqtmhost-")
    assert native_ext.build() == path  # keyed by source and flags: no rebuild


def test_a_failed_build_raises_with_the_compiler_stderr(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text(native_ext.SOURCE.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="failed(.|\n)*error"):
        native_ext.build(broken, tmp_path / "out")
    monkeypatch.setenv("CXX", os.path.join(tmp_path, "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no compiler"):
        native_ext.build(native_ext.SOURCE, tmp_path / "out2")
    assert not any((tmp_path / "out").glob("*.so"))
