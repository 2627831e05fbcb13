"""``paddle_tpu_torch.vision.datasets`` and ``.transforms`` against the JAX
package's, on the CPU.

The synthetic datasets (MNIST, FashionMNIST, Cifar10 / 100, Flowers; every
split) are the reference's arrays bit for bit, and their items and
``get_arrays`` equal the reference's exactly. MNIST reads gzipped idx
files written to a temporary directory, as the reference does. Every
transform is held against the reference's on the same seeded inputs:
exactly where it moves or scales values elementwise (crops, flips,
transposes, ``ToTensor``, ``Normalize``), and with the same
``np.random.seed`` for the random ones; ``Resize`` against
``jax.image.resize(..., "bilinear")`` (antialiased when it shrinks) within
atol 1e-5, rtol 1e-5 (float32 sums in another order), up and down, square
and not, CHW and HW.
"""
import gzip
import struct

import numpy as np
import pytest

import paddle_tpu.vision.datasets as jd
import paddle_tpu.vision.transforms as jt

from paddle_tpu_torch.vision import datasets as td
from paddle_tpu_torch.vision import transforms as tt

RESIZE = dict(atol=1e-5, rtol=1e-5)

CASES = [("MNIST", "train"), ("MNIST", "test"), ("FashionMNIST", "train"),
         ("Cifar10", "train"), ("Cifar10", "test"), ("Cifar100", "train"),
         ("Flowers", "train"), ("Flowers", "valid"), ("Flowers", "test")]


@pytest.mark.parametrize("name,mode", CASES)
def test_synthetic_datasets_are_the_reference_bit_for_bit(name, mode):
    j = getattr(jd, name)(mode=mode)
    t = getattr(td, name)(mode=mode, download=True)
    assert len(j) == len(t)
    np.testing.assert_array_equal(j.images, t.images)
    np.testing.assert_array_equal(j.labels, t.labels)
    assert t.images.dtype == j.images.dtype
    for i in (0, 1, len(t) - 1):
        (jx, jy), (tx, ty) = j[i], t[i]
        np.testing.assert_array_equal(jx, tx)
        assert jx.dtype == tx.dtype and jy == ty and jy.dtype == ty.dtype
    if hasattr(j, "get_arrays"):
        for a, b in zip(j.get_arrays(), t.get_arrays()):
            np.testing.assert_array_equal(a, b)


def _write_idx(root, prefix, images, labels):
    with gzip.open(root / f"{prefix}-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape))
        f.write(images.tobytes())
    with gzip.open(root / f"{prefix}-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)))
        f.write(labels.tobytes())


@pytest.mark.parametrize("mode,prefix", [("train", "train"),
                                         ("test", "t10k")])
def test_mnist_reads_idx_files_as_the_reference(tmp_path, mode, prefix):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (7, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 7).astype(np.uint8)
    _write_idx(tmp_path, prefix, images, labels)
    j = jd.MNIST(mode=mode, root=str(tmp_path))
    t = td.MNIST(mode=mode, root=str(tmp_path))
    np.testing.assert_array_equal(t.images, images)
    np.testing.assert_array_equal(t.labels, labels.astype(np.int64))
    assert len(t) == len(j) == 7
    for i in range(7):
        np.testing.assert_array_equal(j[i][0], t[i][0])
        assert j[i][1] == t[i][1]
    t2 = td.MNIST(image_path=str(tmp_path), mode=mode)
    np.testing.assert_array_equal(t2.images, images)


def test_transformed_dataset_items_match_and_skip_the_batcher():
    tr = [jt.Normalize([0.5], [0.25])], [tt.Normalize([0.5], [0.25])]
    j = jd.MNIST(mode="test", transform=jt.Compose(tr[0]))
    t = td.MNIST(mode="test", transform=tt.Compose(tr[1]))
    assert t.get_arrays() is None
    for i in (0, 5):
        np.testing.assert_array_equal(j[i][0], t[i][0])
    jc = jd.Cifar10(mode="test", transform=jt.CenterCrop(24))
    tc = td.Cifar10(mode="test", transform=tt.CenterCrop(24))
    np.testing.assert_array_equal(jc[3][0], tc[3][0])


def _img(seed, shape, dtype=np.float32, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * scale).astype(dtype)


@pytest.mark.parametrize("shape", [(3, 40, 30), (24, 24), (1, 9, 17)])
@pytest.mark.parametrize("size", [16, (20, 12), 56, (9, 40), 7])
def test_resize_matches_jax_image_resize(shape, size):
    x = _img(1, shape)
    want = jt.Resize(size)(x)
    got = tt.Resize(size)(x)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **RESIZE)


def test_resize_keeps_an_unchanged_axis():
    x = _img(2, (3, 32, 20))
    np.testing.assert_array_equal(tt.Resize((32, 20))(x), x)
    np.testing.assert_allclose(tt.Resize((32, 10))(x),
                               jt.Resize((32, 10))(x), **RESIZE)


@pytest.mark.parametrize("name,args,inputs", [
    ("ToTensor", (), [(2, (32, 24, 3), np.uint8, 255),
                      (3, (28, 28), np.uint8, 255),
                      (4, (8, 8, 3), np.float32, 1.0),
                      (5, (8, 8, 5), np.float32, 1.0)]),
    ("ToTensor", ("HWC",), [(6, (16, 16, 3), np.uint8, 255)]),
    ("Normalize", ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
     [(7, (3, 10, 12), np.float32, 1.0)]),
    ("Normalize", (0.5, 0.5), [(8, (1, 6, 6), np.float32, 1.0)]),
    ("CenterCrop", (8,), [(9, (3, 15, 20), np.float32, 1.0),
                          (10, (15, 20), np.float32, 1.0)]),
    ("CenterCrop", ((4, 10),), [(11, (2, 9, 13), np.float32, 1.0)]),
    ("Transpose", (), [(12, (5, 6, 3), np.float32, 1.0)]),
    ("Transpose", ((1, 0, 2),), [(13, (5, 6, 3), np.float32, 1.0)]),
])
def test_deterministic_transforms_match_reference(name, args, inputs):
    for seed, shape, dtype, scale in inputs:
        x = _img(seed, shape, dtype, scale)
        want = getattr(jt, name)(*args)(x)
        got = getattr(tt, name)(*args)(x)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,args", [
    ("RandomCrop", (24,)), ("RandomCrop", ((10, 30),)),
    ("RandomCrop", (32, 4)), ("RandomHorizontalFlip", ()),
    ("RandomHorizontalFlip", (0.8,))])
def test_random_transforms_match_reference_under_one_seed(name, args):
    x = _img(14, (3, 32, 40))
    np.random.seed(3)
    want = [getattr(jt, name)(*args)(x) for _ in range(6)]
    np.random.seed(3)
    got = [getattr(tt, name)(*args)(x) for _ in range(6)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    if name == "RandomHorizontalFlip":   # both outcomes were drawn
        flipped = [np.array_equal(g, x[..., ::-1]) for g in got]
        assert any(flipped) and not all(flipped)


def test_the_paddleclas_train_pipeline_matches_reference():
    """The ``[hapi resnet]`` card phase's recipe on a small HWC uint8
    image: ToTensor, RandomCrop, RandomHorizontalFlip, Normalize."""
    def pipe(m):
        return m.Compose([m.ToTensor(), m.RandomCrop(24),
                          m.RandomHorizontalFlip(),
                          m.Normalize([0.485, 0.456, 0.406],
                                      [0.229, 0.224, 0.225])])

    x = _img(15, (32, 32, 3), np.uint8, 255)
    np.random.seed(4)
    want = [pipe(jt)(x) for _ in range(4)]
    np.random.seed(4)
    got = [pipe(tt)(x) for _ in range(4)]
    for w, g in zip(want, got):
        assert g.shape == (3, 24, 24) and g.dtype == np.float32
        np.testing.assert_array_equal(w, g)
