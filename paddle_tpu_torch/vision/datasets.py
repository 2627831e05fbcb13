"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets.py``).

``MNIST`` reads the standard gzipped idx files from ``root`` when they are
there; otherwise, like ``Cifar10``, ``Cifar100`` and ``Flowers``, it makes
the reference's synthetic set (class templates plus noise, from the same
``RandomState`` seeds, so the arrays are the reference's bit for bit).
``download`` is accepted and ignored: nothing is fetched. Items are numpy
arrays (CHW float32 in [-1, 1], int64 label).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers"]


def _synthetic_images(n, num_classes, hw, seed, channels=1, template_seed=1234):
    # the templates are shared by the splits (template_seed); only the noise
    # differs, so the task generalises
    h, w = hw
    templates = np.random.RandomState(template_seed).rand(
        num_classes, channels, h, w).astype(np.float32)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n).astype(np.int64)
    noise = rng.rand(n, channels, h, w).astype(np.float32) * 0.8
    images = templates[labels] + noise
    images = (images / images.max() * 255).astype(np.uint8)
    return images, labels


class MNIST(Dataset):
    """MNIST; synthetic fallback when idx files are absent."""

    NUM_CLASSES = 10
    HW = (28, 28)

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None, root=None):
        self.mode = mode
        self.transform = transform
        images = labels = None
        root = root or image_path
        if root and os.path.isdir(root):
            prefix = "train" if mode == "train" else "t10k"
            img_f = os.path.join(root, f"{prefix}-images-idx3-ubyte.gz")
            lbl_f = os.path.join(root, f"{prefix}-labels-idx1-ubyte.gz")
            if os.path.exists(img_f) and os.path.exists(lbl_f):
                images = self._read_idx_images(img_f)
                labels = self._read_idx_labels(lbl_f)
        if images is None:
            n = 2048 if mode == "train" else 512
            images, labels = _synthetic_images(
                n, self.NUM_CLASSES, self.HW, seed=0 if mode == "train" else 1)
            images = images[:, 0]  # HW, single channel
        self.images = images
        self.labels = labels

    @staticmethod
    def _read_idx_images(path):
        with gzip.open(path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            return np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)

    @staticmethod
    def _read_idx_labels(path):
        with gzip.open(path, "rb") as f:
            _, n = struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), np.uint8).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None]  # 1,28,28
        img = img / 127.5 - 1.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], np.int64)

    def get_arrays(self):
        """The whole dataset as contiguous arrays for the native batcher
        (the values ``__getitem__`` gives); None when a transform must run
        per item. Made at each call (once an epoch): a cached f32 copy
        would hold 4x the dataset's memory for its lifetime."""
        if self.transform is not None:
            return None
        return (self.images.astype(np.float32)[:, None] / 127.5 - 1.0,
                np.asarray(self.labels, np.int64))

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None, download=True, backend=None):
        self.transform = transform
        n = 2048 if mode == "train" else 512
        self.images, self.labels = _synthetic_images(
            n, self.NUM_CLASSES, (32, 32), seed=2 if mode == "train" else 3, channels=3)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 127.5 - 1.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


class Flowers(Dataset):
    """102-category Oxford flowers: synthetic class-templated images, one
    seed a split (train / valid / test), int64 labels in [0, 102)."""

    NUM_CLASSES = 102

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        self.transform = transform
        n = {"train": 2040, "valid": 510, "test": 1020}.get(mode, 1020)
        seed = {"train": 8, "valid": 9, "test": 10}.get(mode, 10)
        self.images, self.labels = _synthetic_images(
            n, self.NUM_CLASSES, (32, 32), seed=seed, channels=3)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 127.5 - 1.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.images)
