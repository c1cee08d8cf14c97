"""Classification datasets: CIFAR-10/100, MNIST, ImageNet-folder
(counterpart of ``tpuseg/data/classification.py``, the same readers, draws
and recipes).

Parity with the reference utils.py:27-150 (get_train_and_val_loaders): the
same normalization constants and augmentation recipe (CIFAR: pad-4 random
crop + horizontal flip; ImageNet: RandomResizedCrop(224) + flip).  CIFAR and
MNIST are parsed from their standard binary formats with numpy; only
``ImageFolderDataset`` needs PIL, and imports it when it decodes.
"""

from __future__ import annotations

import gzip
import os
import pickle
from os.path import join

import numpy as np

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2023, 0.1994, 0.2010)
CIFAR100_MEAN = (0.5071, 0.4867, 0.4408)
CIFAR100_STD = (0.2675, 0.2565, 0.2761)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MNIST_MEAN = (0.1307,)
MNIST_STD = (0.3081,)


def _load_cifar_batches(root: str, files, key=b"labels"):
    xs, ys = [], []
    for f in files:
        with open(f, "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        ys.append(np.asarray(d[key], dtype=np.int32))
    return np.concatenate(xs), np.concatenate(ys)


def load_cifar(root: str, dataset: str = "cifar10", train: bool = True):
    """Read CIFAR from the standard python pickle batches."""
    if dataset == "cifar10":
        base = join(root, "cifar-10-batches-py")
        files = (
            [join(base, f"data_batch_{i}") for i in range(1, 6)]
            if train
            else [join(base, "test_batch")]
        )
        return _load_cifar_batches(root, files, b"labels")
    base = join(root, "cifar-100-python")
    files = [join(base, "train" if train else "test")]
    return _load_cifar_batches(root, files, b"fine_labels")


def load_mnist(root: str, train: bool = True):
    kind = "train" if train else "t10k"
    def rd(name):
        path = join(root, name)
        op = gzip.open if path.endswith(".gz") else open
        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            path += ".gz"
            op = gzip.open
        with op(path, "rb") as fh:
            return fh.read()
    imgs = np.frombuffer(rd(f"{kind}-images-idx3-ubyte"), dtype=np.uint8, offset=16)
    lbls = np.frombuffer(rd(f"{kind}-labels-idx1-ubyte"), dtype=np.uint8, offset=8)
    return imgs.reshape(-1, 28, 28, 1), lbls.astype(np.int32)


class ArrayClassDataset:
    """In-memory images (N,H,W,C uint8) + labels with torch-recipe
    augmentation."""

    def __init__(self, images, labels, mean, std, train=False, pad=4,
                 rng=None, flip=True):
        self.images = images
        self.labels = labels
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.train = train
        self.pad = pad
        self.flip = flip
        self.rng = rng or np.random.default_rng()

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = self.images[i]
        if self.train:
            h, w = img.shape[:2]
            p = self.pad
            padded = np.zeros((h + 2 * p, w + 2 * p, img.shape[2]), img.dtype)
            padded[p : p + h, p : p + w] = img
            y0 = int(self.rng.integers(0, 2 * p + 1))
            x0 = int(self.rng.integers(0, 2 * p + 1))
            img = padded[y0 : y0 + h, x0 : x0 + w]
            if self.flip and self.rng.random() < 0.5:
                img = img[:, ::-1]
        x = img.astype(np.float32) / 255.0
        x = (x - self.mean) / self.std
        return x, np.int32(self.labels[i])


class SyntheticClassDataset:
    def __init__(self, n, size, channels, classes, seed=0):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, size=(n, size, size, channels), dtype=np.uint8)
        self.labels = rng.integers(0, classes, size=n).astype(np.int32)
        self.mean = np.zeros(channels, np.float32)
        self.std = np.ones(channels, np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i].astype(np.float32) / 255.0, self.labels[i]


class ImageFolderDataset:
    """ImageNet-style class-per-directory reader (utils.py ImageNet branch)."""

    def __init__(self, root, train=False, size=224, mean=IMAGENET_MEAN,
                 std=IMAGENET_STD, rng=None):
        self.samples = []
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        for c in classes:
            d = join(root, c)
            for f in sorted(os.listdir(d)):
                self.samples.append((join(d, f), self.class_to_idx[c]))
        self.train = train
        self.size = size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.rng = rng or np.random.default_rng()

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from PIL import Image

        path, label = self.samples[i]
        img = Image.open(path).convert("RGB")
        if self.train:
            # RandomResizedCrop(size): random area in [0.08, 1], ratio 3/4..4/3
            cropped = False
            for _ in range(10):
                area = img.size[0] * img.size[1]
                target = area * self.rng.uniform(0.08, 1.0)
                ratio = np.exp(self.rng.uniform(np.log(3 / 4), np.log(4 / 3)))
                w = int(round(np.sqrt(target * ratio)))
                h = int(round(np.sqrt(target / ratio)))
                if w <= img.size[0] and h <= img.size[1]:
                    x0 = int(self.rng.integers(0, img.size[0] - w + 1))
                    y0 = int(self.rng.integers(0, img.size[1] - h + 1))
                    img = img.crop((x0, y0, x0 + w, y0 + h))
                    cropped = True
                    break
            if not cropped:
                # torchvision fallback: centered max-area crop at the
                # nearest in-range ratio (extreme-aspect images would
                # otherwise be squashed anisotropically to a square)
                w, h = img.size
                in_ratio = w / h
                if in_ratio < 3 / 4:
                    cw, ch = w, int(round(w / (3 / 4)))
                elif in_ratio > 4 / 3:
                    cw, ch = int(round(h * (4 / 3))), h
                else:
                    cw, ch = w, h
                x0, y0 = (w - cw) // 2, (h - ch) // 2
                img = img.crop((x0, y0, x0 + cw, y0 + ch))
            img = img.resize((self.size, self.size), Image.BILINEAR)
            if self.rng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            # Resize(256) + CenterCrop(size)
            short = 256
            w, h = img.size
            if w < h:
                img = img.resize((short, int(h * short / w)), Image.BILINEAR)
            else:
                img = img.resize((int(w * short / h), short), Image.BILINEAR)
            w, h = img.size
            x0, y0 = (w - self.size) // 2, (h - self.size) // 2
            img = img.crop((x0, y0, x0 + self.size, y0 + self.size))
        x = np.asarray(img, np.float32) / 255.0
        x = (x - self.mean) / self.std
        return x, np.int32(label)


def make_class_datasets(dataset: str, data_dir: str, seed: int = 0):
    """(train_ds, val_ds) for a dataset name, matching utils.py recipes."""
    rng = np.random.default_rng(seed)
    d = dataset.lower()
    if d == "cifar10":
        xtr, ytr = load_cifar(data_dir, "cifar10", True)
        xte, yte = load_cifar(data_dir, "cifar10", False)
        return (
            ArrayClassDataset(xtr, ytr, CIFAR10_MEAN, CIFAR10_STD, True, rng=rng),
            ArrayClassDataset(xte, yte, CIFAR10_MEAN, CIFAR10_STD, False),
        )
    if d == "cifar100":
        xtr, ytr = load_cifar(data_dir, "cifar100", True)
        xte, yte = load_cifar(data_dir, "cifar100", False)
        return (
            ArrayClassDataset(xtr, ytr, CIFAR100_MEAN, CIFAR100_STD, True, rng=rng),
            ArrayClassDataset(xte, yte, CIFAR100_MEAN, CIFAR100_STD, False),
        )
    if d == "mnist":
        xtr, ytr = load_mnist(data_dir, True)
        xte, yte = load_mnist(data_dir, False)
        return (
            ArrayClassDataset(xtr, ytr, MNIST_MEAN, MNIST_STD, True, pad=0,
                              rng=rng, flip=False),
            ArrayClassDataset(xte, yte, MNIST_MEAN, MNIST_STD, False),
        )
    if d == "imagenet":
        return (
            ImageFolderDataset(join(data_dir, "train"), train=True, rng=rng),
            ImageFolderDataset(join(data_dir, "val"), train=False),
        )
    raise ValueError(f"unknown dataset {dataset!r}")
