"""Paired (image, label) transforms — numpy/PIL (counterpart of
``tpuseg/data/transforms.py``).

Behavioral reference: the reference's data_transforms.py.  Same protocol:
each transform is called ``t(image, label, *extra)`` and returns the updated
tuple; ``Compose`` threads the tuple through (data_transforms.py:284-294).
Labels are padded with 255 (the ignore index), images by reflection.

Outputs are NHWC float32 in [0,1] (``ToArray``), not CHW, as in
``tpuseg``.  Randomness comes from an explicit ``np.random.Generator``.
PIL is imported where a transform first needs it, so that code which only
imports this module (synthetic training) loads no PIL.
"""

from __future__ import annotations

import numbers
from typing import Any

import numpy as np


def _image():
    from PIL import Image

    return Image


def pad_reflection(image: np.ndarray, top, bottom, left, right) -> np.ndarray:
    """Mixed-mode reflection pad with the reference's exact semantics
    (data_transforms.py:128-155, verified element-exact in tests): the top
    and left sides reflect EXCLUDING the edge pixel (np.pad ``reflect``),
    the bottom and right sides reflect INCLUDING it (np.pad ``symmetric``).
    Pads larger than the image reflect at most dim-1 pixels per bounce and
    recurse on the padded result (which differs from np.pad's own
    multi-bounce handling, hence the explicit recursion)."""
    if top == bottom == left == right == 0:
        return image
    h, w = image.shape[:2]
    if (h == 1 and (top or bottom)) or (w == 1 and (left or right)):
        # edge-excluding reflection of a 1-pixel dimension has nothing to
        # reflect; the reference recurses forever here — fail loudly
        raise ValueError(
            f"cannot reflect-pad a 1-pixel dimension (shape {image.shape})")
    next_top = next_bottom = next_left = next_right = 0
    if top > h - 1:
        next_top, top = top - h + 1, h - 1
    if bottom > h - 1:
        next_bottom, bottom = bottom - h + 1, h - 1
    if left > w - 1:
        next_left, left = left - w + 1, w - 1
    if right > w - 1:
        next_right, right = right - w + 1, w - 1
    ext = [(0, 0)] * (image.ndim - 2)
    out = np.pad(
        np.pad(image, [(top, 0), (left, 0)] + ext, mode="reflect"),
        [(0, bottom), (0, right)] + ext,
        mode="symmetric",
    )
    return pad_reflection(out, next_top, next_bottom, next_left, next_right)


def pad_constant(image, top, bottom, left, right, value):
    if top == bottom == left == right == 0:
        return image
    ext = [(0, 0)] * (image.ndim - 2)
    return np.pad(
        image, [(top, bottom), (left, right)] + ext,
        mode="constant", constant_values=value,
    )


def pad_image(mode: str, image, top, bottom, left, right, value=0):
    arr = np.asarray(image)
    if mode == "reflection":
        out = pad_reflection(arr, top, bottom, left, right)
    elif mode == "constant":
        out = pad_constant(arr, top, bottom, left, right, value)
    else:
        raise ValueError(f"Unknown mode {mode}")
    return _image().fromarray(out)


class RandomCrop:
    """Pad-to-size (label: constant 255, image: reflection) then random crop
    (data_transforms.py:9-45)."""

    def __init__(self, size, rng: np.random.Generator | None = None):
        self.size = (int(size), int(size)) if isinstance(size, numbers.Number) else size
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, label, *args):
        w, h = image.size
        tw, th = self.size
        top = bottom = left = right = 0
        if w < tw:
            left = (tw - w) // 2
            right = tw - w - left
        if h < th:
            top = (th - h) // 2
            bottom = th - h - top
        if left or right or top or bottom:
            if label is not None:
                label = pad_image("constant", label, top, bottom, left, right, 255)
            image = pad_image("reflection", image, top, bottom, left, right)
        w, h = image.size
        if (w, h) == (tw, th):
            return (image, label, *args)
        x1 = int(self.rng.integers(0, w - tw + 1))
        y1 = int(self.rng.integers(0, h - th + 1))
        out = [image.crop((x1, y1, x1 + tw, y1 + th))]
        if label is not None:
            out.append(label.crop((x1, y1, x1 + tw, y1 + th)))
        out.extend(args)
        return tuple(out)


class RandomScale:
    def __init__(self, scale, rng: np.random.Generator | None = None):
        if isinstance(scale, numbers.Number):
            scale = [1 / scale, scale]
        self.scale = scale
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, label):
        ratio = float(self.rng.uniform(self.scale[0], self.scale[1]))
        w, h = image.size
        tw, th = int(ratio * w), int(ratio * h)
        if ratio == 1:
            return image, label
        Image = _image()
        interp = Image.LANCZOS if ratio < 1 else Image.BICUBIC
        return (
            image.resize((tw, th), interp),
            label.resize((tw, th), Image.NEAREST),
        )


class RandomRotate:
    def __init__(self, angle, rng: np.random.Generator | None = None):
        self.angle = angle
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, label=None, *args):
        Image = _image()
        w, h = image.size
        angle = int(self.rng.integers(0, self.angle * 2 + 1)) - self.angle
        if label is not None:
            label = pad_image("constant", label, h, h, w, w, value=255)
            label = label.rotate(angle, resample=Image.NEAREST)
            label = label.crop((w, h, w + w, h + h))
        image = pad_image("reflection", image, h, h, w, w)
        image = image.rotate(angle, resample=Image.BILINEAR)
        image = image.crop((w, h, w + w, h + h))
        return image, label


class RandomHorizontalFlip:
    def __init__(self, rng: np.random.Generator | None = None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, label):
        if self.rng.random() < 0.5:
            flip = _image().FLIP_LEFT_RIGHT
            return image.transpose(flip), label.transpose(flip)
        return image, label


class Normalize:
    """(x - mean) / std on HWC float arrays (data_transforms.py:109-125)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, image, label=None):
        image = (image - self.mean) / self.std
        if label is None:
            return (image,)
        return image, label


class Pad:
    def __init__(self, padding, fill=0):
        self.padding = padding
        self.fill = fill

    def __call__(self, image, label=None, *args):
        p = self.padding
        if label is not None:
            label = pad_image("constant", label, p, p, p, p, value=255)
        if self.fill == -1:
            image = pad_image("reflection", image, p, p, p, p)
        else:
            image = pad_image("constant", image, p, p, p, p, value=self.fill)
        return (image, label, *args)


class ToArray:
    """PIL -> HWC float32 in [0,1]; label -> int32 array
    (ToTensor, data_transforms.py:228-253, without the CHW transpose)."""

    def __call__(self, pic, label=None):
        img = np.asarray(pic, dtype=np.float32) / 255.0
        if img.ndim == 2:
            img = img[..., None]
        if label is None:
            return (img,)
        return img, np.asarray(label, dtype=np.int32)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, *args):
        for t in self.transforms:
            args = t(*args)
        return args
