"""Structured synthetic segmentation world ("shapes"): the trained-weights
fidelity proxy.

The reference's accuracy story rides on trained Cityscapes checkpoints
(drn_d_22_cityscapes.pth at ~68 mIoU), whose blobs are stripped from the
mirror here.  Every fidelity number measured on RANDOM weights is suspect
in a specific direction: random-weight segmentation maps are large smooth
blobs, which is exactly the content that flatters temporal id-reuse
(agreement is lost at sharp MOVING boundaries, which random weights never
produce).  This module fabricates a world a small DRN actually learns to
high mIoU in minutes, with sharp class boundaries and controlled motion,
so int8/temporal/warp agreement and pruning-recovery curves can be
measured on CONVERGED weights (tpuseg.tools.trained_fidelity).

Design, chosen for what the fidelity measurements need rather than realism:

- class identity is carried by color+texture (each class has a base RGB
  and per-pixel noise), so DRN-D-22 reaches >0.9 mIoU quickly — we want
  converged sharp predictors, not a hard research benchmark;
- objects are circles / axis-aligned rectangles / triangles with hard
  edges: the temporal modes' adversarial case;
- the video variant moves each object with a constant per-object velocity
  (bouncing at the borders) plus an optional global pan, giving both the
  translational motion block-matching warp can model and the
  non-rigid-per-object residue it cannot;
- everything is deterministic in the seed (np.random.Generator).

The renderer is plain vectorized numpy over coordinate grids (z-order
painting); dataset emission reuses the Cityscapes file-list format so the
existing readers and CLIs consume it unchanged (reference format:
datasets/info.json + {split}_images/labels.txt, SegList contract).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

# class 0 is background; 1..5 are object classes.  Colors are separated
# enough to be learnable under sigma=18 texture noise but not saturated
# corners (int8 quantization sees realistic activation ranges).
N_CLASSES = 6
CLASS_COLORS = np.array(
    [
        [72, 88, 60],  # background: dark olive
        [200, 60, 50],  # class 1: red
        [55, 130, 200],  # class 2: blue
        [230, 190, 60],  # class 3: yellow
        [90, 180, 90],  # class 4: green
        [160, 80, 180],  # class 5: purple
    ],
    dtype=np.float32,
)
_NOISE_SIGMA = 18.0
_SHAPE_KINDS = ("circle", "rect", "tri")


@dataclasses.dataclass
class ShapeObj:
    kind: str  # circle | rect | tri
    cls: int  # 1..N_CLASSES-1
    cx: float
    cy: float
    size: float  # radius / half-extent, in pixels
    aspect: float  # rect/tri width multiplier
    vx: float  # px / frame
    vy: float


def sample_scene(
    rng: np.random.Generator,
    h: int,
    w: int,
    n_objects: tuple[int, int] = (4, 8),
    speed: float = 0.0,
) -> list[ShapeObj]:
    """Sample a scene's object list.  ``speed`` > 0 adds per-object motion
    (uniform in [-speed, speed] px/frame per axis, never both ~0)."""
    n = int(rng.integers(n_objects[0], n_objects[1] + 1))
    objs = []
    for _ in range(n):
        vx = vy = 0.0
        if speed > 0:
            while abs(vx) + abs(vy) < 0.5 * speed:
                vx = float(rng.uniform(-speed, speed))
                vy = float(rng.uniform(-speed, speed))
        objs.append(
            ShapeObj(
                kind=_SHAPE_KINDS[int(rng.integers(len(_SHAPE_KINDS)))],
                cls=int(rng.integers(1, N_CLASSES)),
                cx=float(rng.uniform(0.1 * w, 0.9 * w)),
                cy=float(rng.uniform(0.1 * h, 0.9 * h)),
                size=float(rng.uniform(0.08, 0.22) * min(h, w)),
                aspect=float(rng.uniform(0.6, 1.7)),
                vx=vx,
                vy=vy,
            )
        )
    return objs


def _object_mask(o: ShapeObj, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    dx, dy = xx - o.cx, yy - o.cy
    if o.kind == "circle":
        return dx * dx + dy * dy < o.size * o.size
    if o.kind == "rect":
        return (np.abs(dx) < o.size * o.aspect) & (np.abs(dy) < o.size)
    # upright isoceles triangle: apex at cy-size, base at cy+size
    half_w = o.size * o.aspect * (dy + o.size) / (2 * o.size)
    return (np.abs(dy) < o.size) & (np.abs(dx) < half_w)


def scene_label(
    objs: list[ShapeObj], h: int, w: int, t: float = 0.0
) -> np.ndarray:
    """Ground-truth label map at time ``t`` (objects advanced by
    t*velocity, bouncing off borders)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    label = np.zeros((h, w), np.uint8)
    for o in objs:
        if t and (o.vx or o.vy):
            # reflect at [margin, extent-margin] so objects stay visible
            o = dataclasses.replace(
                o,
                cx=_bounce(o.cx + t * o.vx, w, o.size),
                cy=_bounce(o.cy + t * o.vy, h, o.size),
            )
        label[_object_mask(o, yy, xx)] = o.cls
    return label


def render_scene(
    objs: list[ShapeObj],
    h: int,
    w: int,
    rng: np.random.Generator,
    t: float = 0.0,
    texture: np.ndarray | None = None,
    sensor_sigma: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Render the scene at time ``t``.  Returns (image uint8 (h,w,3),
    label uint8 (h,w)).

    Two noise regimes: for still datasets, leave ``texture=None`` and the
    full sigma-18 texture is sampled fresh from ``rng``.  For VIDEO, pass a
    fixed per-video ``texture`` field plus a small ``sensor_sigma`` — the
    texture is scene-static (a static camera sees the same surface grain
    every frame) so inter-frame deltas are dominated by OBJECT MOTION, not
    decorrelated noise; otherwise the budgeted temporal mode's drift scan
    would see a uniform sigma*2/sqrt(pi) ~= 20 noise floor and lose its
    signal entirely.
    """
    label = scene_label(objs, h, w, t)
    if texture is None:
        texture = rng.normal(0.0, _NOISE_SIGMA, (h, w, 3))
    img = CLASS_COLORS[label] + texture
    if sensor_sigma:
        img = img + rng.normal(0.0, sensor_sigma, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8), label


def _bounce(x: float, extent: int, margin: float) -> float:
    """Reflect x into [margin, extent-margin] (triangle-wave fold)."""
    lo, hi = margin, extent - margin
    if hi <= lo:
        return 0.5 * extent
    period = 2 * (hi - lo)
    x = (x - lo) % period
    return lo + (period - x if x > hi - lo else x)


def shapes_video(
    n_frames: int,
    size: tuple[int, int],
    seed: int = 0,
    speed: float = 4.0,
    n_objects: tuple[int, int] = (5, 9),
) -> tuple[np.ndarray, np.ndarray]:
    """A deterministic moving-shapes video with per-frame ground truth.

    Returns (frames uint8 (N,H,W,3), labels uint8 (N,H,W)).  ``speed`` is
    the max per-object translation in px/frame — at the default 4 px/frame
    a reused keyframe id map is stale by up to 4*N px under ``--temporal
    N``, which is what the fidelity report is designed to expose.
    """
    h, w = size
    scene_rng = np.random.default_rng(seed)
    objs = sample_scene(scene_rng, h, w, n_objects, speed=speed)
    texture = scene_rng.normal(0.0, _NOISE_SIGMA, (h, w, 3))
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    labels = np.empty((n_frames, h, w), np.uint8)
    for t in range(n_frames):
        frame_rng = np.random.default_rng((seed + 1) * 100003 + t)
        frames[t], labels[t] = render_scene(
            objs, h, w, frame_rng, t=float(t), texture=texture,
            sensor_sigma=2.0,
        )
    return frames, labels


def make_shapes_dataset(
    out_dir: str,
    n_train: int = 64,
    n_val: int = 16,
    size: tuple[int, int] = (128, 128),
    seed: int = 0,
) -> str:
    """Materialize a Cityscapes-file-list shapes dataset under ``out_dir``
    (info.json + train/val image+label lists), consumable by
    ``tpuseg.cli.semantic_seg -d out_dir``.  Returns ``out_dir``."""
    from PIL import Image

    h, w = size
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "labels"), exist_ok=True)
    rng = np.random.default_rng(seed)
    counts = {"train": n_train, "val": n_val}
    for split, n in counts.items():
        im_names, lb_names = [], []
        for i in range(n):
            objs = sample_scene(rng, h, w)
            img, lab = render_scene(objs, h, w, rng)
            im = f"images/{split}_{i:04d}.png"
            lb = f"labels/{split}_{i:04d}.png"
            Image.fromarray(img).save(os.path.join(out_dir, im))
            Image.fromarray(lab).save(os.path.join(out_dir, lb))
            im_names.append(im)
            lb_names.append(lb)
        with open(os.path.join(out_dir, f"{split}_images.txt"), "w") as fh:
            fh.write("\n".join(im_names) + "\n")
        with open(os.path.join(out_dir, f"{split}_labels.txt"), "w") as fh:
            fh.write("\n".join(lb_names) + "\n")
    # normalization stats of the generative process itself
    mean = (CLASS_COLORS.mean(0) / 255.0).tolist()
    with open(os.path.join(out_dir, "info.json"), "w") as fh:
        json.dump(
            {"mean": mean, "std": [0.25, 0.25, 0.25], "classes": N_CLASSES},
            fh,
        )
    return out_dir


def sample_batch(
    rng: np.random.Generator,
    batch: int,
    size: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray]:
    """An infinite-data training batch: fresh scenes every call.
    Returns (images uint8 (B,H,W,3), labels uint8 (B,H,W))."""
    h, w = size
    imgs = np.empty((batch, h, w, 3), np.uint8)
    labs = np.empty((batch, h, w), np.uint8)
    for b in range(batch):
        objs = sample_scene(rng, h, w)
        imgs[b], labs[b] = render_scene(objs, h, w, rng)
    return imgs, labs


# --- synthetic CIFAR-like classification world (rmbsnn fidelity proxy) ---


def sample_cls_batch(
    rng: np.random.Generator,
    batch: int,
    n_classes: int = 10,
    size: int = 32,
) -> tuple[np.ndarray, np.ndarray]:
    """32x32 classification images: one centered shape whose (kind, color)
    pair encodes the class — class = 3*color_group + shape_kind for 9
    classes, class 9 = background-only.  cifar_resnet20 converges to >95%
    in a few hundred steps; used by the pruning-recovery fidelity loop.

    Returns (images float32 (B,size,size,3) normalized to ~N(0,1),
    labels int32 (B,))."""
    imgs = np.empty((batch, size, size, 3), np.float32)
    labels = rng.integers(0, n_classes, batch).astype(np.int32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for b in range(batch):
        c = int(labels[b])
        lab = np.zeros((size, size), np.uint8)
        if c < 9:
            color_group, kind = divmod(c, 3)
            obj = ShapeObj(
                kind=_SHAPE_KINDS[kind],
                cls=color_group + 1,
                cx=float(rng.uniform(0.35, 0.65) * size),
                cy=float(rng.uniform(0.35, 0.65) * size),
                size=float(rng.uniform(0.2, 0.35) * size),
                aspect=1.0,
                vx=0.0,
                vy=0.0,
            )
            lab[_object_mask(obj, yy, xx)] = obj.cls
        img = CLASS_COLORS[lab] + rng.normal(0.0, _NOISE_SIGMA, (size, size, 3))
        imgs[b] = (np.clip(img, 0, 255) - 110.0) / 64.0
    return imgs, labels
