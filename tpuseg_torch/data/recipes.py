"""ADE20K / PASCAL-VOC segmentation data recipes (counterpart of
``tpuseg/data/recipes.py``; numpy only).

The reference hooks these datasets through the same list-file protocol as
Cityscapes (``{phase}_images.txt`` / ``{phase}_labels.txt`` consumed by
SegList, the reference's cityscapes_dataset.py:80-89) and knows their class
counts (our models/factory.py: ade20k=150, voc=21), but ships no list
generators or normalization stats.  This module supplies them:

- ``prepare_ade20k_lists`` / ``prepare_voc_lists``: scan the standard
  dataset layouts and write SegList-compatible list files + ``info.json``
- ``ADE20K_INFO`` / ``VOC_INFO``: ImageNet normalization stats (what the
  upstream DRN training recipes use for both datasets)
- ``voc_palette()``: the canonical VOC color map (bit-interleaving
  generator); ``ade20k_remap_labels``: ADE20K's 0=unlabeled, 1..150 scheme
  remapped to 0..149 with 255 ignore (matching the CE ignore_index=255
  convention, ref semantic_seg.py:817)

CLI: ``python -m tpuseg_torch.data.recipes {ade20k,voc} --root ... --out ...``
"""

from __future__ import annotations

import json
import os
from os.path import join, relpath

import numpy as np

# upstream DRN recipes normalize ADE20K/VOC with ImageNet stats
ADE20K_INFO = {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}
VOC_INFO = {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}


def voc_palette(n: int = 256) -> np.ndarray:
    """Canonical PASCAL-VOC colormap (bit-interleaving construction)."""
    pal = np.zeros((n, 3), np.uint8)
    for i in range(n):
        c = i
        r = g = b = 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i] = (r, g, b)
    return pal


def ade20k_remap_labels(label: np.ndarray) -> np.ndarray:
    """ADE20K annotation png (0=unlabeled, 1..150) -> 0..149 with 255 ignore."""
    out = label.astype(np.int32) - 1
    out[out < 0] = 255
    return out.astype(np.uint8)


def _write_lists(out_dir: str, phase: str, images: list[str],
                 labels: list[str]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(join(out_dir, f"{phase}_images.txt"), "w") as fh:
        fh.write("\n".join(images) + ("\n" if images else ""))
    with open(join(out_dir, f"{phase}_labels.txt"), "w") as fh:
        fh.write("\n".join(labels) + ("\n" if labels else ""))


def prepare_ade20k_lists(root: str, out_dir: str | None = None) -> dict:
    """Generate SegList files for the ADEChallengeData2016 layout:

    root/images/{training,validation}/ADE_*.jpg
    root/annotations/{training,validation}/ADE_*.png
    """
    out_dir = out_dir or root
    counts = {}
    for split, phase in (("training", "train"), ("validation", "val")):
        img_dir = join(root, "images", split)
        ann_dir = join(root, "annotations", split)
        if not os.path.isdir(img_dir):
            counts[phase] = 0
            continue
        images, labels = [], []
        for name in sorted(os.listdir(img_dir)):
            stem_, ext = os.path.splitext(name)
            if ext.lower() not in (".jpg", ".jpeg", ".png"):
                continue
            ann = join(ann_dir, stem_ + ".png")
            if not os.path.exists(ann):
                continue
            images.append(relpath(join(img_dir, name), root))
            labels.append(relpath(ann, root))
        _write_lists(out_dir, phase, images, labels)
        counts[phase] = len(images)
    with open(join(out_dir, "info.json"), "w") as fh:
        json.dump(ADE20K_INFO, fh)
    return counts


def prepare_voc_lists(root: str, out_dir: str | None = None,
                      aug_dir: str | None = None) -> dict:
    """Generate SegList files for the VOC2012 layout:

    root/JPEGImages/*.jpg, root/SegmentationClass/*.png,
    root/ImageSets/Segmentation/{train,val}.txt

    ``aug_dir`` optionally points at SBD-augmented labels
    (SegmentationClassAug) used by the common train_aug recipe.
    """
    out_dir = out_dir or root
    seg_cls = aug_dir or join(root, "SegmentationClass")
    counts = {}
    for phase in ("train", "val"):
        ids_file = join(root, "ImageSets", "Segmentation", f"{phase}.txt")
        if not os.path.exists(ids_file):
            counts[phase] = 0
            continue
        with open(ids_file) as fh:
            ids = [ln.strip() for ln in fh if ln.strip()]
        images, labels = [], []
        for i in ids:
            img = join(root, "JPEGImages", i + ".jpg")
            ann = join(seg_cls, i + ".png")
            if os.path.exists(img) and os.path.exists(ann):
                images.append(relpath(img, root))
                labels.append(relpath(ann, root))
        _write_lists(out_dir, phase, images, labels)
        counts[phase] = len(images)
    with open(join(out_dir, "info.json"), "w") as fh:
        json.dump(VOC_INFO, fh)
    return counts


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Generate SegList data recipes")
    p.add_argument("dataset", choices=["ade20k", "voc"])
    p.add_argument("--root", required=True)
    p.add_argument("--out", default=None, help="list output dir (default: root)")
    p.add_argument("--aug-dir", default=None, help="VOC: SBD-augmented labels")
    args = p.parse_args(argv)
    if args.dataset == "ade20k":
        counts = prepare_ade20k_lists(args.root, args.out)
    else:
        counts = prepare_voc_lists(args.root, args.out, args.aug_dir)
    print(json.dumps({"dataset": args.dataset, **counts}))


if __name__ == "__main__":
    main()
