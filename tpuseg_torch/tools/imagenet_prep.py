"""ImageNet directory preparation (the port's copy of
``tpuseg/tools/imagenet_prep.py``; the reference's imagenet-scripts/
prep_train.py and valprep.sh):

- ``train``: extract each per-class train archive ``n*.tar`` into its
  synset directory;
- ``val``: move the validation JPEGs into synset directories by the
  standard (filename -> synset) mapping file.

    python -m tpuseg_torch.tools.imagenet_prep train <train_dir>
    python -m tpuseg_torch.tools.imagenet_prep val <val_dir> <mapping_file>
"""

from __future__ import annotations

import argparse
import os
import shutil
import tarfile
from os.path import join


def prep_train(train_dir: str) -> int:
    """Extract every ``*.tar`` in ``train_dir`` into a same-named directory;
    returns the number of archives."""
    n = 0
    for fname in sorted(os.listdir(train_dir)):
        if not fname.endswith(".tar"):
            continue
        out = join(train_dir, fname[: -len(".tar")])
        os.makedirs(out, exist_ok=True)
        with tarfile.open(join(train_dir, fname)) as tf:
            tf.extractall(out, filter="data")
        n += 1
    return n


def prep_val(val_dir: str, mapping_file: str) -> int:
    """Move val images into synset dirs.  ``mapping_file`` lines read
    ``ILSVRC2012_val_00000001.JPEG n01751748``; other lines and images not
    present are skipped.  Returns the number of images moved."""
    n = 0
    with open(mapping_file) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) != 2:
                continue
            img, synset = parts
            src = join(val_dir, img)
            if not os.path.exists(src):
                continue
            dst_dir = join(val_dir, synset)
            os.makedirs(dst_dir, exist_ok=True)
            shutil.move(src, join(dst_dir, img))
            n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpuseg_torch.tools.imagenet_prep",
                                description="ImageNet dir prep")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train")
    t.add_argument("train_dir")
    v = sub.add_parser("val")
    v.add_argument("val_dir")
    v.add_argument("mapping_file")
    args = p.parse_args(argv)
    if args.cmd == "train":
        n = prep_train(args.train_dir)
        print(f"extracted {n} class archives")
    else:
        n = prep_val(args.val_dir, args.mapping_file)
        print(f"moved {n} images")
    return n


if __name__ == "__main__":
    main()
