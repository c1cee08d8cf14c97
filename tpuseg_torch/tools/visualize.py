"""Mask / layer visualization (the port's copy of ``tpuseg/tools/visualize.py``;
the reference's tools/visualize_layers.py:8-62, per-layer imshow of the
nonzero pattern).  Writes PNGs headless instead of ``plt.show()``.

    python -m tpuseg_torch.tools.visualize checkpoint.npz [--out-dir layer_viz]
        [--max-layers N]

The checkpoint is an npz of either package's trainer
(``tpuseg_torch.train.checkpoint``); its masks, when it has any, are applied
first.  matplotlib is imported only when a figure is drawn.
"""

from __future__ import annotations

import argparse
import os
from typing import Mapping

import numpy as np
import torch


def visualize_layer_masks(
    params: Mapping,
    out_dir: str,
    max_layers: int | None = None,
) -> list[str]:
    """Render the nonzero pattern of each sparse conv (OIHW) or Linear
    weight, as its (O, I*kh*kw) matrix, to ``<out_dir>/<name>.png``; dense
    layers and ``up.weight`` are skipped.  Returns the paths written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, v in params.items():
        w = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        if w.ndim not in (2, 4) or name == "up.weight":
            continue
        mat = w.reshape(w.shape[0], -1)
        sp = 1.0 - np.count_nonzero(mat) / mat.size
        if sp <= 0:
            continue
        fig, ax = plt.subplots(figsize=(8, 6))
        ax.imshow(mat != 0, cmap="gray", aspect="auto", interpolation="nearest")
        ax.set_title(f"{name}  sparsity={sp * 100:.1f}%")
        path = os.path.join(out_dir, name.replace("/", "_") + ".png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
        if max_layers is not None and len(written) >= max_layers:
            break
    return written


def main(argv=None) -> list[str]:
    from tpuseg_torch.sparsity import apply_masks
    from tpuseg_torch.train.checkpoint import load_checkpoint

    p = argparse.ArgumentParser(prog="python -m tpuseg_torch.tools.visualize",
                                description="visualize sparse layer masks")
    p.add_argument("checkpoint")
    p.add_argument("--out-dir", default="layer_viz")
    p.add_argument("--max-layers", type=int, default=None)
    args = p.parse_args(argv)
    params, _, masks, _, _ = load_checkpoint(args.checkpoint)
    if masks:
        params = apply_masks(params, masks)
    paths = visualize_layer_masks(params, args.out_dir, args.max_layers)
    print(f"wrote {len(paths)} images to {args.out_dir}")
    return paths


if __name__ == "__main__":
    main()
