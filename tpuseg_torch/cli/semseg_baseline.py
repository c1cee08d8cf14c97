"""Dense baseline segmentation trainer (counterpart of
``tpuseg/cli/semseg_baseline.py``).

Parity with the reference semseg_baseline.py: the same pipeline as
semantic_seg without the pruner framework, with the reference's own
surfaces implemented (not just forwarded):

- defaults: arch drn_d_54, crop 512 (semseg_baseline.py:614-616)
- ``--sparse-type unstructured --sparsity S``: random unstructured pruning
  of every conv (ref :745-752, prune.random_unstructured at 50%)
- run logging under the reference's wandb project name
  ``cityscapes_semseg_baseline`` (ref :73-75; here: JSONL + TensorBoard via
  tpuseg_torch.metrics.runlog, logging epoch loss / val loss / val mIoU / pixel
  accuracy like wandb.log at :253,:303,:985 and the local ``accuracy`` at
  :120-131)

The training loop itself is tpuseg_torch.cli.semantic_seg's (one trainer,
many front-ends).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and not argv[0].startswith("-"):
        cmd, rest = argv[0], argv[1:]
    else:
        cmd, rest = "train", argv

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--sparse-type", default=None,
                     choices=[None, "unstructured"])
    pre.add_argument("--sparsity", type=float, default=0.5)
    ns, rest = pre.parse_known_args(rest)

    fwd = list(rest)
    if "--arch" not in fwd:
        fwd += ["--arch", "drn_d_54"]
    if "-s" not in fwd and "--crop-size" not in fwd:
        fwd += ["--crop-size", "512"]
    if "--save-dir" not in fwd:
        fwd += ["--save-dir", "runs/cityscapes_semseg_baseline"]
    if ns.sparse_type == "unstructured":
        # ref semseg_baseline.py:752 hardcodes amount=0.5; --sparsity covers
        # the sweep scripts' other settings
        fwd += ["--random-unstructured", str(ns.sparsity)]

    # a baseline run must not pick up pruner-framework flags
    banned = {"--mc-pruning", "--pr-static", "--rejig"}
    out = []
    skip_next = False
    for a in fwd:
        if skip_next:
            skip_next = False
            continue
        if a in banned:
            continue
        if a == "--pr-config-path":
            skip_next = True
            continue
        out.append(a)
    from tpuseg_torch.cli.semantic_seg import main as seg_main

    return seg_main([cmd] + out)


if __name__ == "__main__":
    main()
