"""Unstructured-pruning segmentation trainer (counterpart of
``tpuseg/cli/semseg_unstructured.py``).

Parity with the reference semseg_unstructured.py — L1 magnitude
unstructured pruning of every conv at ``--sparsity`` with mask-aware
sparsity accounting (measure_module_sparsity/measure_global_sparsity,
semseg_unstructured.py:81-136, prune loop :769-777).

Front-end over tpuseg_torch.cli.semantic_seg's --unstructured-sparsity path, plus
the global-sparsity report.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--sparsity", type=float, default=0.5)
    ns, rest = pre.parse_known_args(argv)
    if rest and not rest[0].startswith("-"):
        cmd, rest = rest[0], rest[1:]
    else:
        cmd = "train"
    from tpuseg_torch.cli.semantic_seg import main as seg_main

    seg_main([cmd, "--unstructured-sparsity", str(ns.sparsity)] + rest)


def report_global_sparsity(params, masks):
    from tpuseg_torch.train.unstructured import measure_global_sparsity

    zeros, total, sp = measure_global_sparsity(params, masks)
    print(json.dumps({"num_zeros": zeros, "num_elements": total,
                      "global_sparsity": round(sp, 6)}))


if __name__ == "__main__":
    main()
