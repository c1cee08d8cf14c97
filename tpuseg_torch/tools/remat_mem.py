"""Device memory of a ``--remat`` train step against one without, on the
card (the port's counterpart of ``tpuseg/tools/remat_mem.py``'s ``seg``
case).

``tpuseg`` reads the XLA compiler's buffer assignment of the jitted step.
PyTorch runs the step eagerly and has no such assignment, so this tool
measures the CUDA caching allocator around one step instead:

- ``temp_mb``: ``torch.cuda.max_memory_allocated()`` during the step minus
  the bytes allocated just before it: the activations saved for the
  backward pass, the gradients, workspaces and the new train state the step
  builds (XLA reports that last part apart, as ``out_mb``);
- ``arg_mb``: the bytes of the train state (params, BN state, optimizer
  state) and the batch the step is given.

``out_mb`` (the step's outputs) and ``alias_mb`` (outputs that reuse an
input's buffer) are XLA's buffer-assignment figures; CUDA reports neither,
and the lines leave them out.  Each configuration takes one step first, not
read, so the allocator's lazy set-up (cuBLAS and cuDNN workspaces) falls
outside the measured step.

Prints one JSON line per (case, remat) and a ``temp_ratio`` line:

    python -m tpuseg_torch.tools.remat_mem [--cases seg]

Case ``seg``: DRN-D-22 semantic-seg train step, 768x768 crop, batch 4, bf16,
``make_sgd(0.01)`` (the reference trains 896x896 crops on 8 GPUs' aggregate
memory, semantic_seg.py:809-815).  ``cls`` and ``kd`` need the classifier
arm (ROADMAP A20) and raise ``SystemExit``; so does a CPU device: the tool
measures the card's allocator.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

SEG_CASE = "seg_drn_d_22_768x768_b4"


def seg_case():
    """(case name, params, BN state, spec, optimizer, images, labels) of
    ``tpuseg``'s ``run_seg``: random DRN-D-22 weights from seed 0 with 19
    classes and a zero batch, on the host."""
    from tpuseg_torch.models import init_drnseg
    from tpuseg_torch.train import make_sgd

    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    images = np.zeros((4, 768, 768, 3), np.float32)
    labels = np.zeros((4, 768, 768), np.int32)
    return SEG_CASE, params, state, spec, make_sgd(0.01), images, labels


def _nbytes(tensors) -> int:
    if isinstance(tensors, torch.Tensor):
        return tensors.numel() * tensors.element_size()
    if isinstance(tensors, dict):
        return sum(_nbytes(v) for v in tensors.values())
    if isinstance(tensors, (tuple, list)):
        return sum(_nbytes(v) for v in tensors)
    return 0


def _measure(device, step, ts, batch) -> dict:
    ts, _ = step(ts, *batch)  # the untimed first step
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    new_ts, _ = step(ts, *batch)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    arg = _nbytes([ts.params, ts.bn_state, ts.opt_state, list(batch)])
    del new_ts
    return {"temp_mb": round((peak - before) / 2**20, 2), "arg_mb": round(arg / 2**20, 2)}


def run_seg(device) -> dict:
    from tpuseg_torch.train import create_train_state, make_seg_train_step

    case, params, state, spec, tx, images, labels = seg_case()
    batch = (torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device))
    rows = {}
    for remat in (False, True):
        ts = create_train_state({k: v.to(device) for k, v in params.items()},
                                {k: v.to(device) for k, v in state.items()}, tx)
        step = make_seg_train_step(spec, tx, compute_dtype=torch.bfloat16, remat=remat)
        rows[remat] = _measure(device, step, ts, batch)
        del ts, step
        torch.cuda.empty_cache()
        print(json.dumps({"case": case, "remat": remat, **rows[remat]}))
    out = {"case": case, "rows": rows}
    if rows[False]["temp_mb"]:
        out["temp_ratio"] = round(rows[True]["temp_mb"] / rows[False]["temp_mb"], 3)
        print(json.dumps({"case": case, "temp_ratio": out["temp_ratio"]}))
    return out


def main(argv=None) -> list:
    from tpuseg_torch.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cases", default="seg", help="comma list of seg, cls, kd")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cuda:N")
    args = p.parse_args(argv)
    cases = [c.strip() for c in args.cases.split(",")]
    unknown = [c for c in cases if c not in ("seg", "cls", "kd")]
    if unknown:
        raise SystemExit(f"--cases: unknown {unknown}; have ['cls', 'kd', 'seg']")
    if set(cases) & {"cls", "kd"}:
        raise SystemExit("remat_mem: the cls and kd cases need the classifier arm "
                         "(cifar_resnet20/56), which is not ported yet (ROADMAP A20)")
    if torch.device(args.device).type != "cuda":
        raise SystemExit(f"remat_mem measures the CUDA caching allocator; --device "
                         f"{args.device} has none")
    device = resolve_device(args.device)
    return [run_seg(device) for _ in cases]


if __name__ == "__main__":
    main()
