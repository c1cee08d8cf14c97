"""Experiment sweeper: generate RBGP configs and launch training runs
(counterpart of ``tpuseg/cli/expander_batch.py``).

Parity with the reference expander_batch.py: a sweep over (arch x inner
block x inner sparsity, optionally with a KD arm), a reference-schema
``srmbrep`` JSON per experiment (dump_config_file, expander_batch.py:13-153;
fixed opat = ipat = "RAMANUJAN", cross_prob = 0.5 at :184-190) and the
trainer command lines (:353-358), which run the port's own CLIs
(``tpuseg_torch.cli.rmbsnn`` or ``semantic_seg train``).  The first conv and
the classifier head are never pruned (:27-43).

    python -m tpuseg_torch.cli.expander_batch --arch cifar_resnet20 \\
        --sparsities 0.5 --iblocks 1x1 --epochs 1 --extra "--device cpu" [--launch]
    python -m tpuseg_torch.cli.expander_batch --collect --out-dir runs/sweep
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
from os.path import join

import numpy as np

# first/last layers never pruned, per arch family (expander_batch.py:27-43)
_DRN_NON_RBGP = ["layer.0.0", "fc", "seg", "up"]
NON_RBGP = {
    "drn_d_22": _DRN_NON_RBGP,
    "drn_d_54": _DRN_NON_RBGP,
    "cifar_resnet20": ["conv1", "fc"],
    "cifar_resnet18": ["conv1", "fc"],
    "cifar_vgg19_bn": ["features.0", "classifier.3"],
    "cifar_rvgg11_512_bn": ["features.0", "classifier.6"],
    "cifar_res_rvgg11_512_bn": ["features.0", "classifier.6"],
    "cifar_wrn_16_4": ["conv1", "linear"],
    "cifar_wrn_16_10": ["conv1", "linear"],
    "cifar_wrn_28_10": ["conv1", "linear"],
    "cifar_wrn_40_4": ["conv1", "linear"],
}


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def prunable_layers(params: dict, arch: str) -> list[str]:
    """Conv/FC weights minus the excluded first/last layers (every DRN
    variant shares one exclusion set: stem, classifier, seg head,
    upsampler)."""
    excluded = NON_RBGP.get(arch, _DRN_NON_RBGP if arch.startswith("drn_") else [])
    out = []
    for name, v in params.items():
        if not name.endswith(".weight") or _np(v).ndim not in (2, 4):
            continue
        base = name[: -len(".weight")]
        # the exact name or a child scope only: a bare prefix would also
        # drop e.g. "fc2" for the entry "fc"
        if any(base == e or base.startswith(e + ".") for e in excluded):
            continue
        out.append(name)
    return out


def generate_rbgp_config(
    params: dict,
    arch: str,
    oblock: tuple[int, int],
    cblock: tuple[int, int],
    iblock: tuple[int, int],
    osp: float,
    isp: float,
    opat: str = "RAMANUJAN",
    ipat: str = "RAMANUJAN",
    cross_prob: float = 0.5,
) -> dict:
    """One uniform-geometry srmbrep config covering every prunable layer of
    the port's params (OIHW), block sizes clamped to each layer's
    dimensions (``tpuseg``'s rule, config for config)."""
    configs = []
    for layer in prunable_layers(params, arch):
        w = _np(params[layer])
        rows = w.shape[0]
        cols = int(w.reshape(rows, -1).shape[1])
        obh = min(oblock[0], rows)
        obw = min(oblock[1], cols)
        # keep divisibility: fall back to the full extent when not divisible
        if rows % obh:
            obh = rows
        if cols % obw:
            obw = cols
        cbh = min(cblock[0], obh)
        cbw = min(cblock[1], obw)
        if obh % cbh:
            cbh = obh
        if obw % cbw:
            cbw = obw
        ibh, ibw = iblock
        if cbh % ibh or (cbh // ibh) < 2:
            ibh = 1
        if cbw % ibw or (cbw // ibw) < 2:
            ibw = 1
        configs.append({
            "layer_set": [layer],
            "obh": obh, "obw": obw, "cbh": cbh, "cbw": cbw,
            "ibh": ibh, "ibw": ibw,
            "osp": osp, "opat": opat, "isp": isp, "ipat": ipat,
            "is_repetitive": True, "collapse_tensor": True,
            "cross_prob": cross_prob, "is_symmetric": False,
        })
    return {"pruner_type": "srmbrep", "configs": configs}


def main(argv=None):
    p = argparse.ArgumentParser(description="tpuseg_torch experiment sweeper")
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--arch", default="cifar_resnet20")
    p.add_argument("--sparsities", default="0.5,0.75", help="inner sparsities to sweep")
    p.add_argument("--iblocks", default="1x1,2x2", help="inner block sizes")
    p.add_argument("--oblock", default="64x32")
    p.add_argument("--cblock", default="32x32")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--kd", action="store_true", help="add a KD arm per config")
    p.add_argument("--teacher-model", default=None)
    p.add_argument("--out-dir", default="runs/sweep")
    p.add_argument("--data", default=None)
    p.add_argument("--launch", action="store_true",
                   help="run the commands (default: print them)")
    p.add_argument("--extra", default="", help="extra args appended verbatim")
    p.add_argument("--collect", action="store_true",
                   help="collect results from a finished sweep and exit")
    args = p.parse_args(argv)

    if args.collect:
        rows = collect_results(args.out_dir)
        for row in rows:
            print(json.dumps(row))
        return rows

    from tpuseg_torch.models.drn import jax_key
    from tpuseg_torch.models.factory import create_model

    # tpuseg builds the sweep's model from jax.random.key(0)
    params, _, _, meta = create_model(jax_key(0), args.dataset, args.arch)

    def parse_hw(s):
        h, w = s.lower().split("x")
        return int(h), int(w)

    os.makedirs(args.out_dir, exist_ok=True)
    sparsities = [float(s) for s in args.sparsities.split(",")]
    iblocks = [parse_hw(s) for s in args.iblocks.split(",")]
    cmds = []
    for isp, ib in itertools.product(sparsities, iblocks):
        tag = f"{args.arch}_isp{isp}_ib{ib[0]}x{ib[1]}"
        cfg = generate_rbgp_config(params, args.arch, parse_hw(args.oblock),
                                   parse_hw(args.cblock), ib, osp=0.0, isp=isp)
        cfg_path = join(args.out_dir, f"{tag}.json")
        with open(cfg_path, "w") as fh:
            json.dump(cfg, fh, indent=4)
        if meta["kind"] == "seg":
            cmd = (f"{sys.executable} -m tpuseg_torch.cli.semantic_seg train "
                   f"--arch {args.arch} --epochs {args.epochs} "
                   f"--batch-size {args.batch_size} --mc-pruning --pr-static "
                   f"--pr-config-path {cfg_path} --save-dir {join(args.out_dir, tag)}")
            if args.data:
                cmd += f" -d {args.data}"
        else:
            cmd = (f"{sys.executable} -m tpuseg_torch.cli.rmbsnn --dataset {args.dataset} "
                   f"--arch {args.arch} --epochs {args.epochs} "
                   f"--batch-size {args.batch_size} --mc-pruning --pr-static "
                   f"--pr-config-path {cfg_path} --save-dir {join(args.out_dir, tag)}")
            if args.data:
                cmd += f" --data {args.data}"
            if args.kd and args.teacher_model:
                cmd += f" --teacher-model {args.teacher_model}"
        if args.extra:
            cmd += " " + args.extra
        cmds.append(cmd)

    for cmd in cmds:
        print(cmd)
        if args.launch:
            subprocess.run(cmd, shell=True, check=True)
    return cmds


def collect_results(out_dir: str) -> list[dict]:
    """Sweep results (extract_accuracy / extract_spectral_gap,
    expander_batch.py:156-162): each experiment's checkpoint meta and the
    mean normalized spectral gap of its masks."""
    from tpuseg_torch.tools import calculate_spectral_gap
    from tpuseg_torch.train import load_checkpoint

    rows = []
    for name in sorted(os.listdir(out_dir)):
        ckpt = join(out_dir, name, "checkpoint_best.npz")
        if not os.path.exists(ckpt):
            ckpt = join(out_dir, name, "checkpoint.npz")
        if not os.path.exists(ckpt):
            continue
        _params, _, masks, _, meta = load_checkpoint(ckpt)
        row = dict(meta)
        row["experiment"] = name  # the directory name wins over any meta key
        if masks:
            gaps = []
            for m in masks.values():
                try:
                    gaps.append(calculate_spectral_gap(_np(m))["normalized_gap"])
                except Exception:
                    pass
            if gaps:
                row["mean_normalized_spectral_gap"] = round(float(np.mean(gaps)), 4)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
