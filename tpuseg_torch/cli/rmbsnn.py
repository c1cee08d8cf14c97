"""Classification trainer with pruning and knowledge distillation
(counterpart of ``tpuseg/cli/rmbsnn.py``).

Parity with the reference rmbsnn_main.py: base-model load, an optional
teacher and KD (temperature-softened KL mixed with CE, :459-469), the pruner
dispatch (:246-271), static rejig re-init (:360-385), the mask re-applied
after every step (:483-484), top-1/5 validation, checkpoints, step LR decay
(adjust_learning_rate :600-639).  ``--sparse-exec`` runs a DRN arch's
eligible masked convs through kernel B2 in the forward and the dgrad
(``tpuseg_torch.ops.sparse_train``); ``--evaluate --quantize`` adds an int8
copy through kernel B3 (``build_quant_plans`` for DRN archs,
``build_cls_quant_plans`` for the zoo).

One device (``--device``, ``cuda`` by default, raising without a card; the
CPU only when asked).  Checkpoints are ``tpuseg``'s npz, so either package
resumes the other's.  It prints ``tpuseg``'s lines.

    python -m tpuseg_torch.cli.rmbsnn --dataset synthetic -a cifar_resnet20 \\
        --epochs 1 [--evaluate --quantize] [--device cpu]
    python -m tpuseg_torch.cli.rmbsnn --dataset synthetic -a drn_d_22 --epochs 1 \\
        --mc-pruning --pr-static --pr-config-path cfg.json --sparse-exec

More than one device or process (``--mesh-devices`` > 1,
``--num-processes`` > 1) and ``--ckpt-format orbax`` are not ported yet
and raise a ``SystemExit`` naming ROADMAP A21.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from os.path import join

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tpuseg_torch pruned-classifier trainer")
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "cifar100", "mnist", "imagenet", "synthetic"])
    p.add_argument("--data", default=None, help="dataset root dir")
    p.add_argument("-a", "--arch", default="cifar_resnet20")
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", "--weight-decay", dest="weight_decay", type=float, default=1e-4)
    p.add_argument("--base-model", default=None, help="dense weights to start from")
    p.add_argument("--teacher-model", default=None, help="KD teacher checkpoint")
    p.add_argument("--teacher-arch", default=None)
    p.add_argument("--kd-student-wt", type=float, default=0.5)
    p.add_argument("--kd-distill-wt", type=float, default=0.5)
    p.add_argument("--kd-temperature", type=float, default=4.0)
    # pruning (reference flags)
    p.add_argument("--mc-pruning", action="store_true")
    p.add_argument("--pr-config-path", default=None)
    p.add_argument("--pr-static", action="store_true")
    p.add_argument("--rejig", action="store_true")
    p.add_argument("--sparse-exec", action="store_true",
                   help="run the STUDENT's eligible masked convs (stride 1, channels /128, "
                        "union block density < 0.75) through kernel B2 in the forward and "
                        "the dgrad and their wgrad on the support (DRN archs only: "
                        "build_sparse_train_structs walks a DrnSpec); other layers stay "
                        "masked-dense (see semantic_seg --sparse-exec)")
    p.add_argument("--resume", default=None)
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--quantize", action="store_true",
                   help="with --evaluate: also evaluate an int8 PTQ copy (per-layer "
                        "QuantConv plans through kernel B3) and report its top-1/5, wall "
                        "time and prediction agreement with the float path")
    p.add_argument("--save-dir", default="runs/cls")
    p.add_argument("--ckpt-format", default="npz", choices=["npz", "orbax"],
                   help="checkpoint envelope: single-file npz; orbax is not ported yet "
                        "(ROADMAP A21)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="float32", choices=["bfloat16", "float32"])
    p.add_argument("--remat", action="store_true",
                   help="recompute each backbone stage group in the backward pass "
                        "(torch.utils.checkpoint): lower peak memory, same arithmetic")
    p.add_argument("--synthetic-n", type=int, default=256)
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="0 or 1: one device (more is not ported yet, ROADMAP A21)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card), cuda:N or cpu")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    if (args.mesh_devices or 0) > 1 or (args.num_processes or 1) > 1:
        raise SystemExit("--mesh-devices/--num-processes > 1: multi-device training is not "
                         "ported yet (ROADMAP A21)")
    if args.ckpt_format == "orbax":
        raise SystemExit("--ckpt-format orbax: not ported yet (ROADMAP A21)")


def build_model(args, arch, classes):
    """(params, state, spec) from ``--seed``: a CIFAR-zoo model or a DRN
    classifier (classifier naming), ``tpuseg``'s weights."""
    from tpuseg_torch.models.cifar import CIFAR_ARCHS, create_cifar_model
    from tpuseg_torch.models.drn import DRN_ARCHS, build_drn_spec, init_drn

    if arch in CIFAR_ARCHS:
        return create_cifar_model(args.seed, arch, classes)
    if arch in DRN_ARCHS:
        spec = build_drn_spec(arch, num_classes=classes, naming="cls")
        params, state = init_drn(args.seed, spec)
        return params, state, spec
    raise ValueError(f"unknown arch {arch!r}")


def load_into(params, state, path):
    """Weights of a ``.pth`` (``torch_import.load_pth``) or an npz
    checkpoint of either package, over ``params``/``state``."""
    if path.endswith(".pth"):
        from tpuseg_torch.models.torch_import import load_pth

        p, s, _ = load_pth(path)
    else:
        from tpuseg_torch.train import load_checkpoint

        p, s, _, _, _ = load_checkpoint(path)
    params.update(p)
    state.update(s)


def _on(device, tensors) -> dict:
    return {k: v.to(device) for k, v in tensors.items()}


def main(argv=None):
    args = parse_args(argv)
    _refuse_unported(args)
    import torch

    from tpuseg_torch.data.classification import SyntheticClassDataset, make_class_datasets
    from tpuseg_torch.data.loaders import batch_iterator, prefetch_to_device
    from tpuseg_torch.device import resolve_device
    from tpuseg_torch.metrics import AverageMeter, top_k_accuracy
    from tpuseg_torch.models.cifar import CifarSpec, cifar_forward
    from tpuseg_torch.models.factory import num_classes_for_dataset
    from tpuseg_torch.sparsity import create_masker
    from tpuseg_torch.sparsity.base import mask_sparsity_stats
    from tpuseg_torch.train import (
        classifier_forward,
        create_train_state,
        make_cls_train_step,
        make_sgd,
        milestones_for_epochs,
        multistep_schedule,
        save_checkpoint,
        sparsity_aware_reinit,
    )
    from tpuseg_torch.train.optim import step30_schedule

    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    if args.dataset == "synthetic":
        classes = 10
        train_ds = SyntheticClassDataset(args.synthetic_n, 32, 3, classes, args.seed)
        val_ds = train_ds
    else:
        classes = num_classes_for_dataset(args.dataset)
        train_ds, val_ds = make_class_datasets(args.dataset, args.data, args.seed)

    params, state, spec = build_model(args, args.arch, classes)
    if args.base_model:
        load_into(params, state, args.base_model)

    teacher = None
    if args.teacher_model:
        t_params, t_state, t_spec = build_model(args, args.teacher_arch or args.arch, classes)
        load_into(t_params, t_state, args.teacher_model)
        t_fwd_full = classifier_forward(t_spec, compute_dtype)
        teacher = (lambda p, s, x: t_fwd_full(p, s, x, train=False)[0],
                   _on(device, t_params), _on(device, t_state))

    masks = None
    if args.mc_pruning and args.pr_config_path:
        masker = create_masker(args.pr_config_path, seed=args.seed)
        masks = masker.generate_masks(params, is_static=args.pr_static, verbose=True)
        for layer, sp in mask_sparsity_stats(masks).items():
            print(layer, f"sparsity = {sp}")
        if args.rejig and args.pr_static:
            params = sparsity_aware_reinit(params, masks, np.random.default_rng(args.seed))

    start_epoch = 0
    best_acc1 = 0.0
    resume_opt = None
    if args.resume:
        from tpuseg_torch.train import load_checkpoint

        p, s, m, resume_opt, meta = load_checkpoint(args.resume)
        params, state = dict(p), dict(s)
        if m:
            masks = m
        start_epoch = int(meta.get("epoch", 0))
        best_acc1 = float(meta.get("best_acc1", 0.0))
        print(f"=> resumed '{args.resume}' (epoch {start_epoch})")

    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    if args.dataset == "imagenet" and args.epochs == 100:
        sched = step30_schedule(args.lr, steps_per_epoch)
    else:
        sched = multistep_schedule(args.lr, milestones_for_epochs(args.epochs), 0.1,
                                   steps_per_epoch)
    tx = make_sgd(sched, args.momentum, args.weight_decay)
    ts = create_train_state(_on(device, params), _on(device, state), tx,
                            None if masks is None else _on(device, masks))
    if resume_opt:
        from tpuseg_torch.train.checkpoint import restore_opt_state

        ts.opt_state = restore_opt_state(ts.opt_state, resume_opt)
        ts.step = start_epoch * steps_per_epoch

    sparse_plans = None
    if args.sparse_exec:
        if isinstance(spec, CifarSpec):
            raise SystemExit("--sparse-exec requires a DRN arch: build_sparse_train_structs "
                             "walks only a DrnSpec's stages")
        if masks is None:
            raise SystemExit("--sparse-exec requires masks (--mc-pruning --pr-config-path "
                             "... or a resumed checkpoint with masks)")
        from tpuseg_torch.ops.sparse_train import build_sparse_train_structs

        structs, sparse_report = build_sparse_train_structs(masks, spec)
        print(json.dumps({"sparse_exec": sparse_report}))
        if structs:
            sparse_plans = {k: st.to(device) for k, st in structs.items()}
        else:
            print("warning: --sparse-exec found no eligible layer; running masked-dense")
    step_fn = make_cls_train_step(
        spec, tx, compute_dtype=compute_dtype, teacher=teacher,
        kd_student_wt=args.kd_student_wt, kd_distill_wt=args.kd_distill_wt,
        kd_temperature=args.kd_temperature, remat=args.remat, sparse_plans=sparse_plans,
    )
    fwd = classifier_forward(spec, compute_dtype)
    topk = (1, min(5, classes))

    def collect_logits(forward):
        logits_all, labels_all = [], []
        with torch.inference_mode():
            for images, labels in prefetch_to_device(
                    batch_iterator(val_ds, args.batch_size), device):
                logits_all.append(forward(ts.params, ts.bn_state, images).float().cpu().numpy())
                labels_all.append(labels.cpu().numpy())
        return np.concatenate(logits_all), np.concatenate(labels_all)

    def eval_fwd(p, s, x):
        return fwd(p, s, x, train=False)[0]

    if args.evaluate:
        t0 = time.time()
        logits, labels = collect_logits(eval_fwd)
        t_fp = time.time() - t0
        top1, top5 = top_k_accuracy(logits, labels, topk=topk)
        out = {"acc1": round(top1, 3), "acc5": round(top5, 3), "seconds": round(t_fp, 3)}
        if args.quantize:
            # the int8 PTQ copy through the per-layer plan dispatch the seg
            # pipeline uses (the reference's eval: rmbsnn_main.py:502-549)
            from tpuseg_torch.models.drn import drn_forward
            from tpuseg_torch.ops.quant import build_cls_quant_plans, build_quant_plans

            host_params = {k: v.detach().cpu() for k, v in ts.params.items()}
            if isinstance(spec, CifarSpec):
                plans = build_cls_quant_plans(host_params, groups=spec.groups)
            else:
                plans = build_quant_plans(host_params, spec)
            plans = {k: v.to(device) for k, v in plans.items()}

            def q_fwd(p, s, x):
                if isinstance(spec, CifarSpec):
                    return cifar_forward(p, s, x, spec, compute_dtype=compute_dtype,
                                         plans=plans)[0]
                return drn_forward(p, s, x, spec, compute_dtype=compute_dtype,
                                   sparse_plans=plans)[0]

            t0 = time.time()
            q_logits, _ = collect_logits(q_fwd)
            t_q = time.time() - t0
            q1, q5 = top_k_accuracy(q_logits, labels, topk=topk)
            out.update({
                "int8_acc1": round(q1, 3), "int8_acc5": round(q5, 3),
                "int8_seconds": round(t_q, 3),
                "int8_layers": len(plans),
                "pred_agreement": round(float(
                    (q_logits.argmax(-1) == logits.argmax(-1)).mean()), 4),
            })
        print(json.dumps(out))
        return out

    os.makedirs(args.save_dir, exist_ok=True)
    line = None
    for epoch in range(start_epoch, args.epochs):
        losses = AverageMeter("loss")
        accs = AverageMeter("acc")
        t0 = time.time()
        for images, labels in prefetch_to_device(
                batch_iterator(train_ds, args.batch_size, shuffle=True, drop_last=True,
                               epoch=epoch), device):
            ts, m = step_fn(ts, images, labels)
            losses.update(float(m["loss"]), len(labels))
            accs.update(float(m["acc"]) * 100, len(labels))
        logits, labels = collect_logits(eval_fwd)
        top1, top5 = top_k_accuracy(logits, labels, topk=topk)
        is_best = top1 > best_acc1
        best_acc1 = max(best_acc1, top1)
        save_checkpoint(
            join(args.save_dir, "checkpoint.npz"),
            ts.params, ts.bn_state, opt_state=ts.opt_state, masks=ts.masks,
            meta={"epoch": epoch + 1, "arch": args.arch, "best_acc1": best_acc1,
                  "dataset": args.dataset},
            is_best=is_best,
        )
        line = {"epoch": epoch, "train_loss": round(losses.avg, 4),
                "train_acc": round(accs.avg, 3), "acc1": round(top1, 3),
                "acc5": round(top5, 3), "seconds": round(time.time() - t0, 2)}
        print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
