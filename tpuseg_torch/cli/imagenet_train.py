"""Vanilla ImageNet classification trainer (counterpart of
``tpuseg/cli/imagenet_train.py``).

Parity with the reference imagenet_train.py (the stock PyTorch example used
to produce dense base models):

- its flags: -a/--arch, -b, --lr, --momentum, --wd, -p/--print-freq,
  -e/--evaluate, --resume, --seed, --epochs, --start-epoch (ref :25-87)
- the LR schedule ``lr * 0.1^(epoch // 30)``, unconditionally
  (``adjust_learning_rate``, ref :436-441)
- a ProgressMeter line every ``--print-freq`` batches with batch time,
  data time, loss, Acc@1 and Acc@5 (ref train() :278-331, validate()
  :333-390)
- best-acc1 checkpoints with a ``checkpoint_best`` copy (ref :113-120)

One device (``--device``, ``cuda`` by default, raising without a card; the
CPU only when asked); the reference's --world-size/--rank/--dist-url have no
counterpart, as in ``tpuseg``.

    python -m tpuseg_torch.cli.imagenet_train --dataset synthetic -a cifar_resnet20 \\
        --epochs 1 -b 64 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from os.path import join


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tpuseg_torch ImageNet training")
    p.add_argument("--data", default=None, help="path to dataset")
    p.add_argument("-a", "--arch", default="drn_d_22")
    p.add_argument("--dataset", default="imagenet",
                   choices=["imagenet", "cifar10", "cifar100", "synthetic"])
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--lr", "--learning-rate", dest="lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", "--weight-decay", dest="weight_decay", type=float, default=1e-4)
    p.add_argument("-p", "--print-freq", type=int, default=10)
    p.add_argument("--resume", default=None)
    p.add_argument("-e", "--evaluate", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-dir", default="runs/imagenet")
    p.add_argument("--dtype", default="float32", choices=["bfloat16", "float32"])
    p.add_argument("--remat", action="store_true",
                   help="recompute each backbone stage group in the backward pass "
                        "(lower peak memory, same arithmetic)")
    p.add_argument("--synthetic-n", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card), cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from tpuseg_torch.cli.rmbsnn import _on, build_model
    from tpuseg_torch.data.classification import SyntheticClassDataset, make_class_datasets
    from tpuseg_torch.data.loaders import batch_iterator, prefetch_to_device
    from tpuseg_torch.device import resolve_device
    from tpuseg_torch.metrics import AverageMeter, ProgressMeter, top_k_accuracy
    from tpuseg_torch.models.factory import num_classes_for_dataset
    from tpuseg_torch.train import (
        classifier_forward,
        create_train_state,
        make_cls_train_step,
        make_sgd,
        save_checkpoint,
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

    start_epoch = args.start_epoch
    best_acc1 = 0.0
    resume_opt = None
    if args.resume:
        from tpuseg_torch.train import load_checkpoint

        p, s, _, resume_opt, meta = load_checkpoint(args.resume)
        params, state = dict(p), dict(s)
        start_epoch = int(meta.get("epoch", start_epoch))
        best_acc1 = float(meta.get("best_acc1", 0.0))
        print(f"=> loaded checkpoint '{args.resume}' (epoch {start_epoch})")

    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    # the stock example's schedule, unconditionally (ref :436-441)
    sched = step30_schedule(args.lr, steps_per_epoch)
    tx = make_sgd(sched, args.momentum, args.weight_decay)
    ts = create_train_state(_on(device, params), _on(device, state), tx, None)
    if resume_opt:
        from tpuseg_torch.train.checkpoint import restore_opt_state

        ts.opt_state = restore_opt_state(ts.opt_state, resume_opt)
        ts.step = start_epoch * steps_per_epoch

    step_fn = make_cls_train_step(spec, tx, compute_dtype=compute_dtype, remat=args.remat)
    fwd = classifier_forward(spec, compute_dtype)
    topk = (1, min(5, classes))

    def validate():
        batch_time = AverageMeter("Time", ":6.3f")
        top1 = AverageMeter("Acc@1", ":6.2f")
        top5 = AverageMeter("Acc@5", ":6.2f")
        n_batches = max(1, len(val_ds) // args.batch_size)
        progress = ProgressMeter(n_batches, [batch_time, top1, top5], prefix="Test: ")
        end = time.time()
        with torch.inference_mode():
            for i, (images, labels) in enumerate(
                    prefetch_to_device(batch_iterator(val_ds, args.batch_size), device)):
                logits = fwd(ts.params, ts.bn_state, images, train=False)[0]
                a1, a5 = top_k_accuracy(logits.float().cpu().numpy(), labels.cpu().numpy(),
                                        topk=topk)
                top1.update(a1, len(labels))
                top5.update(a5, len(labels))
                batch_time.update(time.time() - end)
                end = time.time()
                if i % args.print_freq == 0:
                    progress.display(i)
        print(f" * Acc@1 {top1.avg:.3f} Acc@5 {top5.avg:.3f}")
        return top1.avg, top5.avg

    if args.evaluate:
        return validate()

    os.makedirs(args.save_dir, exist_ok=True)
    line = None
    for epoch in range(start_epoch, args.epochs):
        batch_time = AverageMeter("Time", ":6.3f")
        data_time = AverageMeter("Data", ":6.3f")
        losses = AverageMeter("Loss", ":.4e")
        accs = AverageMeter("Acc@1", ":6.2f")
        progress = ProgressMeter(steps_per_epoch, [batch_time, data_time, losses, accs],
                                 prefix=f"Epoch: [{epoch}]")
        end = time.time()
        for i, (images, labels) in enumerate(prefetch_to_device(
                batch_iterator(train_ds, args.batch_size, shuffle=True, drop_last=True,
                               epoch=epoch), device)):
            data_time.update(time.time() - end)
            ts, m = step_fn(ts, images, labels)
            losses.update(float(m["loss"]), len(labels))
            accs.update(float(m["acc"]) * 100, len(labels))
            batch_time.update(time.time() - end)
            end = time.time()
            if i % args.print_freq == 0:
                progress.display(i)
        acc1, acc5 = validate()
        is_best = acc1 > best_acc1
        best_acc1 = max(best_acc1, acc1)
        save_checkpoint(
            join(args.save_dir, "checkpoint.npz"),
            ts.params, ts.bn_state, opt_state=ts.opt_state, masks=None,
            meta={"epoch": epoch + 1, "arch": args.arch, "best_acc1": best_acc1,
                  "dataset": args.dataset},
            is_best=is_best,
        )
        line = {"epoch": epoch, "acc1": round(acc1, 3), "acc5": round(acc5, 3),
                "best_acc1": round(best_acc1, 3), "lr": float(sched(ts.step))}
        print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
