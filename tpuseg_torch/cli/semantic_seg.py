"""Cityscapes segmentation trainer CLI (counterpart of
``tpuseg/cli/semantic_seg.py``).

Parity with the reference semantic_seg.py (cmd in {train, test, calc},
parse_args at :675-761, main at :775-1119):

- train: DRNSeg + optional pruner (JSON config via --pr-config-path),
  SGD+momentum with MultiStepLR, per-epoch val mIoU, checkpoint/best-copy,
  static-mask "rejig" re-init, per-epoch mask sparsity stats;
  ``--sparse-exec`` runs the eligible masked convs' forward and dgrad
  through kernel B2 and their wgrad on the support
  (``tpuseg_torch.ops.sparse_train``)
- test: mIoU evaluation over the val list (+ optional multi-scale --ms),
  prediction / colorized dumps
- calc: parameter + FLOP count (``torch.utils.flop_counter``)

``--device`` (``cuda`` by default; ``cpu`` only when asked), a producer
thread that prefetches batches to it, npz checkpoints in ``tpuseg``'s
layout (either package resumes the other's) or the directory envelope
(``--ckpt-format orbax``, written with ``torch.distributed.checkpoint``),
masks checkpointed.  It prints ``tpuseg``'s lines.

Data-parallel training, one rank a device (``tpuseg_torch.parallel``):
``--mesh-devices N`` starts the largest divisor of the batch among
min(N, visible cards) local ranks (N gloo ranks with ``--device cpu``), each
training on its contiguous part of every global batch;
``--num-processes P --coordinator host:port --process-id i`` joins P
processes, each feeding batch ÷ P samples of its own shard
(``--num-shards``/``--shard-index``).  Either way the step is the
one-device step over the global batch (global BN statistics, the loss over
the global count, summed gradients), eval merges the confusion matrices,
rank 0 writes the npz, and every rank writes the directory envelope.

    python -m tpuseg_torch.cli.semantic_seg train --synthetic 64 -s 512 \\
        --batch-size 8 --epochs 1 [--mc-pruning --pr-static \\
        --pr-config-path optimal_configs/drn_d_22/drn_d_22_block128reg_87.50.json \\
        --sparse-exec]
    python -m tpuseg_torch.cli.semantic_seg train --device cpu --synthetic 4 \\
        -s 64 --batch-size 2 --epochs 1 --dtype float32

``--pretrained`` takes a reference ``.pth`` or an npz checkpoint;
``--pretrained-backbone`` fills the backbone from an ImageNet DRN
classifier ``.pth`` (a local path, an http(s) URL resolved through the
cache, or ``auto``: the arch's published URL).  ``--profile-dir DIR``
writes a ``torch.profiler`` trace of the first trained epoch
(``tpuseg_torch.metrics.profiling.trace``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from os.path import join

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tpuseg_torch semantic segmentation")
    p.add_argument("cmd", choices=["train", "test", "calc"])
    p.add_argument("-d", "--data-dir", default=None)
    p.add_argument("-l", "--list-dir", default=None,
                   help="list dir with {phase}_images.txt (defaults to data-dir)")
    p.add_argument("-c", "--classes", type=int, default=19)
    p.add_argument("-s", "--crop-size", type=int, default=0)
    p.add_argument("--arch", default="drn_d_22")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--lr-mode", default="step", choices=["step", "poly"])
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--random-scale", type=float, default=0)
    p.add_argument("--random-rotate", type=int, default=0)
    p.add_argument("--pretrained", default=None,
                   help=".pth or .npz weights (an npz checkpoint of either package)")
    p.add_argument("--pretrained-backbone", default=None,
                   help="ImageNet-pretrained DRN classifier to bootstrap the backbone "
                        "from (seg head stays at init): a local .pth, an http(s) URL "
                        "(cached) or 'auto' (the arch's published checkpoint) - the "
                        "reference's pretrained=True contract (drn.py:15-24)")
    p.add_argument("--resume", default=None, help="checkpoint to resume from")
    p.add_argument("--save-dir", default="runs/seg")
    p.add_argument("--ckpt-format", default="npz", choices=["npz", "orbax"],
                   help="checkpoint envelope: single-file npz (atomic tmp+rename) or the "
                        "directory envelope (torch.distributed.checkpoint: async save, "
                        "every rank writes)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (Chrome JSON) of the first trained "
                        "epoch into this directory")
    p.add_argument("--ms", action="store_true", help="multi-scale test")
    p.add_argument("--scales", default="0.5,0.75,1.25,1.5,1.75")
    p.add_argument("--save-vis", action="store_true",
                   help="dump class-id and colorized prediction PNGs")
    # pruning (reference flags: --mc_pruning, --pr_config_path, --pr_static)
    p.add_argument("--mc-pruning", action="store_true")
    p.add_argument("--pr-config-path", default=None)
    p.add_argument("--pr-static", action="store_true")
    p.add_argument("--rejig", action="store_true",
                   help="sparsity-aware reinit for static masks")
    p.add_argument("--sparse-exec", action="store_true",
                   help="run eligible masked convs (stride 1, channels /128, union block "
                        "density < 0.75) through the block-sparse kernel B2 in the forward "
                        "and the dgrad and their wgrad on the support, instead of "
                        "masked-dense; other layers stay masked-dense and eval keeps the "
                        "(equivalent) dense-masked forward")
    p.add_argument("--unstructured-sparsity", type=float, default=0.0,
                   help="semseg_unstructured-style L1 magnitude pruning")
    p.add_argument("--random-unstructured", type=float, default=0.0,
                   help="semseg_baseline-style random unstructured pruning "
                        "(ref semseg_baseline.py:752)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--remat", action="store_true",
                   help="recompute each backbone stage in the backward pass "
                        "(torch.utils.checkpoint): lower peak memory, same arithmetic")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="cap the data-parallel ranks at N local devices, one rank a "
                        "device (0 = all visible cards whose count divides the batch; "
                        "1 = single-device; with --device cpu, N gloo ranks; train only: "
                        "test and calc run on one device)")
    p.add_argument("--num-shards", type=int, default=1, help="hosts")
    p.add_argument("--shard-index", type=int, default=0)
    # multi-process init (replaces --world-size/--rank/--dist-url/--dist-backend,
    # semantic_seg.py:728-744)
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port for multi-process runs")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic samples instead of a dataset (smoke tests)")
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card), cuda:N or cpu")
    return p.parse_args(argv)


class SyntheticSegDataset:
    """Random (image, label) pairs for smoke tests on machines without
    Cityscapes (``tpuseg``'s draws, sample for sample)."""

    def __init__(self, n, size, classes, seed=0):
        self.n, self.size, self.classes, self.seed = n, size, classes, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed * 100003 + i)
        h = w = self.size
        img = rng.random((h, w, 3), dtype=np.float32)
        lbl = rng.integers(0, self.classes, size=(h, w)).astype(np.int32)
        lbl[rng.random((h, w)) < 0.05] = 255
        return img, lbl


def build_dataset(args, phase, out_name=False):
    if args.synthetic:
        size = args.crop_size or 64
        return SyntheticSegDataset(args.synthetic, size, args.classes, args.seed)
    from tpuseg_torch.data import transforms as T
    from tpuseg_torch.data.cityscapes import SegList, load_info

    info = load_info(args.data_dir)
    rng = np.random.default_rng(args.seed)
    if phase == "train":
        ts = []
        if args.random_rotate > 0:
            ts.append(T.RandomRotate(args.random_rotate, rng))
        if args.random_scale > 0:
            ts.append(T.RandomScale(args.random_scale, rng))
        ts.extend([
            T.RandomCrop(args.crop_size, rng),
            T.RandomHorizontalFlip(rng),
            T.ToArray(),
            T.Normalize(info["mean"], info["std"]),
        ])
    else:
        ts = [T.ToArray(), T.Normalize(info["mean"], info["std"])]
    return SegList(args.data_dir, phase, T.Compose(ts), list_dir=args.list_dir,
                   out_name=out_name)


def load_weights(args, classes):
    """Weights from the seed, then ``--pretrained-backbone``'s backbone and
    ``--pretrained``'s weights (``.pth`` or npz) over them (CPU tensors,
    OIHW)."""
    from tpuseg_torch.models.drnseg import init_drnseg

    params, state, spec = init_drnseg(args.seed, args.arch, classes)
    if args.pretrained_backbone:
        from tpuseg_torch.models.torch_import import load_pretrained_backbone

        params, state, n = load_pretrained_backbone(args.arch, args.pretrained_backbone,
                                                    params, state)
        print(json.dumps({"pretrained_backbone": args.pretrained_backbone, "tensors": n}))
    if args.pretrained:
        if args.pretrained.endswith(".pth"):
            from tpuseg_torch.models.torch_import import load_pth

            p, s, _ = load_pth(args.pretrained)
        else:
            from tpuseg_torch.train.checkpoint import load_checkpoint

            p, s, _, _, _ = load_checkpoint(args.pretrained)
        params.update(p)
        state.update(s)
    return params, state, spec


def make_masker(args, params):
    """Pruner dispatch (semantic_seg.py:830-849)."""
    masks = None
    masker = None
    if args.mc_pruning and args.pr_config_path:
        from tpuseg_torch.sparsity import create_masker

        masker = create_masker(args.pr_config_path, seed=args.seed)
        masks = masker.generate_masks(params, is_static=args.pr_static, verbose=True)
    elif args.unstructured_sparsity > 0:
        from tpuseg_torch.train.unstructured import magnitude_unstructured_masks

        masks = magnitude_unstructured_masks(params, args.unstructured_sparsity)
    elif args.random_unstructured > 0:
        from tpuseg_torch.train.unstructured import random_unstructured_masks

        masks = random_unstructured_masks(
            params, args.random_unstructured, np.random.default_rng(args.seed)
        )
    return masker, masks


def _on(device, tensors) -> dict:
    return {k: v.to(device) for k, v in tensors.items()}


def cmd_train(args):
    import torch

    from tpuseg_torch.data.loaders import batch_iterator, prefetch_to_device
    from tpuseg_torch.device import resolve_device
    from tpuseg_torch.metrics import AverageMeter, fast_hist, miou_from_hist
    from tpuseg_torch.parallel import setup_data_parallel, shard_batch, shard_train_step
    from tpuseg_torch.parallel.mesh import sum_over_ranks
    from tpuseg_torch.sparsity.base import mask_sparsity_stats
    from tpuseg_torch.train import (
        create_train_state,
        make_eval_step,
        make_seg_train_step,
        make_sgd,
        milestones_for_epochs,
        multistep_schedule,
        poly_schedule,
        save_checkpoint,
        sparsity_aware_reinit,
    )

    # the data-parallel mesh of this rank: one device a rank, the batch
    # global (the reference's DataParallel, semantic_seg.py:809-815, or DDP
    # with per-GPU batch division, semantic_seg_multigpu.py:460-526)
    mesh, local_bs = setup_data_parallel(args.batch_size, args.mesh_devices,
                                         resolve_device(args.device))
    device = resolve_device(mesh.device)
    is_main = mesh.is_main
    ranked = mesh.rank is not None
    if is_main and ranked:
        print(json.dumps({
            "mesh": {"data": mesh.size, "processes": mesh.size, "local_batch": local_bs,
                     "global_batch": args.batch_size},
        }))
    compute_dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    params, state, spec = load_weights(args, args.classes)
    masker, masks = make_masker(args, params)
    if masks is not None and is_main:
        print("mask sparsity:", json.dumps(
            {k: round(v, 2) for k, v in mask_sparsity_stats(masks).items()}
        ))
    if masks is not None and args.unstructured_sparsity > 0:
        # global-sparsity report during unstructured training
        # (ref semseg_unstructured.py:780-787)
        from tpuseg_torch.cli.semseg_unstructured import report_global_sparsity

        report_global_sparsity(params, masks)
    if args.rejig and masks is not None and args.pr_static:
        params = sparsity_aware_reinit(params, masks, np.random.default_rng(args.seed))

    train_ds = build_dataset(args, "train")
    val_ds = build_dataset(args, "val") if not args.synthetic else train_ds
    steps_per_epoch = max(1, len(train_ds) // args.batch_size)

    start_epoch = 0
    meta_resume = {}
    opt_arrays = None
    if args.resume:
        from tpuseg_torch.train.checkpoint import load_checkpoint

        p, s, m, opt_arrays, meta_resume = load_checkpoint(args.resume)
        params, state = p, s
        if m:
            masks = m
        start_epoch = int(meta_resume.get("epoch", 0))

    if args.lr_mode == "poly":
        sched = poly_schedule(args.lr, args.epochs * steps_per_epoch)
    else:
        milestones = milestones_for_epochs(args.epochs, start_epoch)
        sched = multistep_schedule(args.lr, milestones, 0.1, steps_per_epoch)
    tx = make_sgd(sched, args.momentum, args.weight_decay)
    ts = create_train_state(_on(device, params), _on(device, state), tx,
                            None if masks is None else _on(device, masks))
    if opt_arrays is not None:
        from tpuseg_torch.train.checkpoint import restore_opt_state

        ts.opt_state = restore_opt_state(ts.opt_state, opt_arrays)
        ts.step = start_epoch * steps_per_epoch

    sparse_plans = None
    if args.sparse_exec:
        # plan from the FINAL masks (post-resume)
        if masks is None:
            raise SystemExit(
                "--sparse-exec requires masks (--mc-pruning "
                "--pr-config-path ..., --unstructured-sparsity, or a "
                "resumed checkpoint with masks)"
            )
        from tpuseg_torch.ops.sparse_train import build_sparse_train_structs

        structs, sparse_report = build_sparse_train_structs(masks, spec)
        if is_main:
            print(json.dumps({"sparse_exec": sparse_report}))
        if structs:
            sparse_plans = {k: st.to(device) for k, st in structs.items()}
        elif is_main:
            print("warning: --sparse-exec found no eligible layer; running masked-dense")
    step_fn = shard_train_step(
        make_seg_train_step(spec, tx, compute_dtype=compute_dtype, remat=args.remat,
                            sparse_plans=sparse_plans), mesh)
    eval_fn = make_eval_step(spec, "seg", compute_dtype=compute_dtype)

    os.makedirs(args.save_dir, exist_ok=True)
    # persistent run logging: JSONL + TensorBoard event files with a
    # hyperparameter-carrying run record (ref semantic_seg.py:1010-1024)
    from tpuseg_torch.metrics.profiling import trace
    from tpuseg_torch.metrics.runlog import RunLogger

    runlog = RunLogger(
        args.save_dir, run_name="",
        hparams={"arch": args.arch, "lr": args.lr, "lr_mode": args.lr_mode,
                 "batch_size": args.batch_size, "epochs": args.epochs,
                 "crop_size": args.crop_size,
                 "pr_config": args.pr_config_path or "",
                 "unstructured": args.unstructured_sparsity},
    ) if is_main else None
    best_miou = float(meta_resume.get("best_miou", 0.0))
    # every rank evaluates its shard of the val set; the confusion
    # matrices are summed over the ranks
    val_shards = (mesh.size, mesh.rank) if ranked else (args.num_shards, args.shard_index)

    try:
        for epoch in range(start_epoch, args.epochs):
            losses = AverageMeter("loss")
            t_epoch = time.time()
            if args.num_shards > 1:
                # one process per host: each feeds its own shard of local batches
                it = batch_iterator(train_ds, local_bs, shuffle=True, drop_last=True,
                                    epoch=epoch, num_shards=args.num_shards,
                                    shard_index=args.shard_index)
            else:
                # local ranks: each trains on its contiguous part of every
                # global batch, as a one-process mesh shards it
                it = (shard_batch(mesh, b) for b in batch_iterator(
                    train_ds, args.batch_size, shuffle=True, drop_last=True, epoch=epoch))
            # a device trace of the first trained epoch, when asked
            with trace(args.profile_dir if epoch == start_epoch and is_main else None):
                for images, labels in prefetch_to_device(it, device):
                    ts, m = step_fn(ts, images, labels)
                    losses.update(float(m["loss"]), len(images))
            line = {
                "epoch": epoch,
                "train_loss": round(losses.avg, 4),
                "epoch_seconds": round(time.time() - t_epoch, 2),
                "lr": float(sched(ts.step)),
            }

            is_best = False
            if (epoch + 1) % args.eval_every == 0:
                hist = np.zeros((args.classes, args.classes), dtype=np.int64)
                for images, labels in prefetch_to_device(
                        batch_iterator(val_ds, local_bs, num_shards=val_shards[0],
                                       shard_index=val_shards[1]), device):
                    _, preds = eval_fn(ts.params, ts.bn_state, images, labels)
                    hist += fast_hist(preds.cpu().numpy().flatten(),
                                      labels.cpu().numpy().flatten(), args.classes)
                hist = sum_over_ranks(mesh, hist)  # one int64 all-reduce
                miou = miou_from_hist(hist)
                line["val_miou"] = round(miou, 3)
                # reference baseline's independent pixel-accuracy report
                # (semseg_baseline.py:120-131); derived from the same hist
                total = hist.sum()
                if total:
                    line["val_pixel_acc"] = round(
                        float(np.diag(hist).sum() / total) * 100, 2
                    )
                is_best = miou > best_miou
                best_miou = max(best_miou, miou)
            # checkpoint EVERY epoch (the reference saves per-epoch too,
            # semantic_seg.py:1085-1092); writes are atomic.  npz: rank 0
            # writes the file (the replicas are identical); the directory
            # envelope: EVERY rank calls save (its plan and commit are
            # collective), asynchronously, so the next epoch trains while
            # this one commits
            if is_main or args.ckpt_format == "orbax":
                save_checkpoint(
                    join(args.save_dir, "checkpoint." + args.ckpt_format),
                    ts.params, ts.bn_state,
                    opt_state=ts.opt_state, masks=ts.masks,
                    meta={"epoch": epoch + 1, "arch": args.arch,
                          "best_miou": best_miou, "dataset": "cityscapes"},
                    is_best=is_best,
                    async_save=args.ckpt_format == "orbax",
                )
            if ranked and os.environ.get("TPUSEG_SAVE_ALL_PROCS"):
                # the lockstep test's hook: every rank dumps its replica
                save_checkpoint(
                    join(args.save_dir, f"replica_proc{mesh.rank}.npz"),
                    ts.params, ts.bn_state,
                    meta={"epoch": epoch + 1, "process": mesh.rank},
                )
            if masks is not None:
                # per-epoch pruner stats (pruner.print_stats each epoch,
                # semantic_seg.py:1094-1095) — measured on the live weights
                weight_sparsity = {
                    k: round(int((ts.params[k] == 0).sum()) / ts.params[k].numel() * 100, 2)
                    for k in masks
                }
                line["mean_weight_sparsity"] = round(
                    float(np.mean(list(weight_sparsity.values()))), 2
                )
            if is_main:
                print(json.dumps(line))
                runlog.log(epoch, line)
    finally:
        if runlog is not None:
            runlog.close()
    if args.ckpt_format == "orbax":
        from tpuseg_torch.train.orbax_ckpt import wait_for_saves

        wait_for_saves()  # never exit with an uncommitted async save
    return best_miou


def _save_predictions(preds, names, out_dir, palette=None):
    """save_output_images / save_colorful_images parity
    (semantic_seg.py:85-112)."""
    from PIL import Image

    for pred, name in zip(preds, names):
        fn = os.path.join(out_dir, str(name)[:-4] + ".png")
        os.makedirs(os.path.dirname(fn) or ".", exist_ok=True)
        arr = pred.astype(np.uint8)
        if palette is not None:
            arr = palette[arr]
        Image.fromarray(arr).save(fn)


def cmd_test(args):
    import torch
    import torch.nn.functional as F

    from tpuseg_torch.data.cityscapes import CITYSCAPE_PALETTE
    from tpuseg_torch.data.loaders import batch_iterator, prefetch_to_device
    from tpuseg_torch.device import resolve_device
    from tpuseg_torch.metrics import fast_hist, miou_from_hist, per_class_iu
    from tpuseg_torch.models.drnseg import drnseg_forward
    from tpuseg_torch.sparsity import apply_masks
    from tpuseg_torch.train import make_eval_step

    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    params, state, spec = load_weights(args, args.classes)
    _, masks = make_masker(args, params)
    if masks is not None:
        params = apply_masks(params, masks)
    params, state = _on(device, params), _on(device, state)

    hist = np.zeros((args.classes, args.classes), dtype=np.int64)

    if args.ms:
        # multi-scale evaluation (test_ms, semantic_seg.py:507-557): forward
        # at the base scale + each extra scale, bilinear-resize the
        # log-probs back (on the device, antialiased as jax.image.resize),
        # sum, argmax
        from tpuseg_torch.data import transforms as T
        from tpuseg_torch.data.cityscapes import SegListMS, load_info

        scales = [float(s) for s in args.scales.split(",")]
        info = load_info(args.data_dir)
        tfm = T.Compose([T.ToArray(), T.Normalize(info["mean"], info["std"])])
        ds = SegListMS(args.data_dir, "val", tfm, scales, list_dir=args.list_dir)
        with torch.inference_mode():
            for idx in range(len(ds)):
                item = ds[idx]
                image, label, name, ms_images = item[0], item[1], item[-2], item[-1]
                h, w = image.shape[:2]
                total = torch.zeros((args.classes, h, w), dtype=torch.float32, device=device)
                for im in [image] + list(ms_images):
                    x = torch.from_numpy(np.ascontiguousarray(im))[None].to(device)
                    out = drnseg_forward(params, state, x, spec, train=False,
                                         compute_dtype=compute_dtype)[0]
                    total += F.interpolate(out.permute(0, 3, 1, 2).float(), size=(h, w),
                                           mode="bilinear", align_corners=False,
                                           antialias=True)[0]
                pred = total.argmax(dim=0).cpu().numpy()
                if args.save_vis:
                    out_dir = join(args.save_dir, "pred")
                    _save_predictions([pred], [name], out_dir)
                    _save_predictions([pred], [name], out_dir + "_color", CITYSCAPE_PALETTE)
                hist += fast_hist(pred.flatten(), np.asarray(label).flatten(), args.classes)
    else:
        # --save-vis needs the image names in the batch (the reference's
        # test-time SegList is built with out_name=True, semantic_seg.py:588)
        val_ds = build_dataset(args, "val" if not args.synthetic else "train",
                               out_name=args.save_vis)
        eval_fn = make_eval_step(spec, "seg", compute_dtype=compute_dtype)
        for batch in prefetch_to_device(batch_iterator(val_ds, args.batch_size), device):
            images, labels = batch[0], batch[1]
            _, preds = eval_fn(params, state, images, labels)
            preds = preds.cpu().numpy()
            if args.save_vis and len(batch) > 2:
                out_dir = join(args.save_dir, "pred")
                _save_predictions(preds, batch[2], out_dir)
                _save_predictions(preds, batch[2], out_dir + "_color", CITYSCAPE_PALETTE)
            hist += fast_hist(preds.flatten(), labels.cpu().numpy().flatten(), args.classes)
    ious = per_class_iu(hist) * 100
    miou = miou_from_hist(hist)
    print(" ".join(f"{i:.2f}" for i in ious))
    print(json.dumps({"miou": round(miou, 3)}))
    return miou


def cmd_calc(args):
    """Parameter / FLOP count (parity with pthflops + torchsummary usage,
    semantic_seg.py:819,1116-1119): FLOPs of one eval forward at
    ``--crop-size`` (512 by default) from ``torch.utils.flop_counter``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from tpuseg_torch.device import resolve_device
    from tpuseg_torch.models.drnseg import drnseg_forward

    device = resolve_device(args.device)
    params, state, spec = load_weights(args, args.classes)
    n_params = sum(int(v.numel()) for v in params.values())
    size = args.crop_size or 512
    x = torch.zeros((1, size, size, 3), device=device)
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        drnseg_forward(_on(device, params), _on(device, state), x, spec, train=False)
    print(json.dumps({"params": n_params, "flops": float(counter.get_total_flops()),
                      "input": f"{size}x{size}"}))


def _run(args):
    if args.cmd == "train":
        return cmd_train(args)
    if args.cmd == "test":
        return cmd_test(args)
    return cmd_calc(args)


def main(argv=None):
    args = parse_args(argv)
    from tpuseg_torch.parallel.mesh import launch

    if args.num_processes and args.num_processes > 1:
        # tpuseg's hosts: each process feeds its own shard
        args.num_shards, args.shard_index = args.num_processes, args.process_id or 0
    elif args.cmd != "train" and (args.mesh_devices or 0) > 1:
        # tpuseg's test and calc build no mesh either: say so, do not run
        # one rank in silence
        print(f"note: --mesh-devices applies to train; {args.cmd} runs on one device",
              file=sys.stderr)
    return launch(_run, args, args.batch_size, spawn=args.cmd == "train",
                  requires=" (one process per device, torch.distributed semantics)")


if __name__ == "__main__":
    main()
