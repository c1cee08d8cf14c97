"""Trained-weights fidelity report: every approximate serving mode and the
pruning-recovery loop, measured on converged weights (the port's
counterpart of ``tpuseg/tools/trained_fidelity.py``: the same flags, seeds,
stages, checkpoints, report rows and printed lines, plus ``--device``).

It converges DRN-D-22 on the shapes world (``tpuseg_torch.data.shapes``,
which knows its own labels), then serves every mode on the trained weights
and scores each against the labels: ground-truth (GT) mIoU per mode beside
its ids agreement with the exact run.

Stages (each replaces its (stage, arch) row of ``<out>/report.json``;
partial fidelity runs merge into the mode matrix):

- ``train``    converge DRN-D-22 on fresh shapes scenes (early stop at
               ``--target-miou``); saves ``<out>/<arch>_shapes.npz``
- ``fidelity`` the serving-mode matrix (exact, yuv420, int8 dynamic /
               calibrated / stem, temporal 2 and 4 with and without
               nearest reuse, budgeted with nearest or int8, and the four
               warp modes when the frames are multiples of 128 a side) on a
               moving-shapes video
- ``compress`` dense vs RBGP 50 %, magnitude-unstructured 50 % and the
               vendored block128 / block128reg 87.5 % geometries: mIoU at
               mask time and a masked retrain recovery curve
               (``--sparse-exec``: recovery through the fused sparse train
               step, kernel B2 in the forward and the dgrad)
- ``compose``  recover block128reg 87.5 % (cached at
               ``<out>/<arch>_shapes_block128reg.npz``), serve it through
               gathered-exact sparse plans composed with int8 and budgeted
               temporal reuse, beside the dense trained baseline
- ``budget_curve`` (not part of ``all``) GT mIoU against the refresh
               budget K of budgeted temporal reuse, at each drift speed

- ``cls``      the rmbsnn pruning-recovery loop on a classification proxy:
               a cifar_resnet20 teacher, RBGP 50 % masks, retrained plain
               and with knowledge distillation

``--stage all`` runs train, fidelity, compress, compose and cls.

One device (``--device``, ``cuda`` by default, raising without a card; the
CPU only when asked).  The int8 modes run on the card; on the CPU they are
dropped unless ``--modes`` names them, as ``tpuseg`` drops them on its CPU
backend.  Everything computes in bf16, as in ``tpuseg``.

    python -m tpuseg_torch.tools.trained_fidelity --stage all --out runs/fidelity
    python -m tpuseg_torch.tools.trained_fidelity --device cpu --stage train \\
        --out runs/fid_cpu --train-size 32 --batch 2 --steps 2 --eval-every 2
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from tpuseg_torch.data import shapes

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _append_report(out: str, entry: dict) -> None:
    path = os.path.join(out, "report.json")
    rows = []
    if os.path.exists(path):
        with open(path) as fh:
            rows = json.load(fh)

    # rows are keyed by (stage, arch): multi-arch sweeps into one out dir
    # must not clobber each other's entries
    def same(r):
        return r.get("stage") == entry.get("stage") and r.get("arch") == entry.get("arch")

    prev = next((r for r in rows if same(r)), None)
    if prev and isinstance(prev.get("modes"), dict) and "modes" in entry:
        # partial fidelity runs (--modes, the CPU's int8 gate) merge into the
        # existing mode matrix
        entry = {**prev, **entry, "modes": {**prev["modes"], **entry["modes"]}}
    rows = [r for r in rows if not same(r)]
    rows.append(entry)
    os.makedirs(out, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(rows, fh, indent=2)
        fh.write("\n")
    os.replace(tmp, path)
    print(json.dumps(entry))


def _shapes_stats() -> tuple[np.ndarray, np.ndarray]:
    mean = shapes.CLASS_COLORS.mean(0) / 255.0
    std = np.array([0.25, 0.25, 0.25], np.float32)
    return mean.astype(np.float32), std


def _normalize(imgs_u8: np.ndarray) -> np.ndarray:
    mean, std = _shapes_stats()
    return ((imgs_u8.astype(np.float32) / 255.0) - mean) / std


def _val_set(size: tuple[int, int], n: int = 16, seed: int = 777):
    rng = np.random.default_rng(seed)
    return shapes.sample_batch(rng, n, size)


def _on(device, tensors) -> dict:
    return {k: v.to(device) for k, v in tensors.items()}


def _host(tensors) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _batch(imgs_u8, labels, device):
    x = torch.from_numpy(_normalize(imgs_u8)).to(device)
    return x, torch.from_numpy(labels.astype(np.int32)).to(device)


def _eval_miou(eval_step, params, bn_state, imgs_u8, labels, device, batch=8) -> float:
    from tpuseg_torch.metrics.seg import fast_hist, miou_from_hist

    hist = np.zeros((shapes.N_CLASSES, shapes.N_CLASSES), np.int64)
    for i in range(0, len(imgs_u8), batch):
        x, y = _batch(imgs_u8[i : i + batch], labels[i : i + batch], device)
        _, preds = eval_step(params, bn_state, x, y)
        hist += fast_hist(preds.cpu().numpy().ravel(),
                          labels[i : i + batch].astype(np.int32).ravel(), shapes.N_CLASSES)
    return float(miou_from_hist(hist))


def _train_seg_model(
    params,
    state,
    spec,
    *,
    device,
    masks=None,
    steps: int,
    size: tuple[int, int],
    batch: int,
    lr: float,
    target_miou: float | None,
    eval_every: int,
    seed: int,
    log_prefix: str,
    keep_best: bool = False,
    sparse_exec: bool = False,
):
    """SGD-train (params, state) on fresh shapes scenes on ``device``;
    returns (params, bn_state, curve) as CPU tensors, curve
    [(step, val_miou), ...].

    ``keep_best=True`` returns the weights of the evaluation with the
    highest val mIoU instead of the last step's (the reference's
    checkpoint_best, semantic_seg.py:286-290): recovery curves are noisy
    near convergence.  ``sparse_exec`` with ``masks``: the eligible convs
    train through the fused sparse train step (kernel B2 in the forward and
    the dgrad), as ``semantic_seg train --sparse-exec``."""
    from tpuseg_torch.train import (create_train_state, make_eval_step, make_seg_train_step,
                                    make_sgd)

    tx = make_sgd(lr, momentum=0.9, weight_decay=1e-4)
    sparse_plans = None
    if sparse_exec and masks is not None:
        from tpuseg_torch.ops.sparse_train import build_sparse_train_structs

        structs, report = build_sparse_train_structs(masks, spec)
        n = sum(1 for v in report.values() if v.startswith("sparse-train"))
        print(f"{log_prefix}: sparse-exec on {n} eligible layers")
        sparse_plans = {k: st.to(device) for k, st in structs.items()} or None
    train_step = make_seg_train_step(spec, tx, sparse_plans=sparse_plans)
    eval_step = make_eval_step(spec, "seg")
    st = create_train_state(_on(device, params), _on(device, state), tx,
                            masks=_on(device, masks) if masks else None)
    rng = np.random.default_rng(seed)
    val_imgs, val_labels = _val_set(size)
    curve = []
    best = None  # (miou, host params, host bn_state, step)
    t0 = time.time()
    for step in range(1, steps + 1):
        imgs, labs = shapes.sample_batch(rng, batch, size)
        st, metrics = train_step(st, *_batch(imgs, labs, device))
        if step % eval_every == 0 or step == steps:
            miou = _eval_miou(eval_step, st.params, st.bn_state, val_imgs, val_labels, device)
            curve.append((step, round(miou, 4)))
            print(f"{log_prefix} step {step}: loss={float(metrics['loss']):.4f} "
                  f"val_miou={miou:.4f} ({time.time() - t0:.0f}s)")
            if keep_best and (best is None or miou > best[0]):
                best = (miou, _host(st.params), _host(st.bn_state), step)
            if target_miou is not None and miou >= target_miou:
                break
    if keep_best and best is not None:
        print(f"{log_prefix}: keeping best weights (step {best[3]}, val_miou={best[0]:.4f})")
        return best[1], best[2], curve
    return _host(st.params), _host(st.bn_state), curve


def stage_train(args) -> str:
    from tpuseg_torch.models.drn import jax_key
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.train import save_checkpoint

    size = (args.train_size, args.train_size)
    # tpuseg draws from jax.random.key(seed)'s data, SeedSequence([0, seed])
    params, state, spec = init_drnseg(jax_key(args.seed), args.arch, shapes.N_CLASSES)
    params, bn_state, curve = _train_seg_model(
        params, state, spec, device=args.device, steps=args.steps, size=size,
        batch=args.batch, lr=args.lr, target_miou=args.target_miou,
        eval_every=args.eval_every, seed=args.seed + 1, log_prefix="train",
    )
    ckpt = os.path.join(args.out, f"{args.arch}_shapes.npz")
    save_checkpoint(ckpt, params, bn_state,
                    meta={"arch": args.arch, "classes": shapes.N_CLASSES,
                          "world": "shapes", "train_size": args.train_size})
    _append_report(args.out, {
        "stage": "train",
        "arch": args.arch,
        "train_size": args.train_size,
        "steps_run": curve[-1][0] if curve else 0,
        "val_miou": curve[-1][1] if curve else None,
        "curve": curve,
        "checkpoint": ckpt,
    })
    return ckpt


def _load_trained(args):
    from tpuseg_torch.models.drnseg import build_drnseg_spec
    from tpuseg_torch.train import load_checkpoint

    ckpt = os.path.join(args.out, f"{args.arch}_shapes.npz")
    if not os.path.exists(ckpt):
        raise SystemExit(f"{ckpt} not found — run --stage train first (or --stage all)")
    params, bn_state, _masks, _opt, meta = load_checkpoint(ckpt)
    spec = build_drnseg_spec(args.arch, shapes.N_CLASSES)
    return params, bn_state, spec, meta


def _gt_miou_from_ids(ids, labels: np.ndarray) -> float:
    from tpuseg_torch.metrics.seg import fast_hist, miou_from_hist

    hist = np.zeros((shapes.N_CLASSES, shapes.N_CLASSES), np.int64)
    for i, frame_ids in enumerate(ids):
        hist += fast_hist(np.asarray(frame_ids).ravel(), labels[i].ravel().astype(np.int32),
                          shapes.N_CLASSES)
    return float(miou_from_hist(hist))


def _drift_thresh(frames: np.ndarray) -> tuple[float, float]:
    """Drift scale of this video -> (threshold, mean |delta|), shared with
    the serving autotuner (``tpuseg_torch.video.autotune``)."""
    from tpuseg_torch.video.autotune import drift_threshold

    return drift_threshold(frames)


def _video(args, speed: float):
    """The served video: ``--video-frames`` frames of (train_size,
    2 * train_size), seed ``--seed + 2``."""
    h = args.train_size
    frames, labels = shapes.shapes_video(args.video_frames, (h, 2 * h), seed=args.seed + 2,
                                         speed=speed)
    return frames, labels


def _int8_gate(args, modes: dict, stage: str) -> dict:
    """Without ``--modes``, the CPU drops the int8 modes (``tpuseg`` drops
    them on its CPU backend; the card runs them)."""
    if args.modes or args.device.type != "cpu":
        return modes
    dropped = [k for k in modes if "int8" in k]
    if dropped:
        print(f"{stage}: skipping {dropped} on the CPU backend "
              "(naive int8 conv lowering; run on TPU or force with --modes)")
    return {k: v for k, v in modes.items() if "int8" not in k}


def stage_fidelity(args) -> None:
    from tpuseg_torch.ops.quant import ids_agreement
    from tpuseg_torch.video.pipeline import VideoSegmenter

    params, bn_state, spec, _meta = _load_trained(args)
    mean, std = _shapes_stats()
    h = args.train_size
    w = 2 * h
    frames, labels = _video(args, args.speed)
    frame_list = list(frames)
    thresh, drift_mean = _drift_thresh(frames)

    def run_mode(**kw):
        seg = VideoSegmenter(dict(params), dict(bn_state), spec, mean, std,
                             device=args.device, batch=args.serve_batch, **kw)
        return seg.run(frame_list, need_color=False)["ids"]

    budget = dict(temporal_thresh=thresh, temporal_budget=max(1, args.serve_batch // 4))
    # the flow warp pools luma /8 then block-matches on a 16 px grid: frames
    # must be multiples of 128 a side (video/flow.py)
    warp_ok = h % 128 == 0 and w % 128 == 0
    modes: dict[str, dict] = {
        "exact": {},
        "yuv420": dict(transport="yuv420"),
        "int8_dynamic": dict(quantize=True),
        "int8_calib": dict(quantize=True, calib_frames=frames[:8]),
        "int8_stem_calib": dict(quantize=True, quantize_stem=True, calib_frames=frames[:8]),
        "temporal2": dict(temporal_interval=2),
        "temporal2_nearest": dict(temporal_interval=2, temporal_nearest=True),
        "temporal4": dict(temporal_interval=4),
        "temporal4_nearest": dict(temporal_interval=4, temporal_nearest=True),
        "budget": dict(budget),
        "budget_nearest": dict(budget, temporal_nearest=True),
        "budget_int8": dict(budget, quantize=True, calib_frames=frames[:8]),
    }
    if warp_ok:
        modes["temporal2_warp"] = dict(temporal_interval=2, temporal_warp=True)
        modes["budget_warp"] = dict(budget, temporal_warp=True)
        modes["budget_warp_nearest"] = dict(budget, temporal_warp=True, temporal_nearest=True)
        modes["budget_warp_int8"] = dict(budget, temporal_warp=True, quantize=True,
                                         calib_frames=frames[:8])
    else:
        print(f"fidelity: skipping warp modes (frame {h}x{w} not a multiple of 128 per axis)")
    if args.modes:
        keep = {m.strip() for m in args.modes.split(",")}
        keep.add("exact")  # the agreement baseline is always needed
        modes = {k: v for k, v in modes.items() if k in keep}
    modes = _int8_gate(args, modes, "fidelity")
    exact_ids = None
    rows = {}
    for name, kw in modes.items():
        t0 = time.time()
        ids = run_mode(**kw)
        if name == "exact":
            exact_ids = ids
        n = min(len(ids), len(exact_ids), len(labels))
        rows[name] = {
            "ids_agreement_vs_exact": round(ids_agreement(ids[:n], exact_ids[:n]), 4),
            "gt_miou": round(_gt_miou_from_ids(ids[:n], labels[:n]), 4),
            "wall_s": round(time.time() - t0, 1),
        }
        print(f"fidelity {name}: {rows[name]}")
    _append_report(args.out, {
        "stage": "fidelity",
        "arch": args.arch,
        "weights": "trained-on-shapes",
        "video": {
            "frames": args.video_frames,
            "size": [h, w],
            "speed_px_per_frame": args.speed,
            "drift_mean_abs_delta": round(drift_mean, 2),
            "thresh_used": round(thresh, 2),
        },
        "modes": rows,
    })


def _config(args, name: str) -> str:
    return os.path.join(REPO_ROOT, "optimal_configs", args.arch, f"{args.arch}_{name}.json")


def _magnitude_masks(config: str, seed: int, params) -> dict:
    """Masks of ``config`` from the weights' magnitudes (``tpuseg``'s
    default ``is_static=False``)."""
    from tpuseg_torch.sparsity import create_masker

    return create_masker(config, seed=seed).generate_masks(params, is_static=False)


def stage_compress(args) -> None:
    from tpuseg_torch.sparsity import apply_masks
    from tpuseg_torch.train import magnitude_unstructured_masks, make_eval_step

    params, bn_state, spec, _meta = _load_trained(args)
    size = (args.train_size, args.train_size)
    eval_step = make_eval_step(spec, "seg")
    val_imgs, val_labels = _val_set(size)
    dev_bn = _on(args.device, bn_state)
    dense_miou = _eval_miou(eval_step, _on(args.device, params), dev_bn, val_imgs, val_labels,
                            args.device)
    variants = {
        "rbgp_50": _magnitude_masks(_config(args, "512X512_0.00_50.00"), args.seed, params),
        "unstructured_50": magnitude_unstructured_masks(params, 0.5),
        # the vendored serving geometries: raw BlockPruner block128 (the speed
        # end) and block-regular N:M (the fidelity end)
        "block128_87.5": _magnitude_masks(_config(args, "block128_87.50"), args.seed, params),
        "block128reg_87.5": _magnitude_masks(_config(args, "block128reg_87.50"), args.seed,
                                             params),
    }
    if args.variants:
        want = {v.strip() for v in args.variants.split(",") if v.strip()}
        unknown = want - set(variants)
        if unknown:
            raise SystemExit(f"--variants: unknown {sorted(unknown)}; have {sorted(variants)}")
        variants = {k: v for k, v in variants.items() if k in want}
    results = {"dense_miou": round(dense_miou, 4)}
    for name, masks in variants.items():
        masked = apply_masks(params, masks)
        at_mask = _eval_miou(eval_step, _on(args.device, masked), dev_bn, val_imgs, val_labels,
                             args.device)
        _p, _bn, curve = _train_seg_model(
            masked, bn_state, spec, device=args.device, masks=masks,
            steps=args.recover_steps, size=size, batch=args.batch,
            lr=args.lr * 0.2,  # fine-tune LR: the reference retrains at lr/5
            target_miou=None, eval_every=args.eval_every, seed=args.seed + 3,
            log_prefix=f"recover[{name}]", sparse_exec=args.sparse_exec,
        )
        results[name] = {
            "miou_at_mask": round(at_mask, 4),
            "recovery_curve": curve,
            "miou_recovered": curve[-1][1] if curve else None,
            **({"sparse_exec": True} if args.sparse_exec else {}),
        }
        print(f"compress {name}: {results[name]}")
    _append_report(args.out, {"stage": "compress", "arch": args.arch,
                              "weights": "trained-on-shapes", **results})


def stage_compose(args) -> None:
    """Full-stack serving composition on recovered sparse weights: recover
    the vendored block128reg geometry from the trained checkpoint (masked
    fine-tune, best evaluation kept, cached with its masks at
    ``<out>/<arch>_shapes_block128reg.npz``), then serve it through the
    pipeline (gathered-exact sparse plans, as ``seg_video
    --pr-config-path``) composed with int8 and budgeted temporal reuse,
    beside the dense trained baseline: ``sparse_exact`` against
    ``dense_exact`` isolates the mask's cost, the other rows each
    approximation's cost on top."""
    from tpuseg_torch.models.sparse_exec import build_sparse_plans
    from tpuseg_torch.ops.fold_bn import fold_bn
    from tpuseg_torch.ops.quant import ids_agreement
    from tpuseg_torch.sparsity import apply_masks
    from tpuseg_torch.train import load_checkpoint, save_checkpoint
    from tpuseg_torch.video.pipeline import VideoSegmenter

    params, bn_state, spec, _meta = _load_trained(args)
    regular_cfg = _config(args, "block128reg_87.50")
    rec_ckpt = os.path.join(args.out, f"{args.arch}_shapes_block128reg.npz")
    if os.path.exists(rec_ckpt):
        r_params, r_bn, masks, _opt, rec_meta = load_checkpoint(rec_ckpt)
        print(f"compose: reusing recovered checkpoint {rec_ckpt} "
              f"(recovered mIoU {rec_meta.get('miou_recovered')})")
    else:
        # magnitude masks from the trained weights (compress's
        # block128reg_87.5 variant), then a masked fine-tune
        masks = _magnitude_masks(regular_cfg, args.seed, params)
        r_params, r_bn, curve = _train_seg_model(
            apply_masks(params, masks), bn_state, spec, device=args.device, masks=masks,
            steps=args.recover_steps, size=(args.train_size, args.train_size),
            batch=args.batch, lr=args.lr * 0.2, target_miou=None,
            eval_every=args.eval_every, seed=args.seed + 3, log_prefix="compose-recover",
            keep_best=True,
        )
        rec_meta = {"miou_recovered": max((m for _, m in curve), default=None),
                    "recover_steps": args.recover_steps}
        # the masks ride along so serving rebuilds the recovery's geometry
        save_checkpoint(rec_ckpt, r_params, r_bn, masks=masks, meta=rec_meta)

    plans, report = build_sparse_plans(fold_bn(r_params, r_bn, spec), masks, spec,
                                       lowering="gathered", gathered_mode="exact")
    n_sparse = sum(1 for v in report.values() if not v.startswith("dense"))
    print(f"compose: {n_sparse}/{len(report)} masked convs on the gathered-exact lowering")

    mean, std = _shapes_stats()
    h = args.train_size
    w = 2 * h
    frames, labels = _video(args, args.speed)
    frame_list = list(frames)
    thresh, drift_mean = _drift_thresh(frames)
    budget = dict(temporal_thresh=thresh, temporal_budget=max(1, args.serve_batch // 4))

    def run_mode(p, bn, plans_, **kw):
        seg = VideoSegmenter(dict(p), dict(bn), spec, mean, std, device=args.device,
                             batch=args.serve_batch, exec_plans=plans_, **kw)
        return seg.run(frame_list, need_color=False)["ids"]

    calib = frames[:8]
    modes: dict[str, tuple] = {
        # (params, bn, plans, VideoSegmenter kwargs); sparse_exact runs
        # first: it is every other row's agreement baseline
        "sparse_exact": (r_params, r_bn, plans, {}),
        "dense_exact": (params, bn_state, None, {}),
        "sparse_budget": (r_params, r_bn, plans, dict(budget)),
        "sparse_int8": (r_params, r_bn, plans, dict(quantize=True, calib_frames=calib)),
        "sparse_int8_budget": (r_params, r_bn, plans,
                               dict(budget, quantize=True, calib_frames=calib)),
    }
    if args.modes:
        keep = {m.strip() for m in args.modes.split(",")}
        keep.update(("dense_exact", "sparse_exact"))  # the two baselines
        modes = {k: v for k, v in modes.items() if k in keep}
    modes = _int8_gate(args, modes, "compose")
    sparse_exact_ids = None
    rows = {}
    for name, (p, bn, plans_, kw) in modes.items():
        t0 = time.time()
        ids = run_mode(p, bn, plans_, **kw)
        if name == "sparse_exact":
            sparse_exact_ids = ids
        n = min(len(ids), len(labels))
        row = {"gt_miou": round(_gt_miou_from_ids(ids[:n], labels[:n]), 4),
               "wall_s": round(time.time() - t0, 1)}
        if sparse_exact_ids is not None:
            m = min(len(ids), len(sparse_exact_ids))
            row["ids_agreement_vs_sparse_exact"] = round(
                ids_agreement(ids[:m], sparse_exact_ids[:m]), 4)
        rows[name] = row
        print(f"compose {name}: {row}")
    _append_report(args.out, {
        "stage": "compose",
        "arch": args.arch,
        "weights": "trained-on-shapes, block128reg_87.5 recovered "
                   f"({rec_meta.get('miou_recovered')} mIoU at save)",
        "geometry": os.path.basename(regular_cfg),
        "video": {
            "frames": args.video_frames,
            "size": [h, w],
            "speed_px_per_frame": args.speed,
            "drift_mean_abs_delta": round(drift_mean, 2),
            "thresh_used": round(thresh, 2),
        },
        "modes": rows,
    })


def stage_budget_curve(args) -> None:
    """GT mIoU against the refresh budget of budgeted temporal reuse: for
    each drift speed in ``--speeds``, the exact baseline once, then the
    budgeted mode at every K in ``--budget-ks`` (GT mIoU and ids agreement
    per point).  K/B is the most frames a batch refreshes: the budgeted
    choice is gated by the drift threshold first, so even K = B reuses the
    frames below it."""
    from tpuseg_torch.ops.quant import ids_agreement
    from tpuseg_torch.video.pipeline import VideoSegmenter

    params, bn_state, spec, _meta = _load_trained(args)
    mean, std = _shapes_stats()
    h = args.train_size
    w = 2 * h
    ks = [int(k) for k in args.budget_ks.split(",")]
    if not all(0 < k <= args.serve_batch for k in ks):
        raise SystemExit(f"--budget-ks entries must be in 1..{args.serve_batch}")
    speeds = [float(s) for s in args.speeds.split(",")]

    def run_mode(frame_list, **kw):
        seg = VideoSegmenter(dict(params), dict(bn_state), spec, mean, std,
                             device=args.device, batch=args.serve_batch, **kw)
        return seg.run(frame_list, need_color=False)["ids"]

    curves = {}
    for speed in speeds:
        frames, labels = _video(args, speed)
        frame_list = list(frames)
        thresh, drift_mean = _drift_thresh(frames)
        exact_ids = run_mode(frame_list)
        n = min(len(exact_ids), len(labels))
        exact_miou = round(_gt_miou_from_ids(exact_ids[:n], labels[:n]), 4)
        points = {"exact": {"gt_miou": exact_miou, "max_refresh_fraction": 1.0}}
        print(f"budget_curve speed={speed}: exact {points['exact']}")
        for k in ks:
            ids = run_mode(frame_list, temporal_thresh=thresh, temporal_budget=k)
            m = min(len(ids), len(exact_ids), len(labels))
            points[f"K={k}"] = {
                "gt_miou": round(_gt_miou_from_ids(ids[:m], labels[:m]), 4),
                "ids_agreement_vs_exact": round(ids_agreement(ids[:m], exact_ids[:m]), 4),
                "max_refresh_fraction": round(k / args.serve_batch, 4),
            }
            print(f"budget_curve speed={speed}: K={k} {points[f'K={k}']}")
        curves[f"speed={speed}"] = {
            "drift_mean_abs_delta": round(drift_mean, 2),
            "thresh_used": round(thresh, 2),
            "points": points,
        }
    _append_report(args.out, {
        "stage": "budget_curve", "arch": args.arch,
        "weights": "trained-on-shapes (dense; compose showed the temporal cost is "
                   "weight-path-invariant)",
        "video": {"frames": args.video_frames, "size": [h, w], "serve_batch": args.serve_batch},
        "curves": curves,
    })


def stage_cls(args) -> None:
    """The rmbsnn pruning-recovery loop on the classification proxy
    (``shapes.sample_cls_batch``): train a cifar_resnet20 teacher, prune it
    to RBGP 50 % (``generate_rbgp_config``, oblock 16x16, cblock 8x8, inner
    sparsity 0.5, masks from the weights' magnitudes), then retrain the
    pruned net plain and with knowledge distillation from the teacher.  bf16
    compute, SGD lr 0.1; ``tpuseg``'s seeds and streams."""
    from tpuseg_torch.cli.expander_batch import generate_rbgp_config
    from tpuseg_torch.models.drn import jax_key
    from tpuseg_torch.models.factory import create_model
    from tpuseg_torch.sparsity import apply_masks, create_masker
    from tpuseg_torch.train import (
        classifier_forward,
        create_train_state,
        make_cls_train_step,
        make_sgd,
    )

    device = args.device
    arch = "cifar_resnet20"
    params, state, spec, _kw = create_model(jax_key(args.seed), "cifar10", arch)
    params = {k: v.to(device) for k, v in params.items()}
    state = {k: v.to(device) for k, v in state.items()}
    tx = make_sgd(0.1, momentum=0.9, weight_decay=1e-4)
    rng = np.random.default_rng(args.seed + 10)
    val_rng = np.random.default_rng(args.seed + 11)
    val_x, val_y = shapes.sample_cls_batch(val_rng, 1024)
    fwd = classifier_forward(spec, torch.bfloat16)

    @torch.inference_mode()
    def accuracy(p, bn) -> float:
        correct = 0
        for i in range(0, len(val_x), 256):
            x = torch.from_numpy(val_x[i:i + 256]).to(device)
            logits = fwd(p, bn, x, train=False)[0]
            correct += int((logits.argmax(-1).cpu().numpy() == val_y[i:i + 256]).sum())
        return correct / len(val_x)

    def train(p, bn, *, masks, steps, teacher, log_prefix):
        step_fn = make_cls_train_step(spec, tx, teacher=teacher)
        st = create_train_state(p, bn, tx, masks=masks)
        for step in range(1, steps + 1):
            x, y = shapes.sample_cls_batch(rng, 128)
            st, m = step_fn(st, torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
            if step % args.eval_every == 0 or step == steps:
                print(f"{log_prefix} step {step}: loss={float(m['loss']):.3f} "
                      f"batch_acc={float(m['acc']):.3f}")
        return st.params, st.bn_state

    t_params, t_bn = train(params, state, masks=None, steps=args.cls_steps, teacher=None,
                           log_prefix="teacher")
    teacher_acc = accuracy(t_params, t_bn)
    cfg = generate_rbgp_config(t_params, arch, oblock=(16, 16), cblock=(8, 8),
                               iblock=(1, 1), osp=0.0, isp=0.5)
    # tpuseg's generate_masks default: masks from the weights' magnitudes
    masks = create_masker(cfg, seed=args.seed).generate_masks(
        {k: v.cpu() for k, v in t_params.items()}, is_static=False)
    masks = {k: v.to(device) for k, v in masks.items()}
    pruned = apply_masks(t_params, masks)
    acc_at_mask = accuracy(pruned, t_bn)

    def t_forward(tp, tbn, images):
        return fwd(tp, tbn, images, train=False)[0]

    results = {"teacher_acc": round(teacher_acc, 4), "acc_at_mask_50pct": round(acc_at_mask, 4)}
    for name, teacher in (("retrain_plain", None), ("retrain_kd", (t_forward, t_params, t_bn))):
        p2, bn2 = train(pruned, t_bn, masks=masks, steps=args.recover_steps, teacher=teacher,
                        log_prefix=name)
        results[name + "_acc"] = round(accuracy(p2, bn2), 4)
        print(f"cls {name}: {results[name + '_acc']}")
    _append_report(args.out, {"stage": "cls", "arch": arch, "weights": "trained-on-shapes-cls",
                              **results})


STAGES = {"train": stage_train, "fidelity": stage_fidelity, "compress": stage_compress,
          "compose": stage_compose, "budget_curve": stage_budget_curve, "cls": stage_cls}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--stage", default="all", choices=[*STAGES, "all"])
    p.add_argument("--out", default="runs/fidelity")
    p.add_argument("--arch", default="drn_d_22")
    p.add_argument("--train-size", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--recover-steps", type=int, default=300)
    p.add_argument("--cls-steps", type=int, default=500,
                   help="cls stage: the teacher's train steps")
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--target-miou", type=float, default=93.0,
                   help="early-stop val mIoU, in PERCENT (miou_from_hist)")
    p.add_argument("--video-frames", type=int, default=96)
    p.add_argument("--speed", type=float, default=4.0)
    p.add_argument("--serve-batch", type=int, default=8)
    p.add_argument("--variants", default=None,
                   help="comma list restricting the compress-stage mask variants "
                        "(default: all)")
    p.add_argument("--sparse-exec", action="store_true",
                   help="compress stage: run mask recovery through the fused sparse "
                        "train step (the `semantic_seg train --sparse-exec` path: "
                        "kernel B2 in the forward and the dgrad of the eligible "
                        "layers, tpuseg_torch.ops.sparse_train) instead of "
                        "masked-dense")
    p.add_argument("--modes", default=None,
                   help="comma list restricting the fidelity mode matrix (exact always "
                        "runs as the baseline)")
    p.add_argument("--budget-ks", default="1,2,4",
                   help="budget_curve stage: comma list of refresh budgets K (frames "
                        "forwarded per serve batch)")
    p.add_argument("--speeds", default="1.0,4.0",
                   help="budget_curve stage: comma list of drift speeds (px/frame) to "
                        "measure the curve at")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None):
    from tpuseg_torch.device import resolve_device

    args = parse_args(argv)
    args.device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    stages = (["train", "fidelity", "compress", "compose", "cls"] if args.stage == "all"
              else [args.stage])
    for s in stages:
        STAGES[s](args)


if __name__ == "__main__":
    main()
