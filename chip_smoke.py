#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``tpuseg_torch``): builds the CUDA
kernels from ``tpuseg_torch/csrc/``, holds each against its plain PyTorch
version, drives the served slices (DRN-D-22 DRNSeg, 19 classes, 1024x2048,
dense and pruned, float and int8, with the int8 stem, every temporal mode,
the yuv420 transport, the device resize, packed ids and device outputs)
through ``VideoSegmenter`` and the CLI, trains DRNSeg at crop 512 (dense,
masked, ``--sparse-exec``) through the trainer's CLI, runs the
trained-weights fidelity tool and serves its checkpoint, trains the DRN-D-22
classifier and runs the classifier CLIs and tools (the CIFAR zoo in int8
through B3's narrow route), runs every mode of the sparse-conv bench and
both CLIs' ``--profile-dir``, and times the kernels against their plain
versions.

    python3 chip_smoke.py        # from the repo root, one CUDA card

Phases (any failed check raises and the exit code is non-zero):
  1. card, versions, kernel build time;
  2. B1 (upsample_argmax) vs plain ids on the card, bit-equal, f32 and bf16
     logits: the serving width; C = 1, 19 (the compile-time instance) and
     255 (staged class groups); h = w = 1; ragged column chunks; odd w; rows
     not 16-byte aligned; exact ties (all classes, and two classes equal and
     maximal, ids checked to be the lower class); a tall 8h > 65,535 input;
  3. slice parity in f32 (TF32 off): CUDA with the kernel vs CPU with the
     plain versions, ids agreement >= 0.999;
  4. the slice at full width and size in bf16: run() over 32 shapes frames
     at batch 8 (ids checked, kernel launch count > 0, agreement with the
     same frames in f32 >= 0.9), then the device rate at batch 32;
  5. B1 vs plain time at the serving shape (32, 128, 256, 19) bf16, with
     B1's bound in f32 instructions at the card's lane rate (SMs x 128 x
     the max SM clock; the compare/select pipe at half of it) for this
     run's weights (``_b1_bound``), beside the earlier FLOP-count bound;
  6. the block-sparse conv kernel (B2) vs its plain version (f32 convs, TF32
     off) at the CPU tests' shapes, a 1x1, an S=2 and an all-zero plan, f32
     and bf16 plans, then each of the 7 B2 plans of block128reg_87.50 at its
     batch-32 serving input; on each of those 7 the served bf16+bias route
     (one B2 launch writing bf16(bf16(y) + bias)) bit-equal to the two
     passes it replaces (B2's f32 y, cast, bias add); a non-contiguous
     input must raise;
  7. pruned slice parity in f32: block128_75.00 masks, Pallas lowering, f32
     plans, CUDA with the kernel vs CPU with the plain versions, ids
     agreement >= 0.999;
  8. the pruned slice at full width and size: block128reg_87.50, Pallas
     lowering, bf16; run() over 32 shapes frames at batch 8 (B2 launched
     exactly 7 times per forward, ids agreement with the f32 masked-dense
     path >= 0.9), then the device rate at batch 32 for the Pallas lowering,
     the gathered lowering and masked dense;
  9. B2 vs plain vs the dense cuDNN conv at the layer.6.1.conv2 serving shape,
     and the bf16+bias route vs the two passes it replaces;
 10. the quantize kernels (``csrc/quantize.cu``) vs ``quantize_activation``
     on the CPU, bit for bit on xq and xs (bf16 and f32, per-frame and
     static, unmapped and through contiguous, all-padding, gathered and
     mixed channel maps read by their vector descriptors, a 40x frame and
     an all-zero frame; a NaN frame's scale NaN on both sides); the int8
     block-sparse conv kernel (B3) vs its exact plain version, bit-equal:
     the CPU tests' shapes with per-frame and static scales, f32 and bf16 x;
     B3's narrow route (cin and cout in 16/32/48/64 with k 1 and 3, K = 128
     packings, odd maps, several images a tile, an all-zero plan); then
     every int8 plan the served configurations launch (13 ``QuantConv``,
     the 7 lifted B2 plans of block128reg_87.50, ``CompactSparseQ`` through
     its channel map's vectors, one ``GatheredGroupConvQ``) at its batch-32
     serving input, on the f32 route and on the served bf16+bias route (0
     mismatches against the plain f32 y cast and biased); a non-contiguous
     input must raise; the quantize pass through each served
     ``CompactSparseQ`` map timed against its bound and
     ``index_select`` + the unmapped pass;
 11. int8 slice parity in f32 (TF32 off), dense and block128_75.00 Pallas:
     every int8 conv's CUDA output is bit-equal to the CPU plain version on
     the activation the CUDA run gave it, and CUDA vs CPU ids agree >= 0.97;
 12. int8 at full width and size, bf16, batch 8, 32 frames: dense (per-frame
     scales), dense calibrated on 8 frames, block128reg_87.50 under the
     Pallas and the gathered lowering; B3 launched exactly 13 / 13 / 11 / 13
     times per forward and B2 never, the quantize kernel once per B3 launch
     (4 of them a forward through a channel map under the Pallas lowering)
     and the absmax kernel too except in the calibrated run (0); ids
     agreement with the float runs and calibrated vs dynamic >=
     INT8_FULL_MIN (0.9 dense, 0.85 pruned);
 13. device fps at batch 32 of those four int8 variants, and at
     layer.6.1.conv2: B3's served route (quantize + B3 with its bf16+bias
     epilogue), B3 alone (bf16 and f32 out), the quantize kernels alone
     (per-frame and static), their plain versions, B2, the dense cuDNN bf16
     conv with bias (context only: no PyTorch call computes an int8 conv on
     CUDA) and the dense S=4 conv through B3's served route; then B2's
     bf16+bias route and B3's served route there at 1024x2048 (w = 256)
     and 512x1024 frames (w = 128) in turns;
 14. B4 (``bsr_matmul_xw``, B2's kernel at k=1) and ``sparse_conv_apply``
     vs their plain versions (TF32 off): the CPU tests' cases in f32 and
     bf16, x (32768, 512) and (1048576, 512) bf16 against a 512x512
     BlockPruner 87.5 % weight, the bench's 3x3 d=2 and 1x1 convs at each of
     its sparsities at batch 1 and the 3x3 at 87.5 % at batch 32, with B4
     launched exactly once per tap; a non-contiguous x must raise;
 15. B5/B6 (``bsr_matmul``, ``bsr_matmul_gathered``: ``csrc/bsr_matmul.cu``)
     vs their plain version: the CPU tests' cases (ragged rows, an empty
     row, an all-zero W, a ragged N through the non-TMA path), and a
     512x512 87.5 % W, which has empty rows, on x (512, 32768) and
     (512, 1048576) bf16;
 16. B7a-f (B2's kernel on their packings) vs ``fused_sparse_conv_reference``
     on the same packing: the CPU tests' kinds, every plan the bench's fused
     mode launches (each sparsity, the all-ones shared plan) at batch 1, and
     the 87.5 % plans at batch 32;
 17. this slice's paths with every launch count zeroed just before and read
     just after: ``python -m tpuseg_torch.bench_sparse --fused``'s
     ``main`` (the bench's main and fused modes: B2, B3, B4, B7a-f) and one
     call each of ``bsr_matmul`` and ``bsr_matmul_gathered`` at the batch-32
     shape; exact launch counts;
 18. B4, B5, B6 and B7a-f at their batch-32 shapes in turns against their
     plain versions and one PyTorch call of the same function (for B4-B6
     ``torch.mm(..., out_dtype=torch.float32)`` of the masked dense bf16 W,
     which writes the f32 y they write, beside the bf16-out
     ``torch.matmul``; for B7 the masked dense cuDNN conv), a yardstick the
     port never calls;
 19. the int8 stem: B3's stem route (``fused_sparse_conv_q_bias_relu``, all
     three folded stem convs on B3's narrow kernel: conv0 K = 64, its 48
     channels padded by the quantize pass's map; conv1 and conv2 K = 128,
     S = 2; N = 128) at the inputs a bf16 batch-32 run of the calibrated
     int8-stem frontend gives them, which hands int8 from conv0 to conv1
     and from conv1 to conv2: every epilogue mode (relu(y + bias) as f32
     and bf16, the int8 hand-off from either) bit-equal to its plain
     version on each conv's float x, per-frame and static scales, and on
     the int8 x handed to conv1 and conv2; the relu and the hand-off on
     -0.0 and NaN, the hand-off on .5 ties and clamps; the whole stem,
     static and per frame, bit-equal to its plain chain on the card;
     conv0's quantize pass (through that map, whose -1s are zero vectors,
     and unpadded) bit-equal and timed against its bound, F.pad to 128 and
     its plain version; each conv's route as the frontend runs it, per
     frame and static without the hand-off, plain version and bound beside
     cuDNN's bf16 conv + bias + ReLU; the whole stem static and per frame;
 20. int8-stem f32 parity at 256x512 (per-frame scales): each stem conv's
     CUDA output bit-equal to the CPU plain version on its activation, ids
     >= INT8_PARITY_MIN, exact counts (B3 16, quantize 16, absmax 15 a
     forward; the stem's 3 on the narrow kernel, 13 on the 128-wide one,
     no hand-off);
 21. bench.py's int8_stem mode (dense, calibrated): run() at batch 8 with
     exact counts (B3 16 a forward, 3 of them the stem route on the narrow
     kernel, 2 of those hand-offs; quantize 14, one of them conv0's map
     pass; absmax 0; the 128-wide kernel 13), ids against the int8 run
     without the stem >= INT8_STEM_MIN, the device rate at batch 32, the
     frontend bf16 vs int8 stem in turns and one profiled call of each;
 22. K3 (``frame_deltas``) bit-equal to its plain version on the 32 shapes
     frames and 32 random full-size frames, timed against it and tpuseg's
     expression in eager PyTorch; the budgeted selection's one launch
     (``frame_deltas_budget``, K4's scan in K3's last block) equal to K3's
     and K4's plain versions on both, one launch a call, and K4's time as
     that launch's less K3's alone, in turns; K4 alone (``budget_select``)
     equal to its plain version under budget pressure, from n_keyed = 0, on
     ties, at budget 1 and = batch;
 23. bench.py's sparse_int8_budget8 (block128reg_87.50, gathered, int8
     calibrated, batch 32, K = 8, 64 shapes frames of seed 1, threshold
     ``drift_threshold``): run() with exact counts (a batch: B3 13, B1 1,
     the K3 + K4 launch 1, K3 and K4 alone 0, B2 0), the promoted count
     equal to the CPU plain selection, ``benchmark_adaptive_device_fps``;
 24. dense bf16 with temporal_interval=4: B1 once a batch, each frame's ids
     its keyframe's, the device rate at batch 32;
 25. K5 (``keyframe_select``), K6 (``estimate_block_shifts``), K7
     (``warp_ids``) and K8 (``i420_to_rgb_flat``) bit-equal to their plain
     versions (K5 from n_keyed = 0, a cut, a diff at the threshold, the
     shapes frames; K6 a known translation, the serving luma, a constant
     and a period-2 map (ties), and resized luma agreeing on >= 0.99 of the
     blocks; K7 the seam and range cases, (32, 1024, 2048) ids, and at scale
     8 odd shifts, split vectors at the frame's edges, dy seams, shifts
     outside the radius and a 640-px width; K8 on its vector path on
     0/255, 8 frames at 1024x2048 and at 512x1024, a 640x360 decode and
     every (Y, U, V) triple, on its byte path on random planes 130 and 854
     wide and a view one byte off 16-byte alignment), a strided input
     raising, and each timed in turns against its plain version with its
     bound, and its device time (K8 also at 8 x 512x1024);
 26. interval 4 with nearest and warped reuse, dense bf16, batch 32: run()
     with exact counts a batch (B1, K3, K6, K7 once), the keyframes' ids
     equal ``ids_for`` on the same 8 frames, the device rate, and device ms
     by kernel of one batch with and one without the warp;
 27. phase 23's configuration with nearest and warped reuse: exact counts
     (B3 13, B1, K3, K4, K6, K7 once a batch), the promotions equal the CPU
     selection, ``benchmark_adaptive_device_fps``;
 28. the sequential adaptive mode, dense bf16, batch 8: promotions equal
     K5's plain version on the CPU, one forward a batch of exactly the
     promoted frames, K5 one launch a batch, the adaptive rate;
 29. yuv420 with a 512x1024 -> 1024x2048 device resize and 5-bit ids at
     batch 8: K8 (on its vector path) and B1 once a batch, ids equal the
     unpacked run's, device color and overlay equal their reconstruction,
     bytes up and down a batch;
 30. ``python -m tpuseg_torch.cli.seg_video --video shapes --size 1024x2048
     --frames 32 --batch 8 --temporal-autotune 0.9 --temporal-warp``: its
     temporal_autotune event and result line parse.
 31. ``sparse_conv_train`` (B2 in the forward and, on the transposed
     packing, in the dgrad) vs its plain version within 2*K*eps on each of
     the 10 structs ``build_sparse_train_structs`` makes from
     block128reg_87.50, at its crop-512, batch-8 activation (8, 64, 64,
     Cin), on k in {1, 3}, d in {1, 2, 4} cases, and on B2's tile
     geometry (``TILE_CASES``: R whole rows of a narrow map, rows past h,
     w not dividing 256, R = 1 segments; R and the grid printed before
     each); rows per tile out of range raising, the other legal ones
     agreeing with the plain version; y and dx also vs
     cuDNN's f64 conv and dgrad of the bf16 masked weight, which a wrong
     packing or transpose index would fail; the f32 wgrad vs the dense
     conv's weight gradient on the mask; one B2 launch in the forward
     and one in the backward of each call; a live tile of zero weights, then
     refilled, under one plan; a strided dy raising; the forward and the
     dgrad at layer.6.1.conv2's shape timed against their plain versions and
     cuDNN's dense conv and dgrad;
 32. ``python -m tpuseg_torch.cli.semantic_seg train --synthetic 64 -s 512
     --batch-size 8 --eval-every 1 --epochs 1`` in this process (bf16), then
     resumed from its checkpoint for epoch 1; ms a step (CUDA events, after
     warm-up) and peak memory with and without --remat, and without it the
     device's busy ms and idle share over 5 profiled steps; in f32, --remat's
     loss equal and its peak lower at full width, and one step on the card
     against the CPU at 64x64 (loss rtol 1e-4, params and BN state rtol
     2e-3 / atol 5e-4);
 33. the README's masked command (``--mc-pruning --pr-static
     --pr-config-path`` block128reg_87.50) with and without
     ``--sparse-exec``: its sparse_exec report, B2 launched exactly 2 x 10
     times a train step (forward and dgrad) and never in evaluation, ms a
     step of each and its device busy ms, idle share and largest kernels
     over 5 profiled steps, masked weights exactly 0, and in f32 at 64x64 the two
     trajectories within phase 32's tolerances.
 34. ``python -m tpuseg_torch.tools.trained_fidelity`` in this process at
     its defaults (DRN-D-22, train size 128, batch 8, up to 800 steps, 300
     recovery steps, a 96-frame 128x256 video at 4 px/frame, serve batch 8):
     train, fidelity (every mode, int8 and warp included), compress
     (block128reg_87.5 through --sparse-exec), compose and budget_curve
     (speeds 1 and 4), each stage's report row, seconds and launch counts
     (zeroed just before the stage, read just after); gates: the exact rows
     agree with themselves, every GT mIoU in [0, 100], the train stage's
     val mIoU >= 60, the int8 rows >= 0.97 against their exact baseline,
     and B2 (training), B1, B3, the quantize pass, K3/K4, K6/K7 and K8
     launched in the stages that run them; the stem's convs alone on B3's
     narrow kernel, two of each three handing int8 on;
 35. ``python -m tpuseg_torch.tools.remat_mem --cases seg`` (DRN-D-22,
     768x768, batch 4, bf16): temp_ratio < 1;
 36. ``seg_video --pretrained`` phase 34's checkpoint on ``shapes:2`` at
     128x256: ids equal to a ``VideoSegmenter`` built here from the same
     npz, unequal to the random-weights run, GT mIoU >= 60; then the host
     decoders the machine has and, with cv2, a written video served with
     ``--video <file> --pretrained``;
 37. the DRN-D-22 classifier (classifier naming, 1000 classes) at 224x224,
     batch 32, bf16, masked by block128reg_87.50 in classifier naming:
     masked dense and ``--sparse-exec``, ms a step over 5 steps after 3 of
     warm-up and the peak memory, B2 launched exactly 2 x 10 times a step
     and never in masked dense or an evaluation, masked weights exactly 0;
     in f32 at 64x64 the two trajectories within phase 32's tolerances and
     one step on the card against the CPU; B2's forward and dgrad against
     their plain versions on the classifier's maps (32, 28, 28, 512) and
     (8, 4, 4, 512), d in {1, 2, 4} (R = min(floor(256 / w), h)), timed at
     (32, 28, 28, 512) d = 4 against cuDNN;
 38. the classifier CLIs in this process with their launch counts:
     ``rmbsnn --dataset synthetic -a drn_d_22 --mc-pruning --pr-static
     --sparse-exec`` (bf16, 1 epoch), ``rmbsnn -a cifar_resnet20 --evaluate
     --quantize`` (int8_layers >= 20, B3's narrow route 16 times a
     forward, each narrow conv bit-equal to its plain version on the card,
     timed at r20's three widths against cuDNN's bf16 conv and its quantize
     pass against its bound), ``rmbsnn -a drn_d_22 --evaluate
     --quantize``, ``imagenet_train --dataset synthetic`` and ``seg_video
     --pretrained x.pth`` (ids equal to the same weights' npz);
 39. ``trained_fidelity --stage cls`` at its defaults and ``remat_mem
     --cases cls,kd``;
 40. ``python -m tpuseg_torch.bench_sparse --fused-appendix --rmcdb --layout
     --model --sweep --frontend --train --conv1split --trainer`` through its
     ``main`` in this process, each mode's loop timed once after its
     untimed loop (INNER unchanged), every launch count zeroed just before
     each mode and read just after: each line parsed, its metric names,
     exact counts (B1 once a frame of --model, with B2, B3 and the
     quantize pass in its rows, the passes through a channel map once for
     each CompactSparseQ; B3's stem route 3 times a frame of --frontend's
     int8 rows, all on the narrow kernel, 2 of them hand-offs, and its
     narrow route 5 more in the stage-3 row; each B3 launch quantizing its
     x but where the stem handed it int8; B2's forward once a step of
     --train (w's gradient only: no dgrad) and its training roles 2 x 10
     a step of --trainer; B2, B3, B7a-f in the fused mode), the conv1split
     gate; ``rmcdb_roll_matmul`` against the masked
     dense matmul at the bench's four geometries in f32; the native
     sparsity library built here and one rmb mask equal to the numpy path;
 41. ``seg_video --profile-dir`` (8 synthetic 1024x2048 frames) and
     ``semantic_seg train --profile-dir`` (2 steps at crop 512, batch 4):
     each trace holds CUDA kernel events, the serving one B1's kernel;
 42. data-parallel training (``tpuseg_torch.parallel``): a one-rank NCCL
     group runs an all_reduce and a step through ``shard_train_step``; two
     gloo ranks sharing cuda:0 (NCCL refuses two ranks on one GPU) train
     DRN-D-22 at crop 512, global batch 8, f32, ``--sparse-exec`` on
     block128reg_87.50, 2 steps: replicas bit-equal after each step, the
     first step within phase 32's f32 tolerance of one process's 8-batch
     step, each rank's B2 forward and dgrad launches equal to its; the step
     ms of both and the flat all-reduce's ms;
 43. ``VideoSegmenter(mesh=make_mesh(data=2, devices=[cuda:0, cuda:0]))``
     at 1024x2048, batch 8: f32 ids bit-equal to one device at the
     replicas' batch, int8 ids >= 0.99 of one device's at batch 8, B1, B3
     and the quantize pass launched exactly once a replica forward, a
     Pallas-lowered plan refused;
 44. ``spatial_forward`` of full-width DRN-D-22 on one 1024x2048 f32 frame
     over two gloo ranks sharing cuda:0: the logits within 2e-4 of the
     unsharded forward, both timed;
 45. the directory envelope of a full-width train state: a blocking save,
     an async save overlapping a train step, ``wait_for_saves``, both
     loaded equal; the ``.new``/``.old`` recovery cases; the seconds of
     phases 40-45.
The line before the last is the kernels' JSON record (each kernel's time,
its plain version's, its bound at the card's published peaks and the
PyTorch call's, at its main shape; B3's time is its served route, the
``quantize`` entry the quantize kernels' per-frame pass, ``quantize_map``
that pass through layer.6.1.conv1's ``CompactSparseQ`` map, the stem route's
entry conv1 of the stem as the calibrated frontend runs it (int8 in, int8
out), ``sparse_conv_q_narrow`` B3's narrow route at
cifar_resnet20's 16-channel conv, its ms and the cuDNN conv's as device time
from CUDA graphs: back to back, that small conv's calls are host-paced).
Each launch counts in one entry: B3's launches by the kernel that ran
them (``sparse_conv_q_kernel``, ``sparse_conv_q_narrow_kernel``), the stem
route's three convs (on the narrow kernel) apart from B3's other narrow
convs, the quantize passes through a map apart from the unmapped ones.
The last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from collections import Counter

ARCH = "drn_d_22"
CLASSES = 19
MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
FULL = (1024, 2048)
SERVING_LOGITS = (32, 128, 256, 19)
CONFIGS = "optimal_configs/drn_d_22"
SERVED_CONFIG = f"{CONFIGS}/drn_d_22_block128reg_87.50.json"
PARITY_CONFIG = f"{CONFIGS}/drn_d_22_block128_75.00.json"
# layer.6.1.conv2 at batch 32, 1024x2048 frames: x (N, H, W, Cin), kernel, dilation
SERVING_SPARSE = ((32, 128, 256, 512), 3, 4)
B2_PER_FORWARD = 7  # B2 convs of block128reg_87.50 under the Pallas lowering
# B3 launches per forward under --quantize: the 13 dense int8 convs; under
# block128reg_87.50, Pallas: 4 QuantConv + 3 FusedSparseConvQ + 4
# CompactSparseQ (3 RBGP plans stay float); gathered: 9 GatheredGroupConvQ
# + 4 QuantConv
B3_PER_FORWARD = {"dense": 13, "dense_calibrated": 13, "pallas": 11, "gathered": 13}
# quantize passes through a CompactSparseQ's channel map per forward (the 4
# CompactSparseQ of block128reg_87.50 under the Pallas lowering)
MAP_PER_FORWARD = {"dense": 0, "dense_calibrated": 0, "pallas": 4, "gathered": 0}
QUANTIZE_MAP_MAIN = "layer.6.1.conv1"  # the quantize_map row's conv: 384 live channels
# int8 ids CUDA vs CPU in f32: two exact int8 paths fed f32 activations that
# differ in the last bit (cuDNN and oneDNN sum in other orders) round a few
# x/scale quotients to other integers, and each such step of a whole
# quantum cascades through the int8 convs after it.  The CPU port against
# itself with oneDNN on and off agreed on 0.983-1.0 of the ids (64x64 to
# 128x256); phase 11 holds every int8 conv bit-equal on the same activation
# and the ids to this floor.
INT8_PARITY_MIN = 0.97
# Phase 12 floors of int8 ids against the float run (calibrated: against the
# dynamic int8 run).  On these random weights int8 agreement falls with the
# frame size, in tpuseg as in the port: block128reg_87.50 under the Pallas
# lowering, f32 on the CPU, shapes frames, int8 vs float agreed on
# 0.9587 / 0.9272 / 0.9015 of the ids at 128x256 / 256x512 / 512x1024 in the
# port and on 0.9594 / 0.9276 / 0.9018 in tpuseg (PERF.md, Findings).  A pruned
# run at 1024x2048 reads about 0.89, so its floor is 0.85; a broken int8
# conv reads far lower.
INT8_FULL_MIN = {"dense": 0.9, "dense_calibrated": 0.9, "pallas": 0.85, "gathered": 0.85}
# Phase 21's floor of int8-stem ids against the calibrated int8 run without
# the stem.  tpuseg on the CPU on the same weights, bf16, calibrated on 8
# shapes frames of seed 0 and served on them (scripts/int8_stem_agreement.py),
# agreed on 0.9681 / 0.9399 / 0.9210 of the ids at 128x256 / 256x512 /
# 512x1024 (f32: 0.9697 / 0.9395 at the first two); the agreement falls with
# the frame size, so the floor leaves room for one more halving; a broken
# stem conv reads far lower.
INT8_STEM_MIN = 0.85
# The card's published peaks (NVIDIA H100 SXM data sheet, dense rates, at
# the full 700 W): each kernel's bound is the larger of its bytes (each
# input the function needs read once: the nonzero 128x128 weight tiles and
# the input channel blocks they read; each output written once) over the
# memory rate and its operations (those nonzero tiles' products) over the
# peak of their type.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# slice 4: the bench's conv (bench_sparse's layer-6 shape) at batch 1 and 32
BENCH_BATCH32 = (32, 128, 256, 512)
P32 = 32 * 128 * 256  # pixels of the batch-32 conv, the rows of B4's x
B7_ENTRIES = {  # entry point -> (ROADMAP id, packing, tpuseg/ops/sparse_conv.py line)
    "shared_sparse_conv_apply": ("B7a", "shared", 450),
    "fused_phase_sparse_conv_apply": ("B7b", "fused", 555),
    "imcol_phase_sparse_conv_apply": ("B7c", "fused", 684),
    "cphase_sparse_conv_apply": ("B7d", "fused", 826),
    "phase_sparse_conv_apply": ("B7e", "shared", 952),
    "shared_concat_sparse_conv_apply": ("B7f", "shared", 1091),
}


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _agreement(a, b) -> float:
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a == b).mean())


def _time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_turns(torch, fns: dict, iters: dict) -> dict:
    """Time each callable in turns (a, b, ..., ..., b, a): name -> [ms, ms]."""
    order = list(fns) + list(fns)[::-1]
    out = {name: [] for name in fns}
    for name in order:
        out[name].append(_time_ms(torch, fns[name], iters[name]))
    return out


def _lane_rate(torch) -> tuple[float, float]:
    """(f32 lane instructions per second, max SM clock in MHz) of card 0:
    its SMs x 128 f32 lanes x the max SM clock ``nvidia-smi`` reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 128 * mhz * 1e6, mhz


def _b1_instructions(a, b) -> tuple[float, float]:
    """B1's f32 instructions per output pixel and class with phase weights
    (a, b): (issued, of which on the half-rate compare/select pipe).

    B1 rounds every multiply and add on its own (its ids are bit-equal to the
    plain version), so its work is instructions, not FLOPs at the FMA rate.
    Each pass (rows, then columns) makes one value per output pixel from two
    products and an add.  An input value meets the 16 weights a[0..7],
    b[0..7] across the 3 bands or columns it feeds; when a[q] == b[7-q] (the
    bilinear kernel) those are 8 distinct products, so the pass needs 1
    multiply and 1 add per value, else 2 and 1.  The row pass's values are
    shared by the 8 output columns of an input column.  The argmax is a
    compare and two selects, which issue at half the f32 rate."""
    products = 1 if (a == b[::-1]).all() else 2
    return (products + 1) * (1 + 1 / 8) + 3, 3


def _b1_bound(shape, itemsize: int, a, b, lane_rate: float) -> tuple[float, str, dict]:
    """(ms, what bounds it, each floor in ms) of B1 on (N, h, w, C) logits:
    the largest of the bytes (logits read once, ids written once) over the
    memory rate, the issued instructions over ``lane_rate`` (one a lane and
    clock) and the compare/select pipe's instructions over half of it."""
    n, h, w, c = shape
    pixel_classes = 64 * n * h * w * c
    issued, half_rate = _b1_instructions(a, b)
    parts = {"bytes_ms": (n * h * w * c * itemsize + 64 * n * h * w) / PEAK_BYTES_S * 1e3,
             "issue_ms": pixel_classes * issued / lane_rate * 1e3,
             "compare_select_ms": pixel_classes * half_rate * 2 / lane_rate * 1e3}
    ms = max(parts.values())
    return ms, "bytes" if ms == parts["bytes_ms"] else "operations", parts


def _bound(nbytes: float, ops: float, peak: str) -> tuple[float, str]:
    """(ms, what bounds it): the larger of bytes / memory rate and
    operations / the peak of their type."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _live_tiles(vals) -> int:
    """Nonzero 128x128 weight tiles of a packing's ``vals`` (every packing
    stacks its tiles as 128-row slices of a (..., 128) tensor)."""
    return int((vals.reshape(-1, 128 * 128) != 0).any(1).sum())


def _live_in_blocks(vals, rows) -> int:
    """The 128-channel in-blocks that some nonzero tile of a B2-layout
    packing reads: ``rows`` (nmb, S) names each slot's in-block, ``vals``
    (nmb, T*S*128, 128) holds T tiles per slot.  Only these blocks of x
    enter the function, so a bound counts only their bytes."""
    nmb, s = rows.shape
    live = (vals.reshape(nmb, -1, s, 128 * 128) != 0).any(-1).any(1)  # (nmb, S)
    return len(set(rows[live].tolist()))


def _b2_bound(pixels: int, vals, rows, out_channels: int) -> tuple[float, str]:
    """Bound of B2's function on a bf16 packing over ``pixels`` output
    pixels: the bf16 x of the in-blocks live tiles read, the live tiles and
    ``rows`` read once, the f32 y written once; 2*128*128 operations per
    live tile and pixel."""
    live = _live_tiles(vals)
    return _bound(pixels * _live_in_blocks(vals, rows) * 128 * 2 + live * 128 * 128 * 2
                  + rows.numel() * 4 + pixels * out_channels * 4,
                  2 * pixels * live * 128 * 128, "bf16")


def _close(torch, np, phase, got, want, k_len, **info) -> float:
    """Raise unless ``got`` is within 2*K*eps of ``want`` relative to
    max|want| (never looser than 1e-3), K the contraction length: two f32
    sums of the same exact products in other orders.  Returns the max abs
    error."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32, (
        got.shape, want.shape, got.dtype, want.dtype)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    tol = min(1e-3, 2 * k_len * float(np.finfo(np.float32).eps))
    rel = err / scale if scale > 0 else err
    _emit(phase=phase, max_abs_err=err, rel_err=rel, tol_rel=tol, max_abs_want=scale, **info)
    if (scale == 0 and err != 0) or rel > tol:
        raise AssertionError(f"{phase}: kernel differs from its plain version: {rel} > {tol} "
                             f"({info})")
    return err


def _b2_mask(rng, k, cin, cout, s, dead_out=False):
    """OIHW 0/1 mask: every out-block keeps s random in-blocks (the last
    one none with ``dead_out``); per-tap holes keep the union at s."""
    import numpy as np

    nkb, nmb = cin // 128, cout // 128
    m = np.zeros((cout, cin, k, k), np.float32)
    for j in range(nmb - 1 if dead_out else nmb):
        for kb in rng.choice(nkb, size=s, replace=False):
            taps = rng.random(k * k) < 0.8
            taps[0] = True
            m[j * 128:(j + 1) * 128, kb * 128:(kb + 1) * 128] = taps.reshape(k, k)
    return m


def _b2_vs_plain(torch, np, dev, rng, served: dict, folded: dict) -> float:
    """Phase 6: B2 on the card vs its plain version on the same inputs: the
    CPU tests' shapes and kinds, then every B2 plan of ``served`` (the
    FusedSparseConv plans and each CompactSparse's inner plan) at its
    batch-32 serving input, and on each the served bf16+bias route
    (``models/drn.py``, ``folded``'s bias) bit-equal to the two passes."""
    from tpuseg_torch.models import drn as tdrn
    from tpuseg_torch.models.sparse_exec import CompactSparse
    from tpuseg_torch.ops.sparse_conv import (
        FusedSparseConv, fused_sparse_conv_apply, fused_sparse_conv_reference,
        plan_fused_sparse_conv)

    eps = float(np.finfo(np.float32).eps)
    worst = 0.0

    def check(x, plan, case):
        nonlocal worst
        got = fused_sparse_conv_apply(x, plan)
        want = fused_sparse_conv_reference(x, plan)
        torch.cuda.synchronize()
        shape = tuple(x.shape[:3])
        assert got.shape == want.shape == shape + (plan.cout,) and got.dtype == torch.float32
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        K = plan.kernel * plan.kernel * plan.s * 128
        # f32 sums of K exact products in two orders: bounded by ~K*eps
        # relative to the output scale; never looser than 1e-3
        tol = min(1e-3, 2 * K * eps)
        rel = err / scale if scale > 0 else err
        worst = max(worst, err)
        _emit(phase="b2_vs_plain", shape=list(x.shape), k=plan.kernel, dilation=plan.dilation,
              cout=plan.cout, s=plan.s, plan_dtype=str(plan.vals.dtype), case=case,
              max_abs_err=err, rel_err=rel, tol_rel=tol, max_abs_want=scale)
        if (scale == 0 and err != 0) or rel > tol:
            raise AssertionError(f"B2 differs from its plain version: {rel} > {tol} "
                                 f"at {list(x.shape)} k={plan.kernel} d={plan.dilation} "
                                 f"S={plan.s} {plan.vals.dtype} ({case})")

    cases = [  # (x shape without C, k, dilation, cin, cout, S, kind)
        ((1, 17, 33), 3, 1, 384, 256, 3, ""),
        ((1, 17, 33), 3, 2, 384, 256, 2, ""),
        ((2, 8, 12), 3, 4, 256, 256, 1, ""),
        ((1, 9, 20), 1, 1, 512, 256, 2, "1x1"),
        ((1, 6, 10), 3, 1, 384, 128, 3, ""),
        ((2, 64, 128), 3, 2, 512, 512, 2, "S=2, dead out-block"),
        ((1, 16, 24), 3, 2, 256, 256, 1, "all-zero plan"),
    ]
    for shape, k, d, cin, cout, s, kind in cases:
        w = (rng.normal(size=(cout, cin, k, k)) * 0.05).astype(np.float32)
        m = _b2_mask(rng, k, cin, cout, s, dead_out="dead" in kind)
        if kind == "all-zero plan":
            m[:] = 0
        for dtype in (torch.float32, torch.bfloat16):
            plan = plan_fused_sparse_conv(w, m, dilation=d, dtype=dtype).to(dev)
            x = torch.from_numpy(rng.normal(size=shape + (cin,)).astype(np.float32)).to(dev, dtype)
            check(x, plan, kind)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, h, w = SERVING_SPARSE[0][:3]
    served_b2 = 0
    for name, p in served.items():
        plan = p.inner if isinstance(p, CompactSparse) else p
        if not isinstance(plan, FusedSparseConv):
            continue
        plan = plan.to(dev)
        x = torch.randn((n, h, w, plan.cin), generator=gen, device=dev, dtype=plan.vals.dtype)
        check(x, plan, f"{name} serving input"
              + (" (CompactSparse survivors)" if isinstance(p, CompactSparse) else ""))
        served_b2 += 1
        # the served bf16 route vs the two passes, on the conv's full input
        pd = p.to(dev)
        cin = folded[f"{name}.weight"].shape[1]
        x = tdrn.nhwc_to_nchw(torch.randn((n, h, w, cin), generator=gen, device=dev,
                                          dtype=torch.bfloat16))
        bias = folded[f"{name}.bias"].to(dev)
        got = tdrn._sparse_conv_bias_bf16(x, pd, bias)
        want = (tdrn._sparse_conv(x, pd, None).to(torch.bfloat16)
                + bias.to(torch.bfloat16).view(1, -1, 1, 1))
        torch.cuda.synchronize()
        mism = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        _emit(phase="b2_bf16_bias_route", conv=name, kind=type(p).__name__,
              shape=[n, h, w, cin], mismatches=mism, max_abs_want=float(want.abs().max()))
        if mism or got.shape != want.shape or got.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: the bf16+bias route differs from the two passes "
                                 f"in {mism} values")
        del x, got, want
    if served_b2 != B2_PER_FORWARD:
        raise AssertionError(f"the served config has {served_b2} B2 plans; "
                             f"want {B2_PER_FORWARD}")
    x = torch.zeros((1, plan.cin, 16, 24), device=dev,
                    dtype=torch.bfloat16).permute(0, 2, 3, 1)  # NHWC view of NCHW memory
    try:
        fused_sparse_conv_apply(x, plan)
    except ValueError:
        pass
    else:
        raise AssertionError("B2 accepted a non-contiguous NHWC view")
    return worst


def _served_w128_times(torch, dev, x, plan, qplan, bias, smi) -> None:
    """Phase 13's served routes of ``layer.6.1.conv2`` (B2's bf16+bias
    route, B3's quantize + B3 + bias) at 1024x2048 frames (x, w = 256) and
    at 512x1024 frames (w = 128), in turns.  B2 tiles R = 2 rows at w = 128;
    B3 keeps 256-pixel row segments, half of each tile past the row's end."""
    from tpuseg_torch.ops.sparse_conv import (
        b2_tile_rows, fused_sparse_conv_bias_bf16, fused_sparse_conv_q_bias_bf16)

    sn, sh, sw, sc = x.shape
    x128 = torch.randn((sn, sh // 2, sw // 2, sc), device=dev).to(torch.bfloat16)
    turns = _time_turns(torch, {
        "b2_route_w256": lambda: fused_sparse_conv_bias_bf16(x, plan, bias),
        "b2_route_w128": lambda: fused_sparse_conv_bias_bf16(x128, plan, bias),
        "b3_served_w256": lambda: fused_sparse_conv_q_bias_bf16(x, qplan, bias),
        "b3_served_w128": lambda: fused_sparse_conv_q_bias_bf16(x128, qplan, bias),
    }, dict.fromkeys(("b2_route_w256", "b2_route_w128", "b3_served_w256", "b3_served_w128"),
                     10))
    _emit(phase="served_w128_time", conv="layer.6.1.conv2", shape_w256=[sn, sh, sw, sc],
          shape_w128=list(x128.shape), b2_rows_per_tile={"w256": b2_tile_rows(sw, sh),
                                                         "w128": b2_tile_rows(sw // 2, sh // 2)},
          ms=turns, w128_over_w256={k: min(turns[f"{k}_w128"]) / min(turns[f"{k}_w256"])
                                    for k in ("b2_route", "b3_served")}, card=smi)


QUANTIZE_MAPS = ("contiguous", "all_padding", "gathered", "mixed")  # phase 10's map kinds


def _quantize_maps(torch, np, rng) -> dict:
    """Phase 10's channel maps of x's 384 channels, one of each descriptor
    kind and one mixing all three: whole 128-channel blocks (as
    ``CompactSparseQ`` gathers), -1s only, a random gather, and contiguous
    + gathered + padding vectors (``channel_map_vectors``)."""
    mixed = np.r_[np.arange(8, 24), [5, 3, 1, 300, 2, 7, 9, 11], -np.ones(8, np.int64),
                  [-1, 3, 4, 5, 6, 7, 8, 9], np.arange(376, 384)]
    maps = {"contiguous": np.r_[np.arange(128), np.arange(256, 384)],
            "all_padding": -np.ones(64, np.int64),
            "gathered": rng.permutation(384)[:96],
            "mixed": mixed}
    return {k: torch.from_numpy(np.asarray(v)).to(torch.int32) for k, v in maps.items()}


def _quantize_vs_cpu(torch, np, dev, rng) -> float:
    """Phase 10: the quantize kernels (``quantize_activation`` on the card)
    vs ``quantize_activation`` on the CPU, bit for bit on xq and xs: bf16
    and f32, per-frame and static, a frame of 40x the range and an all-zero
    frame, unmapped and through each kind of channel map
    (``_quantize_maps``: contiguous, all-padding, gathered and mixed
    vectors, read through the map's ``channel_map_vectors``); a frame
    holding a NaN must get a NaN scale on both sides (its xq is not
    compared: PyTorch's cast of a NaN to int8 is undefined; an all-padding
    map never reads it).  -> the max |difference| of xq (0)."""
    from tpuseg_torch.ops.sparse_conv import channel_map_vectors, quantize_activation

    x = torch.from_numpy(rng.normal(size=(4, 32, 48, 384)).astype(np.float32))
    x[1] *= 40.0
    x[2] = 0.0
    x[3, 7, 9, 300] = float("nan")
    maps = {"none": None, **_quantize_maps(torch, np, rng)}
    worst = 0
    for dtype in (torch.float32, torch.bfloat16):
        for x_scale in (None, 0.013):
            for kind, cmap in maps.items():
                xd = x.to(dev, dtype)
                cd = None if cmap is None else cmap.to(dev)
                vecs = None if cmap is None else channel_map_vectors(cd)
                before = (quantize_activation.launches, quantize_activation.absmax_launches,
                          quantize_activation.map_launches)
                xq_d, xs_d = quantize_activation(xd, x_scale, cd, vecs=vecs)
                torch.cuda.synchronize()
                launched = (quantize_activation.launches - before[0],
                            quantize_activation.absmax_launches - before[1],
                            quantize_activation.map_launches - before[2])
                xq_c, xs_c = quantize_activation(x.to(dtype), x_scale, cmap)
                xq_d, xs_d = xq_d.cpu(), xs_d.cpu()
                nan_read = kind != "all_padding" and (cmap is None or bool((cmap == 300).any()))
                same = torch.equal(xq_d[:3], xq_c[:3]) and torch.equal(xs_d[:3], xs_c[:3])
                if x_scale is not None or not nan_read:
                    same = same and torch.equal(xs_d[3], xs_c[3])
                    if not nan_read:
                        same = same and torch.equal(xq_d[3], xq_c[3])
                else:
                    same = same and bool(xs_d[3].isnan()) and bool(xs_c[3].isnan())
                err = int((xq_d[:3].int() - xq_c[:3].int()).abs().max())
                worst = max(worst, err)
                _emit(phase="b3_quantize_pass_vs_cpu", x_dtype=str(dtype), shape=list(x.shape),
                      scale="static" if x_scale else "per-frame", channel_map=kind,
                      vectors=None if vecs is None else sorted(set(
                          min(v, 0) for v in vecs.tolist())),
                      bit_equal=same, max_abs_err=err, nan_frame_scale=float(xs_d[3]),
                      launches=launched)
                if not same:
                    raise AssertionError(f"the quantize kernels differ from the CPU "
                                         f"({dtype}, {x_scale}, map {kind})")
                if launched != (1, 0 if x_scale is not None else 1, int(cmap is not None)):
                    raise AssertionError(f"quantize launches {launched}")
    return float(worst)


NARROW_WIDTHS = (16, 32, 48, 64)
# phase 10's maps for B3's narrow route, (n, h, w): several 8x8 images a
# tile, odd maps, one 16x16 image a tile, 8-row bands, 256-pixel segments
NARROW_MAPS = ((64, 8, 8), (3, 7, 9), (2, 33, 31), (16, 16, 16), (4, 32, 32), (1, 5, 300))


def _narrow_vs_plain(torch, np, dev, rng, check) -> int:
    """Phase 10: B3's narrow route (``csrc/sparse_conv_q_narrow.cu``) on
    ``int8_packing``'s narrow packings, each held bit-equal to its plain
    version by ``check``: cin and cout in ``NARROW_WIDTHS`` with k 1 and 3
    (d 2 where k is 3 and cin = cout) on ``NARROW_MAPS`` in turn, the K =
    128 packings of 128 -> 64 and 160 -> 200, and an all-zero plan; f32 and
    bf16 x, per-frame and static scales.  -> the number of packings."""
    import dataclasses

    from tpuseg_torch.ops.quant import int8_packing, quantize_weight
    from tpuseg_torch.ops.sparse_conv import b3_narrow_tile

    cases = [(cin, cout, k) for cin in NARROW_WIDTHS for cout in NARROW_WIDTHS for k in (1, 3)]
    cases += [(128, 64, 3), (160, 200, 1), (48, 256, 3), (32, 32, 0)]  # 0: all-zero plan
    for i, (cin, cout, k) in enumerate(cases):
        n, h, w = NARROW_MAPS[i % len(NARROW_MAPS)]
        kk = k or 3
        wt = rng.normal(size=(kk, kk, cin, cout)).astype(np.float32) * (k > 0)
        wq, ws = quantize_weight(wt)
        d = 2 if kk == 3 and cin == cout else 1
        packed = int8_packing("narrow", wq, ws, d, d * (kk - 1) // 2).to(dev)
        assert packed.narrow and (k > 0) == bool(packed.nsteps.sum())
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(size=(n, h, w, cin)).astype(np.float32)).to(dev, dtype)
            static = float(x.float().abs().max()) / 127.0 * 0.8  # some values clip
            for x_scale in (None, static):
                check(x, dataclasses.replace(packed, x_scale=x_scale),
                      f"narrow K={packed.bk} N={packed.bm} tile {b3_narrow_tile(n, h, w)}"
                      + ("" if k else ", all-zero plan"))
    return len(cases)


def _b3_vs_plain(torch, np, dev, rng, served: dict) -> float:
    """Phase 10: B3 on the card vs its exact plain version on the same
    inputs, bit for bit: the CPU tests' kinds, B3's narrow route
    (``_narrow_vs_plain``), then each int8 plan the served configurations
    launch (``served``: label -> (plan, x channels)) at its batch-32 input
    (``CompactSparseQ`` through its channel map's vectors), on the f32
    route and on the served bf16+bias route (``models/drn.py``; 0
    mismatches against the plain f32 y cast and biased)."""
    from tpuseg_torch.models import drn as tdrn
    from tpuseg_torch.models.sparse_exec import CompactSparseQ
    from tpuseg_torch.ops.sparse_conv import (
        cast_bias_bf16, fused_sparse_conv_apply_q, fused_sparse_conv_q_reference,
        plan_fused_sparse_conv, quantize_fused_plan)

    worst = 0.0

    def check(x, plan, case, chan=None, vecs=None):
        nonlocal worst
        got = fused_sparse_conv_apply_q(x, plan, chan=chan, vecs=vecs)
        want = fused_sparse_conv_q_reference(
            x if chan is None else x.index_select(3, chan), plan)
        torch.cuda.synchronize()
        assert got.shape == want.shape == tuple(x.shape[:3]) + (plan.cout,)
        assert got.dtype == want.dtype == torch.float32
        mism = int((got != want).sum())
        err = float((got - want).abs().max())
        worst = max(worst, err)
        _emit(phase="b3_vs_plain", shape=list(x.shape), x_dtype=str(x.dtype), k=plan.kernel,
              dilation=plan.dilation, cin=plan.cin, cout=plan.cout, s=plan.s,
              live_steps=int(plan.nsteps.sum()), scale="static" if plan.x_scale is not None
              else "per-frame", case=case, mismatches=mism, max_abs_err=err,
              max_abs_want=float(want.abs().max()))
        if mism:
            raise AssertionError(f"B3 differs from its plain version in {mism} values at "
                                 f"{list(x.shape)} k={plan.kernel} d={plan.dilation} "
                                 f"S={plan.s} ({case})")
        return want

    cases = [  # (x shape without C, k, dilation, cin, cout, S, kind): the CPU tests' kinds
        ((1, 17, 33), 3, 1, 384, 256, 3, "odd grid"),
        ((1, 17, 33), 3, 2, 384, 256, 2, "odd grid"),
        ((2, 8, 12), 3, 4, 256, 256, 1, ""),
        ((1, 9, 20), 1, 1, 512, 256, 2, "1x1"),
        ((1, 6, 10), 3, 1, 384, 128, 3, "S=3"),
        ((2, 64, 128), 3, 2, 512, 512, 2, "S=2, dead out-block"),
        ((1, 16, 24), 3, 2, 256, 256, 1, "all-zero plan"),
    ]
    for shape, k, d, cin, cout, s, kind in cases:
        w = (rng.normal(size=(cout, cin, k, k)) * 0.05).astype(np.float32)
        m = _b2_mask(rng, k, cin, cout, s, dead_out="dead" in kind)
        if kind == "all-zero plan":
            m[:] = 0
        fplan = plan_fused_sparse_conv(w, m, dilation=d)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(size=shape + (cin,)).astype(np.float32)).to(dev, dtype)
            static = float(x.float().abs().max()) / 127.0 * 0.8  # some values clip
            for x_scale in (None, static):
                check(x, quantize_fused_plan(fplan, x_scale).to(dev), kind)
    _narrow_vs_plain(torch, np, dev, rng, check)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, h, w = SERVING_SPARSE[0][:3]
    for label, (plan, cin) in served.items():
        plan = plan.to(dev)
        if isinstance(plan, CompactSparseQ):
            packing, chan, vecs = plan.inner, plan.live_in32, plan.live_vecs
        else:
            packing, chan, vecs = getattr(plan, "packed", plan), None, None
        x = torch.randn((n, h, w, cin), generator=gen, device=dev, dtype=torch.bfloat16)
        want = check(x, packing, f"{label} serving input", chan, vecs)
        bias = torch.randn((packing.cout,), generator=gen, device=dev).to(torch.bfloat16)
        got = tdrn._sparse_conv_bias_bf16(tdrn.nhwc_to_nchw(x), plan, bias)
        got = tdrn.nchw_to_nhwc(got)
        want = cast_bias_bf16(want, bias)
        torch.cuda.synchronize()
        mism = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        _emit(phase="b3_bf16_bias_route", plan=label, kind=type(plan).__name__,
              shape=[n, h, w, cin], mismatches=mism, max_abs_want=float(want.float().abs().max()))
        if mism or got.shape != want.shape or got.dtype != torch.bfloat16:
            raise AssertionError(f"{label}: the int8 bf16+bias route differs from its plain "
                                 f"version in {mism} values")
        del x, got, want
        torch.cuda.empty_cache()
    x = torch.zeros((1, packing.cin, 16, 24), device=dev,
                    dtype=torch.bfloat16).permute(0, 2, 3, 1)  # NHWC view of NCHW memory
    try:
        fused_sparse_conv_apply_q(x, packing)
    except ValueError:
        pass
    else:
        raise AssertionError("B3 accepted a non-contiguous NHWC view")
    return worst


def _quantize_map_times(torch, dev, served: dict, smi) -> dict:
    """Phase 10: the quantize pass through each served ``CompactSparseQ``'s
    channel map (its live 128-channel blocks) at its batch-32 serving input
    (32, 128, 256, Cin) bf16, per-frame and static, against the PyTorch
    comparator (``x.index_select(-1, live)``, then the unmapped pass) and
    the bound of the function: the live channels' x read once, the int8 x
    and the scales written (as the unmapped quantize row counts it).  The map of
    ``layer.6.1.conv1`` (the main row) also against the plain version.
    -> {label: row}."""
    from tpuseg_torch.models.sparse_exec import CompactSparseQ
    from tpuseg_torch.ops.sparse_conv import (
        quantize_activation, quantize_activation_reference, select_channels)

    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    n, h, w = SERVING_SPARSE[0][:3]
    rows = {}
    for label, (plan, cin) in served.items():
        if not isinstance(plan, CompactSparseQ):
            continue
        plan = plan.to(dev)
        chan, vecs, live = plan.live_in32, plan.live_vecs, plan.live_in
        x = torch.randn((n, h, w, cin), generator=gen, device=dev, dtype=torch.bfloat16)
        fns = {"per_frame": lambda: quantize_activation(x, None, chan, vecs=vecs),
               "static": lambda: quantize_activation(x, 0.013, chan, vecs=vecs),
               "index_select_then_pass": lambda: quantize_activation(
                   x.index_select(3, live), None)}
        iters = {"per_frame": 10, "static": 10, "index_select_then_pass": 10}
        main = label.startswith(QUANTIZE_MAP_MAIN)
        if main:
            fns["plain"] = lambda: quantize_activation_reference(select_channels(x, chan), None)
            iters["plain"] = 2
        turns = _time_turns(torch, fns, iters)
        live_el = n * h * w * chan.numel()
        bound = _bound(live_el * 2 + live_el + n * 4, live_el, "f32")
        row = {"ms": min(turns["per_frame"]), "static_ms": min(turns["static"]),
               "library_ms": min(turns["index_select_then_pass"]), "bound_ms": bound[0],
               "bound_by": bound[1],
               "plain_ms": min(turns["plain"]) if main else None,
               "live_channels": chan.numel(), "vectors": sorted(set(
                   min(v, 0) for v in vecs.tolist()))}
        rows[label] = row
        _emit(phase="quantize_map_time", plan=label, shape=[n, h, w, cin], turns=turns, **row,
              bound_share=bound[0] / row["ms"], static_bound_share=bound[0] / row["static_ms"],
              card=smi)
        del x
    torch.cuda.empty_cache()
    return rows


def _served_b3_plans(dense_plans: dict, pallas_plans: dict, gathered_plans: dict,
                     folded: dict) -> dict:
    """label -> (int8 plan, its input's channels) for every B3 plan the
    served int8 configurations launch: the 13 dense ``QuantConv``s, the 7
    lifted B2 plans of the Pallas lowering (3 ``FusedSparseConvQ``, 4
    ``CompactSparseQ`` whose channel map gathers the survivors), and the
    ``GatheredGroupConvQ`` of layer.6.1.conv2."""
    from tpuseg_torch.models.sparse_exec import quantize_sparse_plans
    from tpuseg_torch.ops.gathered_conv import GatheredGroupConvQ

    def cin(name):
        return folded[f"{name}.weight"].shape[1]

    out = {f"{n} QuantConv": (p, cin(n)) for n, p in dense_plans.items()}
    for n, p in quantize_sparse_plans(pallas_plans).items():
        if type(p).__name__ in ("FusedSparseConvQ", "CompactSparseQ"):
            out[f"{n} {type(p).__name__}"] = (p, cin(n))
    g = quantize_sparse_plans({"layer.6.1.conv2": gathered_plans["layer.6.1.conv2"]})
    assert isinstance(g["layer.6.1.conv2"], GatheredGroupConvQ)
    out["layer.6.1.conv2 GatheredGroupConvQ"] = (g["layer.6.1.conv2"], cin("layer.6.1.conv2"))
    want = B3_PER_FORWARD["dense"] + B2_PER_FORWARD + 1
    if len(out) != want:
        raise AssertionError(f"{len(out)} served B3 plans; want {want}")
    return out


class _Recorder:
    """An int8 plan that records each input and output of the plan it wraps
    (the dispatch runs any plan with ``.apply``)."""

    def __init__(self, plan, log: list):
        self.plan, self.log = plan, log

    def apply(self, x):
        from tpuseg_torch.ops.sparse_conv import FusedSparseConvQ, fused_sparse_conv_apply_q

        if isinstance(self.plan, FusedSparseConvQ):
            y = fused_sparse_conv_apply_q(x, self.plan)
        else:
            y = self.plan.apply(x)
        self.log.append((x.clone(), y.clone()))
        return y


def _int8_parity_f32(torch, np, variants: dict, state, spec, small) -> None:
    """Phase 11: for each (params, float plans) variant, int8 f32 serving on
    the card (TF32 off) and on the CPU.  Every int8 conv's CUDA output must
    equal, bit for bit, the CPU plain version run on the activation the CUDA
    run gave that conv; the ids must agree >= INT8_PARITY_MIN."""
    from tpuseg_torch.ops.sparse_conv import FusedSparseConvQ, fused_sparse_conv_apply_q
    from tpuseg_torch.video.pipeline import VideoSegmenter

    for label, (params, plans) in variants.items():
        segs, ids = {}, {}
        logs: dict = {}
        for name in ("cuda", "cpu"):
            seg = VideoSegmenter(params, state, spec, MEAN, STD, device=name,
                                 compute_dtype=torch.float32, batch=2, exec_plans=plans,
                                 quantize=True)
            if name == "cuda":
                for conv, p in list(seg.exec_plans.items()):
                    if type(p).__name__ != "RbgpPlan":
                        logs[conv] = []
                        seg.exec_plans[conv] = _Recorder(p, logs[conv])
            segs[name] = seg
            ids[name] = seg.run(small, need_color=False)["ids"]
        agree = _agreement(ids["cuda"], ids["cpu"])
        checked = 0
        for conv, log in logs.items():
            plan = segs["cpu"].exec_plans[conv]
            for x, y in log:
                xc = x.cpu()
                want = (fused_sparse_conv_apply_q(xc, plan) if isinstance(plan, FusedSparseConvQ)
                        else plan.apply(xc))
                if not torch.equal(y.cpu(), want):
                    raise AssertionError(f"int8 conv {conv} ({label}): CUDA output differs from "
                                         "the CPU plain version on the same activation")
                checked += 1
        _emit(phase="int8_parity_f32", variant=label, tf32=False, size=list(small[0].shape[:2]),
              frames=len(small), int8_convs=len(logs), conv_calls_bit_equal=checked,
              ids_agreement=agree, limit=INT8_PARITY_MIN)
        if not logs or checked < len(logs):
            raise AssertionError(f"{label}: {checked} int8 conv calls recorded for {len(logs)} convs")
        if agree < INT8_PARITY_MIN:
            raise AssertionError(f"int8 f32 CUDA vs CPU ids agreement {agree} < {INT8_PARITY_MIN}")


def _pruned(torch, params, state, spec, config, lowering, dtype):
    """Masked params and sparse plans for ``config`` (masker seed 0)."""
    from tpuseg_torch.models.sparse_exec import build_sparse_plans
    from tpuseg_torch.ops.fold_bn import fold_bn
    from tpuseg_torch.sparsity import apply_masks, create_masker

    masks = create_masker(config, seed=0).generate_masks(params)
    masked = apply_masks(params, masks)
    plans, report = build_sparse_plans(fold_bn(masked, state, spec), masks, spec,
                                       lowering=lowering, dtype=dtype)
    return masked, plans, report


def _bench_problem(torch, dev, smi):
    """The bench's problem: (3x3 OIHW weight, 1x1 OIHW weight, x (1, 128,
    256, 512) bf16 on the card), drawn as ``tpuseg_torch.bench_sparse``
    draws them."""
    from tpuseg_torch import bench_sparse

    rng, w, x = bench_sparse.Bench(dev, smi).problem()
    return w, bench_sparse.conv1x1_weight(rng), x


def _matrix_mask(np, rng, shape, sparsity=0.875):
    """A (rows, cols) weight and its BlockPruner 128x128 mask."""
    from tpuseg_torch.sparsity.block import BlockConfig, prune_as_block

    w = (rng.normal(size=shape) * 0.05).astype(np.float32)
    return w, prune_as_block(w, BlockConfig(sparsity, 128, 128, -1, -1, True))


def _b4_vs_plain(torch, np, dev, rng, smi) -> float:
    """Phase 14: B4 and sparse_conv_apply vs their plain versions."""
    from tpuseg_torch import bench_sparse
    from tpuseg_torch.ops import sparse_conv as sc

    worst = 0.0

    def check(x, packed, case):
        nonlocal worst
        got, want = sc.bsr_matmul_xw(x, packed), sc.bsr_matmul_xw_reference(x, packed)
        worst = max(worst, _close(torch, np, "b4_vs_plain", got, want, packed.s * 128,
                                  case=case, shape=list(x.shape), dtype=str(x.dtype)))

    def block_w(K, M, density, dead_col=False):
        nz = (rng.random((K // 128, M // 128)) < density).astype(np.float32)
        nz[0] = 1
        if dead_col:
            nz[:, 1] = 0
        return rng.normal(size=(K, M)).astype(np.float32) * np.kron(
            nz, np.ones((128, 128), np.float32))

    cases = [  # (P, K, M, density, kind): the CPU tests' kinds
        (256, 256, 384, 0.4, ""), (200, 256, 384, 0.4, "ragged P"),
        (384, 512, 256, 0.5, ""), (300, 384, 512, 0.5, "dead column"),
        (130, 384, 512, 0.0, "all-zero W"), (257, 384, 512, 1.0, "full support"),
    ]
    for P, K, M, density, kind in cases:
        wkm = block_w(K, M, density, dead_col=kind == "dead column")
        if kind == "all-zero W":
            wkm[:] = 0
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(size=(P, K)).astype(np.float32)).to(dev, dtype)
            check(x, sc.pack_xw_bsr(wkm, dtype).to(dev), kind)
    w2, m2 = _matrix_mask(np, rng, (512, 512))
    packed = sc.pack_xw_bsr(w2 * m2).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for P in (32768, P32):
        x = torch.randn((P, 512), generator=gen, device=dev, dtype=torch.bfloat16)
        check(x, packed, "BlockPruner 87.5 %")
    del x
    # sparse_conv_apply: the CPU tests' cases, then the bench's conv
    for (k, d), dtype in [((1, 1), torch.float32), ((3, 1), torch.float32),
                          ((3, 2), torch.float32), ((3, 2), torch.bfloat16)]:
        wk = rng.normal(size=(256, 256, k, k)).astype(np.float32)
        mk = np.broadcast_to(np.kron(np.array([[1, 1], [0, 1]], np.float32),
                                     np.ones((128, 128), np.float32))[:, :, None, None],
                             wk.shape).copy()
        plan = sc.plan_sparse_conv(wk, mk, dtype=dtype).to(dev)
        x = torch.from_numpy(rng.normal(size=(1, 8, 16, 256)).astype(np.float32)).to(dev, dtype)
        _close(torch, np, "sparse_conv_apply_vs_plain", sc.sparse_conv_apply(x, plan, d),
               sc.sparse_conv_reference(x, plan, d), sum(t[2].s for t in plan.taps) * 128,
               k=k, dilation=d, dtype=str(dtype), shape=list(x.shape))

    def check_conv(x, plan, dilation, case):
        torch.cuda.synchronize()
        sc.bsr_matmul_xw.launches = 0
        got = sc.sparse_conv_apply(x, plan, dilation=dilation)
        torch.cuda.synchronize()
        launches = sc.bsr_matmul_xw.launches
        _close(torch, np, "sparse_conv_apply_vs_plain", got,
               sc.sparse_conv_reference(x, plan, dilation),
               sum(t[2].s for t in plan.taps) * 128, k=plan.kernel, dilation=dilation,
               dtype="torch.bfloat16", shape=list(x.shape), density=plan.density,
               dense_taps=sum(t[3] for t in plan.taps), b4_launches=launches, case=case)
        if launches != len(plan.taps):
            raise AssertionError(f"sparse_conv_apply launched B4 {launches} times for "
                                 f"{len(plan.taps)} taps")

    # the bench's main mode: the 3x3 d=2 and the 1x1 conv at each sparsity,
    # batch 1; then the 3x3 at 87.5 % at batch 32
    w, w1, x1 = _bench_problem(torch, dev, smi)
    for sparsity in bench_sparse.SPARSITIES:
        for wk, d in ((w, 2), (w1, 1)):
            plan = sc.plan_sparse_conv(wk, bench_sparse.block_mask(wk, sparsity)).to(dev)
            check_conv(x1, plan, d, f"bench {wk.shape[2]}x{wk.shape[3]} {sparsity * 100} %, "
                       "batch 1")
    x = torch.randn(BENCH_BATCH32, generator=gen, device=dev, dtype=torch.bfloat16)
    check_conv(x, sc.plan_sparse_conv(w, bench_sparse.block_mask(w, 0.875)).to(dev), 2,
               "bench 3x3 87.5 %, batch 32")
    del x
    try:
        sc.bsr_matmul_xw(torch.zeros((512, 64), device=dev, dtype=torch.bfloat16).t(), packed)
    except ValueError:
        pass
    else:
        raise AssertionError("B4 accepted a non-contiguous x")
    torch.cuda.empty_cache()
    return worst


def _b56_vs_plain(torch, np, dev, rng) -> dict:
    """Phase 15: B5/B6 vs their plain version; -> entry -> max abs error."""
    from tpuseg_torch.ops import bsr

    worst = {"bsr_matmul": 0.0, "bsr_matmul_gathered": 0.0}

    def check(packed, x, case):
        want = bsr.bsr_matmul_reference(packed, x)
        for name in worst:
            got = getattr(bsr, name)(packed, x)
            worst[name] = max(worst[name], _close(
                torch, np, "b56_vs_plain", got, want, 128 * max(packed.max_nnzb_row, 1),
                entry=name, case=case, w=list(packed.shape), x=list(x.shape),
                dtype=str(x.dtype), block_density=packed.block_density))
            del got

    def kron(c):
        return np.kron(np.asarray(c, np.float32), np.ones((128, 128), np.float32))

    cases = [  # (M, K, N, coarse mask or density, kind): the CPU tests' kinds
        (256, 512, 256, 0.25, ""), (256, 512, 256, 0.5, ""), (256, 512, 256, 1.0, ""),
        (384, 384, 128, [[1, 0, 0], [1, 1, 1], [0, 1, 0]], "ragged rows"),
        (384, 512, 256, [[0, 1, 0, 1], [0, 0, 0, 0], [1, 1, 1, 0]], "empty row"),
        (256, 256, 128, [[0, 0], [0, 0]], "all-zero W"),
        (384, 384, 37, [[1, 0, 0], [1, 1, 1], [0, 1, 0]], "ragged N"),
    ]
    for M, K, N, mask, kind in cases:
        if not isinstance(mask, list):
            mask = (rng.random((M // 128, K // 128)) < mask).astype(np.float32)
            mask[:, 0] = 1
        w = rng.normal(size=(M, K)).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            packed = bsr.pack_bsr(w, kron(mask), dtype=dtype).to(dev)
            x = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(dev, dtype)
            check(packed, x, kind)
    w, m = _matrix_mask(np, rng, (512, 512))
    packed = bsr.pack_bsr(w, m).to(dev)
    if not (np.diff(packed.rowptr) == 0).any():
        raise AssertionError("the 87.5 % W has no empty row block")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for n in (32768, P32):
        x = torch.randn((512, n), generator=gen, device=dev, dtype=torch.bfloat16)
        check(packed, x, "BlockPruner 87.5 %, empty rows")
    del x
    torch.cuda.empty_cache()
    return worst


def _b7_vs_plain(torch, np, dev, rng, smi) -> dict:
    """Phase 16: each B7 entry point vs fused_sparse_conv_reference on the
    packing it takes; -> entry -> max abs error."""
    from tpuseg_torch import bench_sparse
    from tpuseg_torch.ops import sparse_conv as sc

    worst = {name: 0.0 for name in B7_ENTRIES}

    def check(x, plans, case):
        for packing, plan in plans.items():
            want = sc.fused_sparse_conv_reference(x, plan)
            k_len = plan.kernel * plan.kernel * plan.s * 128
            for name, (_, pk, _) in B7_ENTRIES.items():
                if pk != packing:
                    continue
                got = getattr(sc, name)(x, plan)
                worst[name] = max(worst[name], _close(
                    torch, np, "b7_vs_plain", got, want, k_len, entry=name, case=case,
                    shape=list(x.shape), dtype=str(x.dtype), s=plan.s))
                del got
            del want

    def plans(w, m, d, dtype):
        return {"shared": sc.plan_shared_sparse_conv(w, m, d, dtype).to(dev),
                "fused": sc.plan_fused_sparse_conv(w, m, d, dtype).to(dev)}

    def kron_mask(nz, k, cout, cin):
        m2 = np.kron(np.asarray(nz, np.float32).T, np.ones((128, 128), np.float32))
        return np.broadcast_to(m2[:, :, None, None], (cout, cin, k, k)).copy()

    # the CPU tests' kinds: test_sparse_conv.py's mask at d = 1, 2; an odd
    # grid with a per-tap hole and a dead out-block
    w = rng.normal(size=(256, 512, 3, 3)).astype(np.float32)
    m = kron_mask([[0, 1], [1, 0], [0, 0], [0, 1]], 3, 256, 512)
    for d in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(size=(2, 8, 16, 512)).astype(np.float32)).to(dev, dtype)
            check(x, plans(w, m, d, dtype), f"d={d}")
    w = (rng.normal(size=(384, 384, 3, 3)) * 0.1).astype(np.float32)
    m = kron_mask([[1, 0, 0], [0, 0, 0], [1, 1, 0]], 3, 384, 384)
    m[:128, :, 0, 1] = 0
    x = torch.from_numpy(rng.normal(size=(2, 7, 10, 384)).astype(np.float32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        check(x.to(dtype), plans(w, m, 2, dtype), "odd grid, per-tap hole, dead out-block")
    # the bench's conv at batch 1 on every plan bench_fused launches (each
    # sparsity, and the shared plan of an all-ones mask), then at batch 32
    w, _, x1 = _bench_problem(torch, dev, smi)
    bench_plans = {sparsity: plans(w, bench_sparse.block_mask(w, sparsity), 2, torch.bfloat16)
                   for sparsity in bench_sparse.SPARSITIES}
    for sparsity, p in bench_plans.items():
        check(x1, p, f"bench {sparsity * 100} %, batch 1")
    check(x1, {"shared": sc.plan_shared_sparse_conv(w, np.ones_like(w), 2).to(dev)},
          "bench all-ones mask, batch 1")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn(BENCH_BATCH32, generator=gen, device=dev, dtype=torch.bfloat16)
    check(x, bench_plans[0.875], "bench 87.5 %, batch 32")
    del x
    torch.cuda.empty_cache()
    return worst


def _slice4_paths(torch, dev) -> dict:
    """Phase 17: this slice's paths, every launch count zeroed just before
    and read just after: the bench's main and fused modes
    (``tpuseg_torch.bench_sparse.main(["--fused"])``), then one call each of
    ``bsr_matmul`` and ``bsr_matmul_gathered`` at the batch-32 shape.
    -> entry -> launches."""
    import numpy as np

    from tpuseg_torch import bench_sparse
    from tpuseg_torch.ops import bsr
    from tpuseg_torch.ops import sparse_conv as sc

    bench_entries = [sc.bsr_matmul_xw, sc.fused_sparse_conv_apply, sc.fused_sparse_conv_apply_q,
                     *(getattr(sc, name) for name in B7_ENTRIES)]
    torch.cuda.synchronize()
    for e in bench_entries:
        e.launches = 0
    t0 = time.perf_counter()
    rc = bench_sparse.main(["--fused"])
    torch.cuda.synchronize()
    launches = {e.__name__: e.launches for e in bench_entries}
    bench_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"bench_sparse --fused returned {rc}")
    # per timed function: one untimed and three timed loops of INNER calls
    calls = 4 * bench_sparse.INNER
    n_sp = len(bench_sparse.SPARSITIES)
    want = {name: calls * n_sp for name in launches}
    want["bsr_matmul_xw"] = calls * n_sp * (1 + bench_sparse.K * bench_sparse.K)  # a launch per tap
    want["phase_sparse_conv_apply"] += calls  # the density-1.0 probe
    _emit(phase="slice4_bench_path", command="python -m tpuseg_torch.bench_sparse --fused",
          seconds=round(bench_s, 3), launches=launches, want=want)
    if launches != want:
        raise AssertionError(f"bench launches {launches}; want {want}")
    rng = np.random.default_rng(4)
    w, m = _matrix_mask(np, rng, (512, 512))
    packed = bsr.pack_bsr(w, m).to(dev)
    x = torch.randn((512, P32), device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    bsr.bsr_matmul.launches = bsr.bsr_matmul_gathered.launches = 0
    y5 = bsr.bsr_matmul(packed, x)
    y6 = bsr.bsr_matmul_gathered(packed, x)
    torch.cuda.synchronize()
    launches.update(bsr_matmul=bsr.bsr_matmul.launches,
                    bsr_matmul_gathered=bsr.bsr_matmul_gathered.launches)
    ok = bool(torch.isfinite(y5).all()) and torch.equal(y5, y6) and y5.shape == (512, P32)
    _emit(phase="slice4_bsr_path", w=[512, 512], x=[512, P32], finite_and_equal=ok,
          launches={k: launches[k] for k in ("bsr_matmul", "bsr_matmul_gathered")})
    if not ok or launches["bsr_matmul"] != 1 or launches["bsr_matmul_gathered"] != 1:
        raise AssertionError("bsr_matmul / bsr_matmul_gathered path failed")
    del x, y5, y6
    torch.cuda.empty_cache()
    return launches


def _slice4_times(torch, np, dev, smi) -> dict:
    """Phase 18: B4, B5, B6 and B7a-f at their batch-32 shapes, in turns
    (plain, kernels, library, library, kernels, plain), with each one's
    bound.  -> kernel name -> {ms, plain_ms, library_ms, bound_ms, bound_by}."""
    import torch.nn.functional as F

    from tpuseg_torch import bench_sparse
    from tpuseg_torch.ops import bsr
    from tpuseg_torch.ops import sparse_conv as sc

    out = {}
    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    # B4 and sparse_conv_apply
    w2, m2 = _matrix_mask(np, rng, (512, 512))
    packed = sc.pack_xw_bsr(w2 * m2).to(dev)
    wd = torch.from_numpy(w2 * m2).to(dev, torch.bfloat16)
    x = torch.randn((P32, 512), generator=gen, device=dev, dtype=torch.bfloat16)
    turns = _time_turns(torch, {
        "plain": lambda: sc.bsr_matmul_xw_reference(x, packed),
        "kernel": lambda: sc.bsr_matmul_xw(x, packed),
        "library": lambda: torch.mm(x, wd, out_dtype=torch.float32),
        "library_bf16_out": lambda: torch.matmul(x, wd),
    }, {"plain": 2, "kernel": 10, "library": 10, "library_bf16_out": 10})
    out["bsr_matmul_xw"] = {
        "ms": min(turns["kernel"]), "plain_ms": min(turns["plain"]),
        "library_ms": min(turns["library"]), "library_bf16_out_ms": min(turns["library_bf16_out"]),
        **dict(zip(("bound_ms", "bound_by"), _b2_bound(P32, packed.vals, packed.rows, 512)))}
    _emit(phase="b4_time", x=list(x.shape), w="512x512 BlockPruner 87.5 %", s=packed.s,
          live_tiles=_live_tiles(packed.vals),
          live_in_blocks=_live_in_blocks(packed.vals, packed.rows), turns=turns,
          **out["bsr_matmul_xw"], card=smi)
    del x
    # B5 and B6
    bpacked = bsr.pack_bsr(w2, m2).to(dev)
    wdm = torch.from_numpy(w2 * m2).to(dev, torch.bfloat16)
    x = torch.randn((512, P32), generator=gen, device=dev, dtype=torch.bfloat16)
    turns = _time_turns(torch, {
        "plain": lambda: bsr.bsr_matmul_reference(bpacked, x),
        "bsr_matmul": lambda: bsr.bsr_matmul(bpacked, x),
        "bsr_matmul_gathered": lambda: bsr.bsr_matmul_gathered(bpacked, x),
        "library": lambda: torch.mm(wdm, x, out_dtype=torch.float32),
        "library_bf16_out": lambda: torch.matmul(wdm, x),
    }, {"plain": 2, "bsr_matmul": 10, "bsr_matmul_gathered": 10, "library": 10,
        "library_bf16_out": 10})
    # the x rows of the K-blocks that live tiles read, the live tiles, the
    # CSR and the f32 y
    live = (bpacked.vals.reshape(len(bpacked.colidx), -1) != 0).any(1).cpu().numpy()
    b56_in_blocks = len(set(bpacked.colidx[live].tolist()))
    b56 = dict(zip(("bound_ms", "bound_by"), _bound(
        b56_in_blocks * 128 * P32 * 2 + int(live.sum()) * 128 * 128 * 2
        + (bpacked.nrb + 1 + len(bpacked.colidx)) * 4 + 512 * P32 * 4,
        2 * P32 * int(live.sum()) * 128 * 128, "bf16")))
    for name in ("bsr_matmul", "bsr_matmul_gathered"):
        out[name] = {"ms": min(turns[name]), "plain_ms": min(turns["plain"]),
                     "library_ms": min(turns["library"]),
                     "library_bf16_out_ms": min(turns["library_bf16_out"]), **b56}
    _emit(phase="b56_time", w="512x512 BlockPruner 87.5 %", x=list(x.shape),
          nnzb=len(bpacked.colidx), live_in_blocks=b56_in_blocks, turns=turns, **b56,
          card=smi)
    del x
    torch.cuda.empty_cache()
    # B7a-f and sparse_conv_apply at the bench's conv, batch 32
    w, _, _ = _bench_problem(torch, dev, smi)
    m = bench_sparse.block_mask(w, 0.875)
    plans = {"shared": sc.plan_shared_sparse_conv(w, m, 2).to(dev),
             "fused": sc.plan_fused_sparse_conv(w, m, 2).to(dev)}
    tplan = sc.plan_sparse_conv(w, m).to(dev)
    wconv = torch.from_numpy(w * m).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    x = torch.randn(BENCH_BATCH32, generator=gen, device=dev, dtype=torch.bfloat16)
    xn = x.permute(0, 3, 1, 2)
    fns = {"plain_fused": lambda: sc.fused_sparse_conv_reference(x, plans["fused"]),
           "plain_shared": lambda: sc.fused_sparse_conv_reference(x, plans["shared"]),
           "sparse_conv_apply": lambda: sc.sparse_conv_apply(x, tplan, 2),
           "library": lambda: F.conv2d(xn, wconv, None, 1, 2, 2)}
    for name, (_, pk, _) in B7_ENTRIES.items():
        fns[name] = lambda f=getattr(sc, name), p=plans[pk]: f(x, p)
    iters = {name: 2 if name.startswith("plain") else 10 for name in fns}
    turns = _time_turns(torch, fns, iters)
    for name, (_, pk, _) in B7_ENTRIES.items():
        p = plans[pk]
        out[name] = {
            "ms": min(turns[name]), "plain_ms": min(turns[f"plain_{pk}"]),
            "library_ms": min(turns["library"]),
            **dict(zip(("bound_ms", "bound_by"), _b2_bound(P32, p.vals, p.rows, p.cout)))}
    _emit(phase="b7_time", x=list(x.shape), k=3, dilation=2, mask="BlockPruner 87.5 %",
          s={pk: p.s for pk, p in plans.items()},
          live_tiles={pk: _live_tiles(p.vals) for pk, p in plans.items()},
          live_in_blocks={pk: _live_in_blocks(p.vals, p.rows) for pk, p in plans.items()},
          union_density=plans["shared"].union_density, turns=turns,
          bounds={n: out[n]["bound_ms"] for n in B7_ENTRIES}, card=smi)
    del x, xn
    torch.cuda.empty_cache()
    return out


def _b1_cases(np, rng, sym):
    """B1's phase-2 cases: (label, logits as f32 numpy, up kernel name,
    kernel, the id every pixel must take or None)."""
    f1 = rng.random(16).astype(np.float32) + 0.1
    asym = np.outer(f1, f1).astype(np.float32)

    def normal(shape):
        return rng.normal(size=shape).astype(np.float32)

    def all_equal(shape):  # every class the same value at each pixel
        return np.repeat(normal(shape[:3] + (1,)), shape[3], axis=3)

    def two_max(shape, i, j):  # classes i and j equal and above the rest
        x = -rng.random(shape).astype(np.float32)
        x[..., i] = x[..., j] = 5 + rng.random(shape[:3]).astype(np.float32)
        return x

    return [
        ("serving width, C=19", normal((4, 128, 256, 19)), "bilinear", sym, None),
        ("w=33: a ragged chunk, odd w (8-byte stores), rows of 1,254 bytes (bf16) "
         "not 16-byte aligned", normal((2, 17, 33, 19)), "asymmetric", asym, None),
        ("C=1", normal((1, 5, 7, 1)), "bilinear", sym, None),
        ("C=255, 14 class groups", normal((1, 9, 11, 255)), "bilinear", sym, None),
        ("h=1, w=1", normal((2, 1, 1, 19)), "bilinear", sym, None),
        ("h=1, w=1, C=255", normal((1, 1, 1, 255)), "asymmetric", asym, None),
        ("w=130: a 2-column second chunk, even w", normal((1, 3, 130, 19)), "asymmetric",
         asym, None),
        ("w=130, C=255", normal((1, 3, 130, 255)), "bilinear", sym, None),
        ("w=6: a lane with 2 of its 4 columns", normal((1, 4, 6, 19)), "bilinear", sym, None),
        ("tie: all classes equal, C=19", all_equal((2, 9, 130, 19)), "bilinear", sym, 0),
        ("tie: all classes equal, C=255", all_equal((1, 3, 5, 255)), "asymmetric", asym, 0),
        ("tie: classes 3 and 11 equal and maximal", two_max((2, 9, 130, 19), 3, 11),
         "asymmetric", asym, 3),
        ("tie: classes 30 and 200 equal and maximal (other groups)",
         two_max((1, 5, 7, 255), 30, 200), "bilinear", sym, 30),
        ("tall: 8h = 65,600 > 65,535", normal((1, 8200, 2, 19)), "bilinear", sym, None),
    ]


def _b1_vs_plain(torch, np, dev, rng, sym) -> int:
    """B1 (``upsample_argmax``) vs ``upsample_argmax_reference`` on the card,
    bit-equal ids, on each case of ``_b1_cases`` in f32 and bf16 logits.
    Returns the max abs id error (0)."""
    from tpuseg_torch.ops.upsample import upsample_argmax, upsample_argmax_reference

    max_abs_err = 0
    for label, x_np, kname, k, want_id in _b1_cases(np, rng, sym):
        shape = x_np.shape
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.from_numpy(x_np).to(dev, dtype)
            got = upsample_argmax(x, k)
            want = upsample_argmax_reference(x, k)
            torch.cuda.synchronize()
            assert got.shape == want.shape == (shape[0], 8 * shape[1], 8 * shape[2])
            assert got.dtype == want.dtype == torch.uint8
            err = int((got.int() - want.int()).abs().max().item())
            mism = int((got != want).sum().item())
            max_abs_err = max(max_abs_err, err)
            tie_ok = want_id is None or bool((want == want_id).all())
            _emit(phase="kernel_vs_plain", case=label, shape=list(shape), dtype=str(dtype),
                  up_kernel=kname, mismatches=mism, max_abs_err=err,
                  **({} if want_id is None else {"tie_id": want_id, "tie_held": tie_ok}))
            if mism or not tie_ok:
                raise AssertionError(f"B1 ids differ from the plain version or the tie rule "
                                     f"at {label} {shape} {dtype}")
    return max_abs_err


B3_STEM_PER_FORWARD = 3  # the three folded stem convs under --quantize-stem
# bench.py:153-166's sparse_int8_budget8: batch 32, K = batch / 4, 64 shapes
# frames of seed 1
BUDGET_BATCH, BUDGET_K = 32, 8


def _same_bits(torch, got, want) -> int:
    """Mismatches of two f32 or bf16 tensors bit for bit, a NaN matching any
    NaN (a NaN's payload is not part of the function)."""
    iv = torch.int16 if want.dtype == torch.bfloat16 else torch.int32
    nan = want.isnan()
    return (int(((got.view(iv) != want.view(iv)) & ~nan).sum())
            + int((got.isnan() != nan).sum()))


def _record_stem(torch, log: list):
    """Patch the frontend's stem route to record each call's arguments
    (``xs`` and ``next_scale`` too) and output; returns the function that
    undoes the patch."""
    from tpuseg_torch.ops import polyphase as tpoly

    orig = tpoly.fused_sparse_conv_q_bias_relu

    def recording(x, plan, bias, out_dtype, *, xs=None, next_scale=None):
        y = orig(x, plan, bias, out_dtype, xs=xs, next_scale=next_scale)
        log.append((x.clone(), plan, bias, out_dtype, y.clone(), xs, next_scale))
        return y

    tpoly.fused_sparse_conv_q_bias_relu = recording
    return lambda: setattr(tpoly, "fused_sparse_conv_q_bias_relu", orig)


def _device_kernel_times(torch, fn) -> dict:
    """Device ms per kernel name over one call of ``fn`` (after a warm one),
    from ``torch.profiler`` (kernel names only: each also shows under the
    aten:: op that launched it)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.self_device_time_total > 0 and not e.key.startswith("aten::")}


def _profile_kernels(torch, fn) -> dict:
    """``_device_kernel_times``' 10 largest and the total."""
    times = _device_kernel_times(torch, fn)
    top = sorted(times.items(), key=lambda kv: -kv[1])[:10]
    return {"total_ms": sum(times.values()), "top": [[k[:80], v] for k, v in top]}


def _device_ms(torch, fn, calls: int = 10) -> tuple:
    """(device ms a call of ``fn`` over ``calls`` calls from ``torch.profiler``,
    or None where no profiler run recorded device activity; its largest kernels).
    One profiler run in phase 25 once recorded nothing, so up to three."""
    for _ in range(3):
        prof = _profile_kernels(torch, lambda: [fn() for _ in range(calls)])
        if prof["top"]:
            return prof["total_ms"] / calls, prof["top"]
    return None, []


def _stem_plain(x, plan, bias, dt, xs=None, next_scale=None):
    """The plain version of one call of the stem route (float x, or int8 x
    with its scales ``xs``; int8 out with ``next_scale``), 8 frames at a
    time (the function is per frame; the plain integer conv runs in f64)."""
    import torch

    from tpuseg_torch.ops import sparse_conv as tsc

    def one(i):
        xi = x[i:i + 8]
        si = None if xs is None else xs[i:i + 8]
        if next_scale is not None:
            return tsc.fused_sparse_conv_q_bias_relu_int8_out_reference(
                xi, plan, bias, dt, next_scale, xs=si)
        if xs is not None:
            return tsc.fused_sparse_conv_q_bias_relu_int8_in_reference(xi, si, plan, bias, dt)
        return tsc.fused_sparse_conv_q_bias_relu_reference(xi, plan, bias, dt)

    return torch.cat([one(i) for i in range(0, x.shape[0], 8)])


def _plain_stem_chain(torch, fe, x):
    """The int8 stem as the frontend runs it (``_stem_steps``: each conv
    handing the next its int8 x where that conv's scale is static), every
    step its plain version: NHWC x -> NHWC y."""
    xs = None
    for i, (plan, bias, next_scale) in enumerate(fe._stem_steps()):
        x = _stem_plain(x, plan, bias, fe.dtype, xs, next_scale)
        xs = None if next_scale is None else torch.full(
            (x.shape[0],), next_scale, dtype=torch.float32, device=x.device)
    return x


def _int8_stem_kernels(torch, np, dev, seg, frames_dev, smi) -> dict:
    """Phase 19: B3's stem route (``fused_sparse_conv_q_bias_relu`` on B3's
    narrow kernel, all three convs) at the inputs a bf16 batch-32 run of
    the calibrated int8-stem frontend gives them (recorded: conv0 takes the
    float x and hands conv1 its int8 x, conv1 hands conv2), each epilogue
    mode bit-equal to its plain version (run on the card 8 frames at a
    time): on each conv's float x (conv0's recorded, conv1's and conv2's
    the bf16 route's output of the conv before) relu(y + bias) as f32 and
    bf16 and the int8 hand-off from either, per-frame and static scales; on
    conv1's and conv2's recorded int8 x the same four outputs; the relu on
    -0.0 and NaN and the hand-off on -0.0, .5 ties and clamps; the whole
    stem chain, static and per frame, bit-equal to its plain chain;
    conv0's quantize pass (through its packing's map padding its 48
    channels to the narrow route's 64 with zero vectors, as the route runs
    it, and unpadded) bit-equal and timed against its bound, ``F.pad`` to
    128 channels and the plain version; then each conv's route as the
    frontend runs it (static), per frame, and static without the hand-off,
    its plain version, its bound and the cuDNN bf16 conv + bias + ReLU the
    bf16 frontend runs; the whole stem static and per frame.
    -> {"err", "convs": [...], "conv0_quantize": {...}, "stem": {...}}."""
    import copy
    import dataclasses

    import torch.nn.functional as F

    from tpuseg_torch.ops import polyphase as tpoly
    from tpuseg_torch.ops.quant import quantize_weight, stem_packing
    from tpuseg_torch.ops.sparse_conv import (
        fused_sparse_conv_q_bias_relu, quantize_activation, quantize_activation_reference,
        select_channels)

    fe = seg.stem_fn
    log = []
    undo = _record_stem(torch, log)
    try:
        with torch.inference_mode():
            fe(frames_dev)
    finally:
        undo()
    torch.cuda.synchronize()
    assert len(log) == 3, len(log)
    handed = [(e[0].dtype == torch.int8, e[6] is not None) for e in log]
    if handed != [(False, True), (True, True), (True, False)] or not all(
            e[1].narrow for e in log):
        raise AssertionError(f"the calibrated stem does not hand int8 from conv to conv on the "
                             f"narrow route: (int8 in, int8 out) {handed}")
    scales = [fe._stem_x_scale(i) for i in range(3)]
    # each conv's float x: conv0's recorded, the next ones the bf16 route's
    # output of the conv before on its float x (static scales)
    xf = [log[0][0]]
    for i in range(2):
        p = dataclasses.replace(log[i][1], x_scale=scales[i])
        xf.append(fused_sparse_conv_q_bias_relu(xf[i], p, log[i][2], torch.bfloat16))
    outs = ((torch.float32, None), (torch.bfloat16, None))

    def check(i, x, p, bias, dt, xs, next_scale, what):
        got = fused_sparse_conv_q_bias_relu(x, p, bias, dt, xs=xs, next_scale=next_scale)
        want = _stem_plain(x, p, bias, dt, xs, next_scale)
        mism = (int((got != want).sum()) if want.dtype == torch.int8
                else _same_bits(torch, got, want))
        _emit(phase="int8_stem_vs_plain", conv=i, shape=list(x.shape), x=what,
              out_dtype=str(got.dtype), rounded_to=str(dt),
              scale="per-frame" if p.x_scale is None and xs is None else "static",
              narrow=p.narrow, packing=[p.bk, p.bm, p.s], live_steps=int(p.nsteps.sum()),
              mismatches=mism)
        if mism or got.dtype != want.dtype:
            raise AssertionError(f"stem conv {i}: the stem route differs from its plain "
                                 f"version in {mism} values ({what} x, {dt}, next scale "
                                 f"{next_scale})")

    for i, (_, plan, bias, _, _, xs_rec, _) in enumerate(log):
        nxt = scales[i + 1] if i < 2 else 0.031  # conv2 hands nothing on: a stand-in scale
        for scale in (None, scales[i]):
            p = dataclasses.replace(plan, x_scale=scale)
            for dt, _ in outs:
                for next_scale in (None, nxt):
                    check(i, xf[i], p, bias, dt, None, next_scale, "float")
        if xs_rec is not None:  # conv1 and conv2: the int8 x conv i - 1 handed on
            for dt, _ in outs:
                for next_scale in (None, nxt):
                    check(i, log[i][0], plan, bias, dt, xs_rec, next_scale, "int8")
        torch.cuda.empty_cache()
    # relu on -0.0 and NaN: a negative w_scale makes float(0) * sc = -0.0,
    # a -0.0 bias keeps it, relu turns it into +0.0; a NaN bias stays NaN
    # (the float outputs) and the hand-off writes 0 for -0.0 (a NaN is
    # outside its contract); on conv1's widths (128-wide blocks sent to the
    # narrow route) and on conv0's narrow packing
    rng = np.random.default_rng(19)
    for cin, cout in ((256, 256), (48, 256)):
        wq, ws = quantize_weight((rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32))
        zplan = stem_packing("relu cases", wq, ws, 1, 1)
        zplan = dataclasses.replace(zplan, x_scale=0.05, w_scale=-zplan.w_scale).to(dev)
        x = torch.zeros((2, 6, 300, cin), device=dev)
        x[0, 2, 7, 5] = 1.0
        zb = torch.full((cout,), -0.0, device=dev)
        zb[3], zb[4] = float("nan"), 1.0
        for dt in (torch.float32, torch.bfloat16):
            for next_scale in (None, 0.02):
                b = zb if next_scale is None else torch.where(zb.isnan(), -0.0, zb)
                got = fused_sparse_conv_q_bias_relu(x.to(dt), zplan, b, dt, next_scale=next_scale)
                want = _stem_plain(x.to(dt), zplan, b, dt, None, next_scale)
                if next_scale is None:
                    mism, neg0 = _same_bits(torch, got, want), int(
                        (torch.signbit(got) & (got == 0)).sum())
                    ok = not mism and not neg0 and bool(got.isnan().any())
                else:
                    mism, neg0 = int((got != want).sum()), 0
                    ok = not mism and int((got == 0).sum()) == int((want == 0).sum()) > 0
                _emit(phase="int8_stem_relu_cases", out_dtype=str(got.dtype),
                      rounded_to=str(dt), cin=cin, mismatches=mism,
                      nan=int(got.isnan().sum()) if next_scale is None else None,
                      negative_zeros=neg0, zeros=int((got == 0).sum()))
                if not ok:
                    raise AssertionError(f"the stem route differs on -0.0/NaN ({dt}, next "
                                         f"scale {next_scale}, cin {cin}): {mism} mismatches, "
                                         f"{neg0} negative zeros")
    # the hand-off on .5 ties and clamps: unit 1x1 weights on an int8 x at
    # scale 1 make v = x + bias exactly, the biases put v / next_scale on
    # ties, just off them and past 127
    eye = stem_packing("tie cases", np.eye(128, dtype=np.int8).reshape(1, 1, 128, 128),
                       np.ones(128, np.float32), 0, 0).to(dev)
    xq = torch.arange(-127, 128, device=dev, dtype=torch.int8).view(1, 5, 51, 1).expand(
        1, 5, 51, 128).contiguous()
    ones = torch.ones(1, device=dev)
    tb = torch.from_numpy(np.tile(np.array([0.5, -0.5, 0.25, 0.75, 0.0, -0.0, 1e-3, 2.5],
                                           np.float32), 16)).to(dev)
    # and random biases over many magnitudes at scales across the range the
    # kernel's division takes, for its rounding
    rb = torch.from_numpy((rng.normal(size=128) * 10.0 ** rng.uniform(-3, 3, 128)).astype(
        np.float32)).to(dev)
    clamped = 0
    for dt in (torch.float32, torch.bfloat16):
        for bias, next_scale in [(tb, c) for c in (1.0, 0.5, 2.0, 0.3)] + [
                (rb, c) for c in (0.0173, 7.3, 2.0 ** -30, 2.0 ** 20, 0.041)]:
            got = fused_sparse_conv_q_bias_relu(xq, eye, bias, dt, xs=ones,
                                                next_scale=next_scale)
            want = _stem_plain(xq, eye, bias, dt, ones, next_scale)
            mism = int((got != want).sum())
            clamped += int((want == 127).sum())
            _emit(phase="int8_handoff_tie_cases", rounded_to=str(dt), next_scale=next_scale,
                  biases="ties" if bias is tb else "random", mismatches=mism,
                  clamped=int((want == 127).sum()), zeros=int((want == 0).sum()))
            if mism:
                raise AssertionError(f"the int8 hand-off differs on ties/clamps ({dt}, "
                                     f"{next_scale}): {mism} mismatches")
    assert clamped > 0
    # the whole stem, static (the calibrated frontend) and per frame, against
    # its plain chain on the card
    per_frame = copy.copy(fe)
    per_frame.stem_x_scales, per_frame._stem_chain = None, None
    xn = tpoly.nhwc_to_nchw(xf[0])
    stem = {}
    for label, f in (("static", fe), ("per_frame", per_frame)):
        with torch.inference_mode():
            got = tpoly.nchw_to_nhwc(f._stem_convs(xn))
        want = _plain_stem_chain(torch, f, xf[0])
        mism = _same_bits(torch, got, want)
        _emit(phase="int8_stem_chain_vs_plain", scales=label, shape=list(got.shape),
              dtype=str(got.dtype), mismatches=mism)
        if mism or got.dtype != fe.dtype:
            raise AssertionError(f"the {label} int8 stem differs from its plain chain in "
                                 f"{mism} values")
        del got, want
    torch.cuda.empty_cache()
    # conv0's quantize pass: through its packing's map padding it to 64
    # channels (the route's; its -1s are zero vectors), and unpadded
    x0, p0 = log[0][0], log[0][1]
    n0, c0 = x0.shape[0], x0.shape[3]
    chan64, vecs64 = p0.in_chan, p0.in_vecs
    assert p0.narrow and chan64.numel() == 64 and vecs64.tolist()[-2:] == [-1, -1]
    for scale in (None, scales[0]):
        for chan, vecs in ((None, None), (chan64, vecs64)):
            xq, xs = quantize_activation(x0, scale, chan, vecs=vecs)
            xq_p, xs_p = quantize_activation_reference(select_channels(x0, chan), scale)
            same = torch.equal(xq, xq_p) and torch.equal(xs, xs_p)
            _emit(phase="conv0_quantize_vs_plain", shape=list(x0.shape),
                  channels=c0 if chan is None else chan.numel(),
                  scale="per-frame" if scale is None else "static", bit_equal=same)
            if not same:
                raise AssertionError("conv0's quantize pass differs from its plain version")
            del xq, xq_p
    s0 = scales[0]
    pq_turns = _time_turns(torch, {
        "map64": lambda: quantize_activation(x0, s0, chan64, vecs=vecs64),
        "unpadded": lambda: quantize_activation(x0, s0),
        "plain": lambda: quantize_activation_reference(select_channels(x0, chan64), s0),
        "pad128": lambda: F.pad(x0, (0, 128 - c0)),
    }, {"map64": 10, "unpadded": 10, "plain": 3, "pad128": 10})
    px = x0[..., 0].numel()
    # static scale: the bf16 x read once, the int8 x and the scales written
    bound = _bound(x0.numel() * 2 + px * 64 + n0 * 4, x0.numel(), "f32")
    conv0_q = {"ms": min(pq_turns["map64"]), "unpadded_ms": min(pq_turns["unpadded"]),
               "plain_ms": min(pq_turns["plain"]), "pad128_ms": min(pq_turns["pad128"]),
               "bound_ms": bound[0], "bound_by": bound[1]}
    _emit(phase="conv0_quantize_time", shape=list(x0.shape), scale="static", turns=pq_turns,
          **conv0_q, card=smi)
    # each conv's route as the frontend runs it (static: conv0 and conv1 hand
    # int8 on, conv1 and conv2 read it), per frame, and static without the
    # hand-off, against cuDNN's bf16 conv + bias + ReLU as the bf16 frontend
    # runs it
    convs = []
    for i, (xrec, plan, bias, _, _, xs_rec, next_scale) in enumerate(log):
        p = dataclasses.replace(plan, x_scale=scales[i])
        pd = dataclasses.replace(plan, x_scale=None)
        wp, bias_bf16, plo, phi = fe.convs[i]
        x = xf[i]
        xn = tpoly.nhwc_to_nchw(x)
        turns = _time_turns(torch, {
            "route": lambda: fused_sparse_conv_q_bias_relu(xrec, plan, bias, torch.bfloat16,
                                                           xs=xs_rec, next_scale=next_scale),
            "route_per_frame": lambda: fused_sparse_conv_q_bias_relu(x, pd, bias,
                                                                     torch.bfloat16),
            "route_static_bf16": lambda: fused_sparse_conv_q_bias_relu(x, p, bias,
                                                                       torch.bfloat16),
            "cudnn": lambda: F.relu_(tpoly._conv(xn, wp, bias_bf16, plo, phi)),
        }, {"route": 10, "route_per_frame": 10, "route_static_bf16": 10, "cudnn": 10})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _stem_plain(xrec, plan, bias, torch.bfloat16, xs_rec, next_scale)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        n, h, w, cin = x.shape
        kh, kw, _, cout = fe.q_convs[i][0].shape
        # bytes: x (bf16 at conv0, else the int8 x handed on) read once, the
        # int8 weight (its real channels and taps) and the f32 bias, y (int8
        # where handed on, else bf16) written once; operations: the folded
        # conv's products.  Per frame: bf16 x in, bf16 y out.
        ops = 2 * n * h * w * kh * kw * cin * cout
        weights = kh * kw * cin * cout + cout * 4
        bound = _bound(xrec.numel() * xrec.element_size() + weights
                       + n * h * w * cout * (1 if next_scale is not None else 2), ops, "int8")
        bound_pf = _bound(x.numel() * 2 + weights + n * h * w * cout * 2, ops, "int8")
        row = {"conv": i, "shape": [n, h, w, cin], "kernel": [kh, kw], "cout": cout,
               "narrow": plan.narrow, "x_in": str(xrec.dtype),
               "out": "int8" if next_scale is not None else "bfloat16",
               "ms": min(turns["route"]), "per_frame_ms": min(turns["route_per_frame"]),
               "static_bf16_ms": min(turns["route_static_bf16"]), "plain_ms": plain_ms,
               "library_ms": min(turns["cudnn"]), "bound_ms": bound[0], "bound_by": bound[1],
               "per_frame_bound_ms": bound_pf[0], "per_frame_bound_by": bound_pf[1]}
        convs.append(row)
        _emit(phase="int8_stem_time", turns=turns, **row, bound_share=bound[0] / row["ms"],
              per_frame_bound_share=bound_pf[0] / row["per_frame_ms"], card=smi)
    xn = tpoly.nhwc_to_nchw(xf[0])
    with torch.inference_mode():
        turns = _time_turns(torch, {"static": lambda: fe._stem_convs(xn),
                                    "per_frame": lambda: per_frame._stem_convs(xn)},
                            {"static": 10, "per_frame": 10})
    stem = {"static_ms": min(turns["static"]), "per_frame_ms": min(turns["per_frame"])}
    _emit(phase="int8_stem_whole_time", turns=turns, **stem, card=smi)
    del log, x0, xf
    torch.cuda.empty_cache()
    return {"err": 0.0, "convs": convs, "conv0_quantize": conv0_q, "stem": stem}


def _int8_stem_parity_f32(torch, np, params, state, spec, small) -> None:
    """Phase 20: int8 serving with the int8 stem (per-frame stem scales) in
    f32 on the card (TF32 off) and on the CPU at 256x512: each stem conv's
    CUDA output bit-equal to the CPU plain version on the activation the
    CUDA run gave it; ids agreement >= INT8_PARITY_MIN; the CUDA run's
    counts (zeroed just before, read just after): B3 16 and quantize 16 a
    forward, absmax 15 (conv0's scale is analytic), the stem's three convs
    on the narrow kernel and the 13 others on the 128-wide one, no
    hand-off (per-frame scales: each conv quantizes its own x)."""
    from tpuseg_torch.ops.sparse_conv import (
        fused_sparse_conv_apply_q, fused_sparse_conv_q_bias_relu, quantize_activation,
        sparse_conv_q_kernel, sparse_conv_q_narrow_kernel)
    from tpuseg_torch.video.pipeline import VideoSegmenter

    ids, log = {}, []
    for name in ("cuda", "cpu"):
        seg = VideoSegmenter(params, state, spec, MEAN, STD, device=name,
                             compute_dtype=torch.float32, batch=2, quantize=True,
                             quantize_stem=True)
        undo = _record_stem(torch, log) if name == "cuda" else (lambda: None)
        torch.cuda.synchronize()
        for f in (fused_sparse_conv_apply_q, sparse_conv_q_kernel, sparse_conv_q_narrow_kernel):
            f.launches = 0
        quantize_activation.launches = quantize_activation.absmax_launches = 0
        fused_sparse_conv_q_bias_relu.handoff_launches = 0
        try:
            ids[name] = seg.run(small, need_color=False)["ids"]
        finally:
            undo()
        if name == "cuda":
            torch.cuda.synchronize()
            counts = {"b3": fused_sparse_conv_apply_q.launches,
                      "quantize": quantize_activation.launches,
                      "absmax": quantize_activation.absmax_launches,
                      "sparse_conv_q_kernel": sparse_conv_q_kernel.launches,
                      "sparse_conv_q_narrow_kernel": sparse_conv_q_narrow_kernel.launches,
                      "handoff": fused_sparse_conv_q_bias_relu.handoff_launches}
    checked = 0
    for x, plan, bias, dt, y, xs, next_scale in log:
        want = fused_sparse_conv_q_bias_relu(x.cpu(), plan.to("cpu"), bias.cpu(), dt,
                                             xs=None if xs is None else xs.cpu(),
                                             next_scale=next_scale)
        if _same_bits(torch, y.cpu(), want):
            raise AssertionError("int8 stem conv: CUDA output differs from the CPU plain "
                                 "version on the same activation")
        checked += 1
    agree = _agreement(ids["cuda"], ids["cpu"])
    per_forward = B3_PER_FORWARD["dense"] + B3_STEM_PER_FORWARD
    want = {"b3": 2 * per_forward, "quantize": 2 * per_forward,  # run()'s untimed call + 1
            "absmax": 2 * (per_forward - 1),
            "sparse_conv_q_kernel": 2 * B3_PER_FORWARD["dense"],
            "sparse_conv_q_narrow_kernel": 2 * B3_STEM_PER_FORWARD, "handoff": 0}
    _emit(phase="int8_stem_parity_f32", tf32=False, size=list(small[0].shape[:2]),
          frames=len(small), stem_conv_calls_bit_equal=checked, ids_agreement=agree,
          limit=INT8_PARITY_MIN, launches=counts, want=want)
    if checked != 2 * B3_STEM_PER_FORWARD or counts != want:
        raise AssertionError(f"{checked} stem conv calls recorded; launches {counts}, "
                             f"want {want}")
    if agree < INT8_PARITY_MIN:
        raise AssertionError(f"int8 stem f32 CUDA vs CPU ids agreement {agree} < "
                             f"{INT8_PARITY_MIN}")


def _int8_stem_full(torch, np, dev, params, state, spec, frames, no_stem_ids, bench_seg,
                    frames_dev, smi) -> dict:
    """Phase 21: bench.py's int8_stem mode (dense, quantize + quantize_stem,
    calibrated on the first 8 frames): run() at batch 8 with every count
    zeroed just before and read just after (a forward: the stem's three
    convs on the narrow kernel, conv0 and conv1 handing int8 on, so one
    quantize pass, conv0's through its map; the 13 stage convs on the
    128-wide kernel with their passes); ids agreement with the int8 run
    without the stem; the device rate at batch 32; the frontend's time, bf16
    against the int8 stem, in turns, and one profiled call of each.
    -> launches and numbers."""
    from tpuseg_torch.ops.sparse_conv import (
        fused_sparse_conv_apply, fused_sparse_conv_apply_q, fused_sparse_conv_q_bias_relu,
        quantize_activation, sparse_conv_q_kernel, sparse_conv_q_narrow_kernel)
    from tpuseg_torch.ops.upsample import upsample_argmax
    from tpuseg_torch.video.pipeline import VideoSegmenter

    serve = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                           compute_dtype=torch.bfloat16, batch=8, quantize=True,
                           quantize_stem=True, calib_frames=frames[:8])
    if serve.stem_fn.stem_x_scales is None or len(serve.exec_plans) != 13:
        raise AssertionError("int8 stem segmenter not calibrated")
    forwards = 1 + -(-len(frames) // 8)
    torch.cuda.synchronize()
    for f in (fused_sparse_conv_apply_q, fused_sparse_conv_q_bias_relu, fused_sparse_conv_apply,
              upsample_argmax, sparse_conv_q_kernel, sparse_conv_q_narrow_kernel):
        f.launches = 0
    quantize_activation.launches = quantize_activation.absmax_launches = 0
    quantize_activation.map_launches = 0
    fused_sparse_conv_q_bias_relu.handoff_launches = 0
    res = serve.run(frames, need_color=False)
    torch.cuda.synchronize()
    got = {"b3": fused_sparse_conv_apply_q.launches,
           "b3_stem": fused_sparse_conv_q_bias_relu.launches,
           "handoff": fused_sparse_conv_q_bias_relu.handoff_launches,
           "sparse_conv_q_kernel": sparse_conv_q_kernel.launches,
           "sparse_conv_q_narrow_kernel": sparse_conv_q_narrow_kernel.launches,
           "quantize": quantize_activation.launches,
           "absmax": quantize_activation.absmax_launches,
           "quantize_map": quantize_activation.map_launches,
           "b2": fused_sparse_conv_apply.launches, "upsample_argmax": upsample_argmax.launches}
    want = {"b3": (B3_PER_FORWARD["dense"] + B3_STEM_PER_FORWARD) * forwards,
            "b3_stem": B3_STEM_PER_FORWARD * forwards,
            "handoff": (B3_STEM_PER_FORWARD - 1) * forwards,  # conv0 -> conv1 -> conv2
            # the stem on the narrow kernel, the stage convs on the 128-wide one
            "sparse_conv_q_kernel": B3_PER_FORWARD["dense"] * forwards,
            "sparse_conv_q_narrow_kernel": B3_STEM_PER_FORWARD * forwards,
            "quantize": (B3_PER_FORWARD["dense"] + 1) * forwards,
            "absmax": 0, "quantize_map": forwards,  # conv0 through its padding map
            "b2": 0, "upsample_argmax": forwards}
    out = res["ids"]
    assert out.shape == (len(frames),) + FULL and out.dtype == np.uint8, (out.shape, out.dtype)
    assert int(out.max()) < CLASSES
    agree = _agreement(out, no_stem_ids)
    del serve
    torch.cuda.empty_cache()
    fps = bench_seg.benchmark_device_fps(FULL, inner=16, reps=2)
    bf16_fe = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                             compute_dtype=torch.bfloat16, batch=32).stem_fn
    with torch.inference_mode():
        turns = _time_turns(torch, {"bf16": lambda: bf16_fe(frames_dev),
                                    "int8_stem": lambda: bench_seg.stem_fn(frames_dev)},
                            {"bf16": 5, "int8_stem": 5})
        prof = {"bf16": _profile_kernels(torch, lambda: bf16_fe(frames_dev)),
                "int8_stem": _profile_kernels(torch, lambda: bench_seg.stem_fn(frames_dev))}
    row = {"launches": got, "want": want, "run_fps": res["fps"], "ids_agreement": agree,
           "device_fps": fps, "frontend_bf16_ms": min(turns["bf16"]),
           "frontend_int8_stem_ms": min(turns["int8_stem"])}
    _emit(phase="int8_stem_full", size=list(FULL), dtype="bfloat16", batch=8,
          frames=res["frames"], agreement_with="int8 without the stem (calibrated)",
          limit=INT8_STEM_MIN, frontend_turns=turns, frontend_profile=prof, device_fps_batch=32,
          **row, card=smi)
    if got != want:
        raise AssertionError(f"int8 stem run launches {got}; want {want}")
    if agree < INT8_STEM_MIN:
        raise AssertionError(f"int8 stem vs int8 ids agreement {agree} < {INT8_STEM_MIN}")
    return row


def _temporal_kernels(torch, np, dev, frames, smi) -> dict:
    """Phase 22: K3 (``frame_deltas``) bit-equal to its plain version on the
    32 shapes frames and on 32 random 1024x2048 frames, then timed against
    it and against tpuseg's expression in eager PyTorch; the budgeted
    mode's one launch (``frame_deltas_budget``: K3 with K4's scan in its
    last block) equal to K3's and K4's plain versions in turn on the same
    frames, one launch a call; K4 alone (``budget_select``) equal to its
    plain version on crafted deltas: budget pressure, n_keyed = 0, ties
    with the threshold, budget 1 and budget = batch.  K4's time is the fused
    entry's less K3's alone, the two timed in turns."""
    from tpuseg_torch.ops.temporal import (
        budget_select, budget_select_reference, frame_deltas, frame_deltas_budget,
        frame_deltas_budget_reference, frame_deltas_reference)

    h, w = FULL
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    batches = {
        "shapes": torch.from_numpy(np.stack(frames).reshape(len(frames), h, -1)).to(dev),
        "random": torch.randint(0, 256, (32, h, w * 3), generator=gen, device=dev,
                                dtype=torch.uint8),
    }
    prev = torch.randint(0, 256, (h, w * 3), generator=gen, device=dev, dtype=torch.uint8)
    for label, fb in batches.items():
        got, want = frame_deltas(fb, prev), frame_deltas_reference(fb, prev)
        same = torch.equal(got, want)
        _emit(phase="k3_vs_plain", frames=label, shape=list(fb.shape), bit_equal=same,
              d_first=got[:3].tolist())
        if not same:
            raise AssertionError(f"K3 differs from its plain version on {label} frames")
    # the fused entry: (frames, carried drift, count, threshold, K)
    fused_cases = {
        "shapes, fresh carry": (batches["shapes"], 0.0, 0, 2.5, 8),
        "shapes, budget pressure": (batches["shapes"], 0.7, 3, 0.5, 4),
        "random, carried": (batches["random"], 1.5, 5, 120.0, 8),
        "random, budget = batch": (batches["random"], 0.0, 0, 80.0, 32),
    }
    for label, (fb, acc, n, thresh, k) in fused_cases.items():
        a = torch.tensor([acc], dtype=torch.float32, device=dev)
        nk = torch.tensor([n], dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        before = frame_deltas_budget.launches
        got = frame_deltas_budget(fb, prev, a, nk, thresh, k)
        launched = frame_deltas_budget.launches - before
        want = frame_deltas_budget_reference(fb, prev, a, nk, thresh, k)
        same = all(torch.equal(g, r) for g, r in zip(got, want))
        _emit(phase="k3_k4_fused_vs_plain", case=label, budget=k, thresh=thresh,
              promoted=int(want[1].sum()), equal=same, launches=launched)
        if not same or launched != 1:
            raise AssertionError(f"K3 + K4 in one launch differs from the plain versions "
                                 f"({label}) or launched {launched} times")
    fb = batches["random"]

    def eager():  # tpuseg's expression (pipeline.py:670-678) in eager PyTorch
        prevs = torch.cat([prev[None], fb[:-1]])
        return torch.mean(torch.abs(fb.to(torch.int16) - prevs.to(torch.int16)).float(),
                          dim=(1, 2))

    a = torch.zeros((1,), device=dev)
    nk = torch.zeros((1,), dtype=torch.int32, device=dev)
    turns = _time_turns(torch, {"kernel": lambda: frame_deltas(fb, prev),
                                "fused": lambda: frame_deltas_budget(fb, prev, a, nk, 2.5, 8),
                                "plain": lambda: frame_deltas_reference(fb, prev),
                                "library": eager},
                        {"kernel": 50, "fused": 50, "plain": 5, "library": 5})
    # bytes: every frame and the carried one read once, d written; one
    # |difference| an element at the CUDA cores' rate
    k3_bound = _bound((fb.shape[0] + 1) * prev.numel() + fb.shape[0] * 4, fb.numel(), "f32")
    k3 = {"ms": min(turns["kernel"]), "plain_ms": min(turns["plain"]),
          "library_ms": min(turns["library"]), "bound_ms": k3_bound[0], "bound_by": k3_bound[1]}
    _emit(phase="k3_time", shape=list(fb.shape), turns=turns, **k3,
          fused_ms=min(turns["fused"]), card=smi)
    rng = np.random.default_rng(22)
    cases = [  # (label, d, acc0, n_keyed, thresh, K)
        ("budget pressure", rng.random(32) * 6, 0.7, 3, 2.5, 8),
        ("n_keyed = 0", rng.random(32) * 0.5, 0.0, 0, 2.5, 8),
        ("ties with thresh", np.tile([0.5, 1.0, 0.5], 11)[:32], 0.0, 1, 2.0, 8),
        ("budget 1", rng.random(32) * 6, 0.0, 0, 1.0, 1),
        ("budget = batch", rng.random(32) * 6, 0.0, 0, 1.0, 32),
    ]
    for label, d_np, acc, n, thresh, k in cases:
        d = torch.from_numpy(d_np.astype(np.float32)).to(dev)
        a = torch.tensor([acc], dtype=torch.float32, device=dev)
        nk = torch.tensor([n], dtype=torch.int32, device=dev)
        got, want = budget_select(d, a, nk, thresh, k), budget_select_reference(d, a, nk, thresh, k)
        same = all(torch.equal(g, r) for g, r in zip(got, want))
        _emit(phase="k4_vs_plain", case=label, budget=k, promoted=int(want[0].sum()),
              equal=same)
        if not same:
            raise AssertionError(f"K4 differs from its plain version ({label})")
    d = torch.from_numpy((rng.random(32) * 6).astype(np.float32)).to(dev)
    a = torch.zeros((1,), device=dev)
    nk = torch.zeros((1,), dtype=torch.int32, device=dev)
    k4_turns = _time_turns(torch, {"alone": lambda: budget_select(d, a, nk, 2.5, 8),
                                   "plain": lambda: budget_select_reference(d, a, nk, 2.5, 8)},
                           {"alone": 50, "plain": 10})
    # bytes: d, the carry and the outputs (flags, fwd_idx, keyslot, carry)
    k4_bound = _bound(32 * 4 + 8 + 32 + 8 * 4 + 32 * 4 + 8, 32 * 4, "f32")
    # K4 runs in K3's last block: its time is what that launch adds to K3's
    k4 = {"ms": min(turns["fused"]) - min(turns["kernel"]), "plain_ms": min(k4_turns["plain"]),
          "library_ms": None, "bound_ms": k4_bound[0], "bound_by": k4_bound[1]}
    device = {name: _profile_kernels(torch, lambda fn=fn: [fn() for _ in range(10)])
              for name, fn in (("k3", lambda: frame_deltas(fb, prev)),
                               ("fused", lambda: frame_deltas_budget(fb, prev, a, nk, 2.5, 8)))}
    _emit(phase="k4_time", batch=32, budget=8, fused_turns=turns["fused"],
          k3_turns=turns["kernel"], alone_turns=k4_turns["alone"],
          alone_ms=min(k4_turns["alone"]), **k4,
          device_ms={name: p["total_ms"] / 10 for name, p in device.items()},
          device_kernels={name: p["top"] for name, p in device.items()}, card=smi)
    del batches, fb
    torch.cuda.empty_cache()
    return {"frame_deltas": k3, "budget_select": k4}


def _budget_inputs() -> dict:
    """Phase 23's host-side inputs, made in a worker process while the card
    runs phases 19 and 20 (they take about 40 s of CPU; phase 19 times only
    kernels of milliseconds, which a busy host core does not hold back, as
    it does the launch-bound gathered lowering and run()): the 64 shapes
    frames of seed 1 at full size, ``drift_threshold`` of them, and the CPU
    plain selection over them (K3 and K4's plain versions, batch 32, from a
    fresh carry): the promoted count run() must match."""
    import numpy as np
    import torch

    from tpuseg_torch.data.shapes import shapes_video
    from tpuseg_torch.ops.temporal import budget_select_reference, frame_deltas_reference
    from tpuseg_torch.video.autotune import drift_threshold

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    frames = shapes_video(2 * BUDGET_BATCH, FULL, seed=1)[0]
    gen_s = time.perf_counter() - t0
    thresh, mean_delta = drift_threshold(list(frames))
    prev = torch.zeros(FULL[0], FULL[1] * 3, dtype=torch.uint8)
    acc, nk, promoted = torch.zeros(1), torch.zeros(1, dtype=torch.int32), 0
    for i in range(0, len(frames), BUDGET_BATCH):
        fb = torch.from_numpy(np.ascontiguousarray(frames[i:i + BUDGET_BATCH])).reshape(
            BUDGET_BATCH, FULL[0], -1)
        flags, _, _, acc, nk = budget_select_reference(frame_deltas_reference(fb, prev), acc,
                                                       nk, thresh, BUDGET_K)
        promoted += int(flags.sum())
        prev = fb[-1]
    return {"frames": frames, "thresh": thresh, "mean_delta": mean_delta,
            "promoted_cpu": promoted, "frame_gen_seconds": gen_s,
            "worker_seconds": time.perf_counter() - t0}


def _budget_full(torch, np, dev, masked, state, spec, gplans, calib, inputs, smi) -> dict:
    """Phase 23: bench.py:153-166's sparse_int8_budget8 (block128reg_87.50
    under the gathered lowering, int8 calibrated on 8 frames, batch 32,
    K = 8, threshold ``drift_threshold`` of 64 shapes frames of seed 1;
    ``inputs`` from ``_budget_inputs``): run() with every count zeroed just
    before and read just after (per batch B3 13, B1 1, the K3 + K4 launch 1,
    K3 and K4 alone 0, B2 0), its promoted count equal to the CPU plain
    selection on the same frames, then ``benchmark_adaptive_device_fps`` on
    them."""
    from tpuseg_torch.ops.sparse_conv import (
        fused_sparse_conv_apply, fused_sparse_conv_apply_q, quantize_activation,
        sparse_conv_q_kernel, sparse_conv_q_narrow_kernel)
    from tpuseg_torch.ops.temporal import budget_select, frame_deltas, frame_deltas_budget
    from tpuseg_torch.ops.upsample import upsample_argmax
    from tpuseg_torch.video.pipeline import VideoSegmenter

    frames, thresh = list(inputs["frames"]), inputs["thresh"]
    promoted_cpu = inputs["promoted_cpu"]
    seg = VideoSegmenter(masked, state, spec, MEAN, STD, device=dev, compute_dtype=torch.bfloat16,
                         batch=BUDGET_BATCH, exec_plans=gplans, quantize=True, calib_frames=calib,
                         temporal_thresh=thresh, temporal_budget=BUDGET_K)
    counters = (fused_sparse_conv_apply_q, fused_sparse_conv_apply, upsample_argmax,
                frame_deltas, budget_select, frame_deltas_budget, sparse_conv_q_kernel,
                sparse_conv_q_narrow_kernel)
    torch.cuda.synchronize()
    for f in counters:
        f.launches = 0
    quantize_activation.launches = quantize_activation.absmax_launches = 0
    res = seg.run(frames, need_color=False)
    torch.cuda.synchronize()
    got = {f.__name__: f.launches for f in counters}
    got["quantize_activation"] = quantize_activation.launches
    got["absmax"] = quantize_activation.absmax_launches
    forwards = 1 + len(frames) // BUDGET_BATCH  # run()'s untimed call + the batches
    want = {"fused_sparse_conv_apply_q": B3_PER_FORWARD["gathered"] * forwards,
            "sparse_conv_q_kernel": B3_PER_FORWARD["gathered"] * forwards,
            "sparse_conv_q_narrow_kernel": 0,
            "fused_sparse_conv_apply": 0, "upsample_argmax": forwards,
            "frame_deltas": 0, "budget_select": 0, "frame_deltas_budget": forwards,
            "quantize_activation": B3_PER_FORWARD["gathered"] * forwards, "absmax": 0}
    out = res["ids"]
    assert out.shape == (len(frames),) + FULL and out.dtype == np.uint8, (out.shape, out.dtype)
    assert int(out.max()) < CLASSES
    dev_res = seg.benchmark_adaptive_device_fps(frames)
    row = {"launches": got, "want": want, "promoted": res["promoted"],
           "promoted_cpu": promoted_cpu, "promotion_rate": res["promotion_rate"],
           "run_fps": res["fps"], "device_fps": dev_res["device_fps"],
           "device_promotion_rate": dev_res["promotion_rate"]}
    _emit(phase="budget_full", config=SERVED_CONFIG, lowering="gathered", size=list(FULL),
          dtype="bfloat16", batch=BUDGET_BATCH, budget=BUDGET_K, frames=len(frames),
          thresh=thresh, mean_delta=inputs["mean_delta"],
          frame_gen_seconds=round(inputs["frame_gen_seconds"], 3),
          worker_seconds=round(inputs["worker_seconds"], 3), **row, card=smi)
    if got != want:
        raise AssertionError(f"budget run launches {got}; want {want}")
    if res["promoted"] != promoted_cpu or dev_res["promotion_rate"] != promoted_cpu / len(frames):
        raise AssertionError(f"promoted {res['promoted']} (device rate "
                             f"{dev_res['promotion_rate']}); the CPU selection {promoted_cpu}")
    del seg
    torch.cuda.empty_cache()
    return row


def _interval_full(torch, np, dev, params, state, spec, frames, smi) -> dict:
    """Phase 24: dense bf16 with temporal_interval=4 at full size: run() at
    batch 8 launches B1 once a batch (counts zeroed just before, read just
    after) and each frame's ids are its keyframe's; the device rate at batch
    32."""
    from tpuseg_torch.ops.upsample import upsample_argmax
    from tpuseg_torch.video.pipeline import VideoSegmenter

    seg = VideoSegmenter(params, state, spec, MEAN, STD, device=dev, compute_dtype=torch.bfloat16,
                         batch=8, temporal_interval=4)
    torch.cuda.synchronize()
    upsample_argmax.launches = 0
    res = seg.run(frames, need_color=False)
    torch.cuda.synchronize()
    launches, forwards = upsample_argmax.launches, 1 + -(-len(frames) // 8)
    ids = res["ids"]
    keyed = all(np.array_equal(ids[i], ids[i - i % 4]) for i in range(len(ids)))
    distinct = len({ids[i].tobytes() for i in range(0, len(ids), 4)})
    del seg
    bench = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                           compute_dtype=torch.bfloat16, batch=32, temporal_interval=4)
    fps = bench.benchmark_device_fps(FULL, inner=16, reps=2)
    del bench
    torch.cuda.empty_cache()
    row = {"upsample_launches": launches, "want": forwards, "ids_keyed": keyed,
           "distinct_keyframe_ids": distinct, "run_fps": res["fps"], "device_fps": fps}
    _emit(phase="interval_full", size=list(FULL), dtype="bfloat16", batch=8, interval=4,
          frames=res["frames"], device_fps_batch=32, **row, card=smi)
    if launches != forwards or not keyed or ids.shape != (len(frames),) + FULL:
        raise AssertionError(f"interval run: B1 {launches} launches (want {forwards}), "
                             f"ids keyed {keyed}")
    return row


# phases 25-30: this slice's kernels and serving modes
SEQ_BATCH = 8  # the sequential adaptive mode's batch (phase 28)
# K6's f32 instructions a (pixel, shift): an FADD for the difference and an
# FADD with |.| on its operand for the sum (cuobjdump -sass of
# block_shifts_kernel<4, true>); they cannot pair into FMAs
K6_INSTRUCTIONS = 2
FLOW_ENTRIES = {  # wrapper -> (kernel, source, tpuseg file:line)
    "keyframe_select": ("K5", "tpuseg_torch/csrc/temporal.cu", "tpuseg/video/pipeline.py:614-638"),
    "estimate_block_shifts": ("K6", "tpuseg_torch/csrc/flow.cu", "tpuseg/video/flow.py:82-142"),
    "warp_ids": ("K7", "tpuseg_torch/csrc/flow.cu", "tpuseg/video/flow.py:145-206"),
    "i420_to_rgb_flat": ("K8", "tpuseg_torch/csrc/yuv.cu", "tpuseg/video/yuv.py:77-99"),
}


def _equal_outputs(torch, got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))


def _raises_on_strided(fn) -> bool:
    try:
        fn()
    except ValueError as e:
        return "contiguous" in str(e)
    return False


def _new_kernels(torch, np, dev, frames, smi) -> dict:
    """Phase 25: K5 (``keyframe_select``), K6 (``estimate_block_shifts``),
    K7 (``warp_ids``) and K8 (``i420_to_rgb_flat``) bit-equal to their plain
    versions on the card: K5 (every output) from n_keyed = 0, on a scene
    cut, on a diff exactly at the threshold, on the 32 shapes frames (four
    chunks), on 17 of them (a ragged last chunk), on promotions at a chunk's
    last and first frames and on frames of 63x97 bytes (not a multiple of
    16: the byte path), one launch a call; K6 on integer luma
    with a known translation and on the serving luma (the shapes frames'
    pooled luma against their interval-4 keyframes'); K7 on the seam and
    range cases of tests/test_video.py:460 and on (32, 1024, 2048) ids with
    shifts in [-6, 6]; K8 on 0/255 planes, random planes, the shapes
    frames as I420 at 1024x2048 and 512x1024, a 640x360 decode, 854x480, a
    view one byte off 16-byte alignment and every (Y, U, V) triple, each on
    the path it must take (vector or byte, from the two counters).  A
    strided input must raise.  Then each in turns against its plain version (and K5 against tpuseg's f32-mean scan in eager
    PyTorch) at its serving shape, with its bound; K5 as the sequential mode
    serves it, under inference mode, back to back and with its promoted
    count read on the host after each call, its device time from
    ``torch.profiler``, and back to back outside inference mode."""
    from tpuseg_torch.ops.temporal import keyframe_select, keyframe_select_reference
    from tpuseg_torch.video.autotune import drift_threshold
    from tpuseg_torch.video.flow import (
        estimate_block_shifts, estimate_block_shifts_reference, pooled_luma, warp_ids,
        warp_ids_reference)
    from tpuseg_torch.video.yuv import i420_to_rgb_flat, i420_to_rgb_flat_reference, rgb_to_i420

    h, w = FULL
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    rng = np.random.default_rng(25)
    fb = torch.from_numpy(np.stack(frames).reshape(len(frames), h, -1)).to(dev)
    thresh = drift_threshold(frames[:SEQ_BATCH])[0]

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)

    def n_keyed(n):
        return torch.tensor([n], dtype=torch.int32, device=dev)

    a, b = u8(64, 96), u8(64, 96)
    odd_a, odd_b = u8(63, 97), u8(63, 97)
    k5_cases = {  # label -> (frames, carried, n_keyed, thresh)
        "n_keyed = 0, static": (torch.stack([a, a, a]), a, 0, 5.0),
        "scene cut": (torch.stack([a, a, b, b]), a, 1, 5.0),
        "diff = thresh": (torch.stack([torch.full_like(a, v) for v in (12, 14, 15)]),
                          torch.full_like(a, 10), 1, 2.0),
        "shapes 32 frames": (fb, fb[0], 0, thresh),
        "shapes, carried": (fb[8:16], fb[3], 2, thresh),
        "shapes 17 frames, carried": (fb[:17], fb[20], 1, thresh),
        "cuts on a chunk's last frames": (torch.stack([a] * 7 + [b] * 8 + [a] * 2), a, 1, 5.0),
        "cuts on a chunk's first frames": (torch.stack([a] * 8 + [b] * 8 + [a]), a, 1, 5.0),
        "63x97 bytes, 17 frames": (torch.stack([odd_a] * 5 + [odd_b] * 7 + [odd_a] * 5),
                                   odd_b, 0, 5.0),
    }
    for label, (x, carried, n, t) in k5_cases.items():
        torch.cuda.synchronize()
        before = keyframe_select.launches
        got = keyframe_select(x, carried, n_keyed(n), t)
        launched = keyframe_select.launches - before
        want = keyframe_select_reference(x, carried, n_keyed(n), t)
        count = int(want[4])
        same = (_equal_outputs(torch, got[:2] + got[3:], want[:2] + want[3:])
                and torch.equal(got[2][:count], want[2][:count]))
        _emit(phase="k5_vs_plain", case=label, frames=x.shape[0], frame_bytes=carried.numel(),
              promoted=count, promoted_at=want[2][:count].tolist(), equal=same,
              launches=launched)
        if not same or launched != 1:
            raise AssertionError(f"K5 differs from its plain version ({label}) or launched "
                                 f"{launched} times")
    # K6: tests/test_video.py:316's translation at block 8, the serving luma,
    # all SADs tied (a constant map: the first index, rejected by the gate)
    # and ties between shifts (a period-2 map), bit-equal; resized luma sums
    # in the kernel's own order and must agree on >= 0.99 of the blocks
    img = torch.from_numpy(rng.integers(0, 256, size=(2, 32, 32)).astype(np.float32)).to(dev)
    luma = pooled_luma(fb)
    period2 = torch.tensor([0.0, 765.0], device=dev).repeat(*luma.shape[:2], luma.shape[2] // 2)
    dec = u8(8, 360, 640, 3)
    k6_cases = {
        "translation (2, -3), block 8": (img, torch.roll(img, (2, -3), dims=(1, 2)), 8),
        "serving luma vs interval-4 keyframes": (luma[::4].repeat_interleave(4, 0), luma, 16),
        "serving luma, shifted (1, -2) blocks of 8 px": (
            luma, pooled_luma(torch.roll(fb.view(-1, h, w, 3), (8, -16), dims=(1, 2))), 16),
        "constant map (every SAD tied)": (torch.full_like(luma, 1000.0),
                                          torch.full_like(luma, 900.0), 16),
        "period-2 map (ties between shifts)": (period2, torch.roll(period2, 1, 2) + 1.0, 16),
        "resized luma, 360x640 onto 32x64": (
            pooled_luma(dec, grid=(32, 64)),
            pooled_luma(torch.roll(dec, (8, -8), dims=(1, 2)), grid=(32, 64)), 16),
    }
    for label, (key, cur, blk) in k6_cases.items():
        got = estimate_block_shifts(key.contiguous(), cur.contiguous(), block=blk)
        want = estimate_block_shifts_reference(key.contiguous(), cur.contiguous(), block=blk)
        same = _equal_outputs(torch, got, want)
        agree = float(np.mean([_agreement(g.cpu().numpy(), v.cpu().numpy())
                               for g, v in zip(got, want)]))
        _emit(phase="k6_vs_plain", case=label, shape=list(key.shape), block=blk, equal=same,
              agreement=agree, accepted=int((want[0] != 0).sum() + (want[1] != 0).sum()))
        if not (agree >= 0.99 if label.startswith("resized") else same):
            raise AssertionError(f"K6 differs from its plain version ({label}: agreement "
                                 f"{agree})")
    # K7: the seam/range cases (scale 4: the byte path) and the serving shape
    # (scale 8: the 8-byte path)
    ids32 = torch.from_numpy(rng.integers(0, 19, size=(1, 32, 32)).astype(np.uint8)).to(dev)
    seam_dy = torch.tensor([[[0, 2], [0, 2]]], dtype=torch.int32, device=dev)
    seam_dx = torch.tensor([[[0, -1], [0, -1]]], dtype=torch.int32, device=dev)
    big = torch.tensor([[[0, 7], [0, 7]]], dtype=torch.int32, device=dev)
    ids_full = torch.randint(0, 19, (32, h, w), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.uint8)
    dyf = torch.randint(-6, 7, (32, h // 128, w // 128), generator=gen, device=dev,
                        dtype=torch.int32)
    dxf = torch.randint(-6, 7, (32, h // 128, w // 128), generator=gen, device=dev,
                        dtype=torch.int32)
    k7_cases = {
        "seam (scale 4, block 4)": (ids32, seam_dy, seam_dx, 4, 4),
        "out of radius": (ids32, big, seam_dx * 0, 4, 4),
        "serving (32, 1024, 2048)": (ids_full, dyf, dxf, 8, 16),
        **_k7_vector_cases(torch, np, dev, gen, rng),
    }
    for label, (ids, dy, dx, scale, blk) in k7_cases.items():
        got = warp_ids(ids, dy, dx, scale=scale, block=blk)
        want = warp_ids_reference(ids, dy, dx, scale=scale, block=blk)
        same = torch.equal(got, want)
        _emit(phase="k7_vs_plain", case=label, shape=list(ids.shape), scale=scale, equal=same,
              moved=int((want != ids).sum()))
        if not same:
            raise AssertionError(f"K7 differs from its plain version ({label})")
    # K8, each case on the path it must take (read from the two counters)
    i420 = torch.from_numpy(rgb_to_i420(np.stack(frames[:8]))).to(dev)
    i420_half = torch.from_numpy(rgb_to_i420(np.stack(
        [f[::2, ::2] for f in frames[:8]]))).to(dev)  # phase 29's 512x1024 decode
    k8_cases = {  # label -> (input, path)
        "0 and 255": (torch.stack([torch.zeros((24, 16), dtype=torch.uint8, device=dev),
                                   torch.full((24, 16), 255, dtype=torch.uint8, device=dev)]),
                      "vector"),
        "random planes, 130 wide": (u8(4, 96, 130), "byte"),
        "shapes 8 x 1024x2048": (i420, "vector"),
        "shapes 8 x 512x1024": (i420_half, "vector"),
        "640x360 decode": (torch.from_numpy(rgb_to_i420(dec.cpu().numpy())).to(dev), "vector"),
        "854x480": (u8(2, 720, 854), "byte"),
        "one byte off 16-byte alignment": (
            u8(2 * 96 * 64 + 1)[1:].view(2, 96, 64), "byte"),
        "every (Y, U, V) triple": (_k8_every_triple(torch, dev), "vector"),
    }
    for label, (x, path) in k8_cases.items():
        torch.cuda.synchronize()
        before = (i420_to_rgb_flat.launches, i420_to_rgb_flat.vector_launches)
        got = i420_to_rgb_flat(x)
        launched = i420_to_rgb_flat.launches - before[0]
        took = "vector" if i420_to_rgb_flat.vector_launches - before[1] else "byte"
        same = torch.equal(got, i420_to_rgb_flat_reference(x))
        _emit(phase="k8_vs_plain", case=label, shape=list(x.shape), path=took, bit_equal=same,
              launches=launched)
        if not same or launched != 1 or took != path:
            raise AssertionError(f"K8 differs from its plain version ({label}), launched "
                                 f"{launched} times or took its {took} path (want {path})")
    del k8_cases, got
    strided = {
        "keyframe_select": lambda: keyframe_select(fb[::2], fb[0], n_keyed(0), 1.0),
        "estimate_block_shifts": lambda: estimate_block_shifts(luma[::2], luma[1::2]),
        "warp_ids": lambda: warp_ids(ids_full[::2], dyf[::2], dxf[::2], scale=8, block=16),
        "i420_to_rgb_flat": lambda: i420_to_rgb_flat(i420[::2]),
    }
    for name, fn in strided.items():
        if not _raises_on_strided(fn):
            raise AssertionError(f"{name} took a strided input without raising")
    _emit(phase="strided_inputs_raise", kernels=list(strided))

    # times at the serving shapes, in turns, with each bound; K5's count
    # lies on the device already, as in the sequential mode's carry
    fb8, kf, nk0 = fb[:SEQ_BATCH], fb[SEQ_BATCH], n_keyed(0)

    def k5_eager():  # tpuseg's scan (pipeline.py:614-634) in eager PyTorch
        key, n = kf, 0
        for f in fb8:
            diff = torch.mean(torch.abs(f.to(torch.int16) - key.to(torch.int16)).float())
            if n == 0 or bool(diff > thresh):
                key, n = f, n + 1
        return key

    ks, cs = luma[::4].repeat_interleave(4, 0).contiguous(), luma
    dyk, dxk = estimate_block_shifts(ks, cs)
    ids_k = ids_full
    times = {}
    lane_rate = _lane_rate(torch)[0]
    specs = {  # name -> (kernel, plain, library or None, iters, bytes, f32 operations)
        "keyframe_select": (
            lambda: keyframe_select(fb8, kf, nk0, thresh),
            lambda: keyframe_select_reference(fb8, kf, nk0, thresh), k5_eager, (50, 2),
            (SEQ_BATCH + 1) * kf.numel() + kf.numel() + SEQ_BATCH * 13, SEQ_BATCH * kf.numel()),
        "estimate_block_shifts": (
            lambda: estimate_block_shifts(ks, cs), lambda: estimate_block_shifts_reference(ks, cs),
            None, (20, 3), 2 * ks.numel() * 4 + 2 * dyk.numel() * 4, None),
        "warp_ids": (
            lambda: warp_ids(ids_k, dyk, dxk, scale=8, block=16),
            lambda: warp_ids_reference(ids_k, dyk, dxk, scale=8, block=16), None, (20, 2),
            2 * ids_k.numel() + 2 * dyk.numel() * 4, 0),
        "i420_to_rgb_flat": (
            lambda: i420_to_rgb_flat(i420), lambda: i420_to_rgb_flat_reference(i420), None,
            (20, 3), i420.numel() + 8 * h * w * 3, 8 * h * w * 3 * 3),
    }
    for name, (kern, plain, library, (it_k, it_p), nbytes, ops) in specs.items():
        fns = {"kernel": kern, "plain": plain}
        iters = {"kernel": it_k, "plain": it_p}
        if library is not None:
            fns["library"], iters["library"] = library, it_p
        extra = {}
        if name == "keyframe_select":
            # as _sequential_step serves it: under inference mode, and with
            # the promoted count read after each call
            fns["with_count_read"] = lambda: int(keyframe_select(fb8, kf, nk0, thresh)[4])
            iters["with_count_read"] = it_k
            extra["outside_inference_mode"] = _time_turns(torch, {"kernel": kern}, {"kernel": it_k})
            with torch.inference_mode():
                turns = _time_turns(torch, fns, iters)
            extra["with_count_read_ms"] = min(turns["with_count_read"])
        else:
            turns = _time_turns(torch, fns, iters)
        if name == "i420_to_rgb_flat":  # also at phase 29's served decode
            def half():
                return i420_to_rgb_flat(i420_half)

            half_turns = _time_turns(
                torch, {"kernel": half, "plain": lambda: i420_to_rgb_flat_reference(i420_half)},
                iters)
            n_px = i420_half.shape[0] * 512 * 1024
            extra["decode_512x1024"] = {
                "shape": list(i420_half.shape), "turns": half_turns,
                "ms": min(half_turns["kernel"]), "device_ms": _device_ms(torch, half)[0],
                "plain_ms": min(half_turns["plain"]),
                "bound_ms": _bound(i420_half.numel() + 3 * n_px, 9 * n_px, "f32")[0]}
        device_ms, extra["device_kernels"] = _device_ms(torch, kern)
        if ops is None:  # K6: issued f32 instructions at the lane rate
            ops_ms = K6_INSTRUCTIONS * 81 * ks.numel() / lane_rate * 1e3
            bytes_ms = nbytes / PEAK_BYTES_S * 1e3
            bound = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
            extra["issued_per_pixel_shift"] = K6_INSTRUCTIONS
        else:
            bound = _bound(nbytes, ops, "f32")
        row = {"ms": min(turns["kernel"]), "device_ms": device_ms,
               "plain_ms": min(turns["plain"]),
               "library_ms": min(turns["library"]) if library is not None else None,
               "bound_ms": bound[0], "bound_by": bound[1]}
        times[name] = row
        _emit(phase="new_kernel_time", kernel=name, id=FLOW_ENTRIES[name][0], turns=turns, **row,
              **extra, card=smi)
    del fb, ids_full, luma, ks, i420, i420_half
    torch.cuda.empty_cache()
    return times


def _k8_every_triple(torch, dev):
    """(64, 768, 512) uint8 I420 holding every (Y, U, V) triple once: the
    256x256 chroma planes hold every (U, V) pair (U the chroma row, V the
    column), and the four Y values of each 2x2 block are 4f .. 4f + 3 in
    frame f, so across the 64 frames each block's Y takes all 256 levels."""
    f = torch.arange(64, device=dev, dtype=torch.int32).view(64, 1, 1, 1, 1)
    quad = torch.tensor([[0, 1], [2, 3]], device=dev, dtype=torch.int32).view(1, 1, 2, 1, 2)
    y = (4 * f + quad).expand(64, 256, 2, 256, 2).reshape(64, 512, 512)
    c = torch.arange(256, device=dev, dtype=torch.int32)
    u = c.view(256, 1).expand(256, 256).reshape(128, 512)
    v = c.view(1, 256).expand(256, 256).reshape(128, 512)
    return torch.cat([y, u.expand(64, 128, 512), v.expand(64, 128, 512)], 1).to(torch.uint8)


def _k7_vector_cases(torch, np, dev, gen, rng) -> dict:
    """K7's vector-path cases at scale 8, block 16: label -> (ids, dy, dx,
    scale, block).  Every block's dx odd (sources 8 bytes off 16-byte
    alignment); odd and +-4 shifts on the first and last block columns
    (dx = +-1 and +-3 there put one half of a vector's source in the frame
    and the other's out); neighbouring blocks' dy differing with sources
    crossing the seam; shifts outside the radius; a 640-px width (a multiple
    of 128, not of 256)."""
    ids = torch.randint(0, 19, (4, 512, 2048), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    shape = (4, 4, 16)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    edge = rng.choice([-4, 4], size=shape)
    edge[..., 0] = rng.choice([1, 3, 4], size=shape[:2])
    edge[..., -1] = rng.choice([-1, -3, -4], size=shape[:2])
    seam_dy = np.where(np.arange(16) % 2 == 0, 3, -2) * np.ones(shape, np.int64)
    ids640 = torch.randint(0, 19, (4, 256, 640), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.uint8)
    return {
        "odd dx (scale 8)": (ids, t(rng.integers(-4, 5, size=shape)),
                             t(rng.choice([-3, -1, 1, 3], size=shape)), 8, 16),
        "edge halves (scale 8)": (ids, t(rng.integers(-4, 5, size=shape)), t(edge), 8, 16),
        "dy seams (scale 8)": (ids, t(seam_dy), t(rng.choice([-2, -1, 1, 2], size=shape)), 8,
                               16),
        "out of radius (scale 8)": (ids, t(rng.choice([-6, -5, -1, 1, 5, 6], size=shape)),
                                    t(rng.choice([-7, -5, -4, 0, 4, 5, 7], size=shape)), 8, 16),
        "640-px width (scale 8)": (ids640, t(rng.integers(-6, 7, size=(4, 2, 5))),
                                   t(rng.integers(-6, 7, size=(4, 2, 5))), 8, 16),
    }


def _zero_counts(torch, *fns):
    torch.cuda.synchronize()
    for f in fns:
        f.launches = 0


WARP_PARTS = (  # phase 26's profile: part -> kernel-name fragments
    ("K6", ("block_shifts",)), ("K7", ("warp_ids",)), ("K3", ("frame_deltas",)),
    ("pooled_luma reductions", ("reduce_kernel",)),
    ("gathers", ("indexSelect", "index_select", "gather", "index_elementwise")),
    ("elementwise and copies", ("elementwise_kernel", "Memcpy", "Memset")))


def _warp_profile(torch, seg, x) -> dict:
    """Device ms by part (``WARP_PARTS``, the rest apart) of one interval
    batch ``seg._program(x)`` with temporal_warp and one without it (nearest
    reuse in both), and the warp's cost part by part (the difference)."""
    out = {}
    for label, warp in (("warp", True), ("no_warp", False)):
        seg.temporal_warp = warp
        times = _device_kernel_times(torch, lambda: seg._program(x))
        parts = dict.fromkeys([p for p, _ in WARP_PARTS] + ["rest"], 0.0)
        for name, ms in times.items():
            part = next((p for p, frags in WARP_PARTS if any(f in name for f in frags)), "rest")
            parts[part] += ms
        top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
        out[label] = {"total_ms": sum(times.values()), "by_part": parts,
                      "top": [[k[:80], v] for k, v in top]}
    seg.temporal_warp = True
    out["warp_cost_ms"] = out["warp"]["total_ms"] - out["no_warp"]["total_ms"]
    out["warp_cost_by_part"] = {p: out["warp"]["by_part"][p] - out["no_warp"]["by_part"][p]
                                for p in out["warp"]["by_part"]}
    return out


def _interval_warp_full(torch, np, dev, params, state, spec, frames, smi) -> dict:
    """Phase 26: interval 4 with temporal_nearest and temporal_warp, dense
    bf16, batch 32, 1024x2048, the 32 shapes frames: run() with every count
    zeroed just before and read just after (a batch: B1 1, K3 1, K6 1, K7 1);
    each keyframe's ids equal ``ids_for`` on the same 8 keyframes, bit for
    bit (the same batch of 8: in bf16 cuDNN may pick another algorithm at
    another batch size); the device rate at batch 32; device ms by kernel
    of one batch of the 32 frames with the warp and one without it."""
    from tpuseg_torch.ops.temporal import frame_deltas
    from tpuseg_torch.ops.upsample import upsample_argmax
    from tpuseg_torch.video.flow import estimate_block_shifts, warp_ids
    from tpuseg_torch.video.pipeline import VideoSegmenter

    seg = VideoSegmenter(params, state, spec, MEAN, STD, device=dev, compute_dtype=torch.bfloat16,
                         batch=32, temporal_interval=4, temporal_nearest=True,
                         temporal_warp=True)
    counters = (upsample_argmax, frame_deltas, estimate_block_shifts, warp_ids)
    _zero_counts(torch, *counters)
    res = seg.run(frames, need_color=False)
    torch.cuda.synchronize()
    got = {f.__name__: f.launches for f in counters}
    forwards = 1 + -(-len(frames) // 32)
    want = {f.__name__: forwards for f in counters}
    ids = res["ids"]
    with torch.inference_mode():
        keys = seg.ids_for(torch.from_numpy(np.stack(frames[::4]).reshape(8, FULL[0], -1)).to(dev))
    keyed = bool(np.array_equal(ids[::4], keys.cpu().numpy()))
    moved = float(np.mean([(ids[i] != ids[i - i % 4]).mean() for i in range(len(ids))]))
    fps = seg.benchmark_device_fps(FULL, inner=8, reps=2)
    x = torch.from_numpy(np.stack(frames[:32]).reshape(-1, FULL[0], FULL[1] * 3)).to(dev)
    profile = _warp_profile(torch, seg, x)
    del x
    del seg
    torch.cuda.empty_cache()
    row = {"launches": got, "want": want, "keyframes_equal_ids_for": keyed,
           "share_of_ids_moved_by_reuse": moved, "run_fps": res["fps"], "device_fps": fps,
           "profile": profile}
    _emit(phase="interval_nearest_warp_full", size=list(FULL), dtype="bfloat16", batch=32,
          interval=4, frames=res["frames"], **row, card=smi)
    if got != want or not keyed or ids.shape != (len(frames),) + FULL:
        raise AssertionError(f"interval nearest+warp: launches {got} (want {want}), "
                             f"keyframes equal {keyed}")
    return row


def _budget_warp_full(torch, np, dev, masked, state, spec, gplans, calib, inputs, smi) -> dict:
    """Phase 27: phase 23's sparse_int8_budget8 with temporal_nearest and
    temporal_warp: run() with counts zeroed just before and read just after
    (a batch: B3 13, B1 1, the K3 + K4 launch 1, K6 1, K7 1; K3 and K4
    alone 0), the promotions equal to the CPU plain selection (nearest and
    warp leave the choice as it is), ``benchmark_adaptive_device_fps``."""
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_apply_q
    from tpuseg_torch.ops.temporal import budget_select, frame_deltas, frame_deltas_budget
    from tpuseg_torch.ops.upsample import upsample_argmax
    from tpuseg_torch.video.flow import estimate_block_shifts, warp_ids
    from tpuseg_torch.video.pipeline import VideoSegmenter

    frames = list(inputs["frames"])
    seg = VideoSegmenter(masked, state, spec, MEAN, STD, device=dev, compute_dtype=torch.bfloat16,
                         batch=BUDGET_BATCH, exec_plans=gplans, quantize=True, calib_frames=calib,
                         temporal_thresh=inputs["thresh"], temporal_budget=BUDGET_K,
                         temporal_nearest=True, temporal_warp=True)
    counters = (fused_sparse_conv_apply_q, upsample_argmax, frame_deltas, budget_select,
                frame_deltas_budget, estimate_block_shifts, warp_ids)
    _zero_counts(torch, *counters)
    res = seg.run(frames, need_color=False)
    torch.cuda.synchronize()
    got = {f.__name__: f.launches for f in counters}
    forwards = 1 + len(frames) // BUDGET_BATCH
    want = {f.__name__: forwards for f in counters}
    want["fused_sparse_conv_apply_q"] = B3_PER_FORWARD["gathered"] * forwards
    want["frame_deltas"] = want["budget_select"] = 0
    assert res["ids"].shape == (len(frames),) + FULL
    dev_res = seg.benchmark_adaptive_device_fps(frames, reps=2)
    del seg
    torch.cuda.empty_cache()
    row = {"launches": got, "want": want, "promoted": res["promoted"],
           "promoted_cpu": inputs["promoted_cpu"], "run_fps": res["fps"],
           "device_fps": dev_res["device_fps"], "device_promotion_rate": dev_res["promotion_rate"]}
    _emit(phase="budget_nearest_warp_full", config=SERVED_CONFIG, lowering="gathered",
          size=list(FULL), batch=BUDGET_BATCH, budget=BUDGET_K, frames=len(frames), **row,
          card=smi)
    if got != want or res["promoted"] != inputs["promoted_cpu"]:
        raise AssertionError(f"budget nearest+warp: launches {got} (want {want}), promoted "
                             f"{res['promoted']} vs the CPU selection {inputs['promoted_cpu']}")
    return row


def _sequential_full(torch, np, dev, params, state, spec, frames, smi) -> dict:
    """Phase 28: the sequential adaptive mode, dense bf16, batch 8, the 32
    shapes frames, threshold ``drift_threshold`` of the first 8: the
    promotions equal K5's plain version on the CPU (chained over the
    batches from a fresh carry); each batch one forward of exactly its
    promoted frames (recorded), K5 launched once a batch and B1 once a
    batch that promotes; the adaptive device rate."""
    from tpuseg_torch.ops.temporal import keyframe_select, keyframe_select_reference
    from tpuseg_torch.ops.upsample import upsample_argmax
    from tpuseg_torch.video.autotune import drift_threshold
    from tpuseg_torch.video.pipeline import VideoSegmenter

    h, w = FULL
    thresh = drift_threshold(frames[:SEQ_BATCH])[0]
    kf, nk, cpu_counts = torch.zeros((h, w * 3), dtype=torch.uint8), torch.zeros(
        1, dtype=torch.int32), []
    for i in range(0, len(frames), SEQ_BATCH):
        fb = torch.from_numpy(np.stack(frames[i:i + SEQ_BATCH]).reshape(SEQ_BATCH, h, -1))
        _, _, _, _, count, nk, kf = keyframe_select_reference(fb, kf, nk, thresh)
        cpu_counts.append(int(count))
    seg = VideoSegmenter(params, state, spec, MEAN, STD, device=dev, compute_dtype=torch.bfloat16,
                         batch=SEQ_BATCH, temporal_thresh=thresh)
    sizes = []
    orig = seg.ids_for
    seg.ids_for = lambda x: sizes.append(x.shape[0]) or orig(x)
    _zero_counts(torch, keyframe_select, upsample_argmax)
    res = seg.run(frames, need_color=False)
    torch.cuda.synchronize()
    got = {"keyframe_select": keyframe_select.launches, "upsample_argmax": upsample_argmax.launches}
    seg.ids_for = orig
    batches = len(frames) // SEQ_BATCH
    run_sizes = [c for c in [cpu_counts[0]] + cpu_counts if c]  # the untimed first call + batches
    want = {"keyframe_select": batches + 1, "upsample_argmax": len(run_sizes)}
    dev_res = seg.benchmark_adaptive_device_fps(frames, reps=2)
    del seg
    torch.cuda.empty_cache()
    row = {"launches": got, "want": want, "forward_sizes": sizes, "cpu_promoted": cpu_counts,
           "promoted": res["promoted"], "promotion_rate": res["promotion_rate"], "thresh": thresh,
           "run_fps": res["fps"], "device_fps": dev_res["device_fps"],
           "device_promotion_rate": dev_res["promotion_rate"]}
    _emit(phase="sequential_full", size=list(FULL), dtype="bfloat16", batch=SEQ_BATCH,
          frames=res["frames"], **row, card=smi)
    if got != want or sizes != run_sizes or res["promoted"] != sum(cpu_counts):
        raise AssertionError(f"sequential mode: launches {got} (want {want}), forwards {sizes} "
                             f"(want {run_sizes}), promoted {res['promoted']} vs the CPU "
                             f"{sum(cpu_counts)}")
    return row


def _transport_full(torch, np, dev, params, state, spec, smi) -> dict:
    """Phase 29: transport="yuv420" with target_size from a 512x1024 decode
    to 1024x2048 and ids_bits=5, dense bf16, run() at batch 8 over 32 shapes
    frames made at decode size: K8 (every launch on its vector path) and B1
    once a batch; the unpacked ids equal the unpacked-free run's bit for
    bit; device_outputs' color and overlay equal their reconstruction from
    the same ids and frames (the palette gather, and the blend of the
    frames through K8 and the device resize); the bytes each batch ships up (1.5 a decode pixel) and down,
    and run()'s host work a batch (RGB -> I420, the unpack)."""
    from tpuseg_torch.data.shapes import shapes_video
    from tpuseg_torch.ops.idpack import unpack_ids
    from tpuseg_torch.ops.upsample import upsample_argmax
    from tpuseg_torch.video.pipeline import VideoSegmenter, resize_frames
    from tpuseg_torch.video.yuv import i420_to_rgb_flat, rgb_to_i420

    dec = (512, 1024)
    frames = list(shapes_video(32, dec, seed=0)[0])
    kw = dict(device=dev, compute_dtype=torch.bfloat16, batch=8, target_size=FULL,
              transport="yuv420")
    seg = VideoSegmenter(params, state, spec, MEAN, STD, ids_bits=5, **kw)
    _zero_counts(torch, i420_to_rgb_flat, upsample_argmax)
    i420_to_rgb_flat.vector_launches = 0
    packed = seg.run(frames, need_color=False)
    torch.cuda.synchronize()
    got = {"i420_to_rgb_flat": i420_to_rgb_flat.launches,
           "i420_to_rgb_flat_vector": i420_to_rgb_flat.vector_launches,
           "upsample_argmax": upsample_argmax.launches}
    forwards = 1 + len(frames) // 8  # every served K8 launch on its vector path
    want = {"i420_to_rgb_flat": forwards, "i420_to_rgb_flat_vector": forwards,
            "upsample_argmax": forwards}
    plain = VideoSegmenter(params, state, spec, MEAN, STD, **kw).run(frames, need_color=False)
    same_ids = bool(np.array_equal(packed["ids"], plain["ids"]))
    outs = {}
    for overlay in (False, True):
        s = VideoSegmenter(params, state, spec, MEAN, STD, device_outputs=True,
                           want_overlay=overlay, **kw)
        outs[overlay] = s.run(frames[:8])
    ids8 = outs[False]["ids"]
    color = seg.palette_np[ids8]
    with torch.inference_mode():
        x = torch.from_numpy(rgb_to_i420(np.stack(frames[:8]))).to(dev)
        rgb = resize_frames(i420_to_rgb_flat(x), FULL).cpu().numpy().reshape(8, *FULL, 3)
    color_ok = bool(np.array_equal(outs[False]["color"], color)
                    and np.array_equal(outs[True]["ids"], ids8))
    overlay_ok = bool(np.array_equal(outs[True]["color"], rgb // 2 + color // 2))
    batches = len(frames) // 8
    # run()'s host work a batch: RGB -> I420 of an RGB source (a decoder
    # emitting I420 skips it) and the 5-bit unpack
    t0 = time.perf_counter()
    rgb_to_i420(np.stack(frames[:8]))
    t1 = time.perf_counter()
    unpack_ids(np.zeros((8, FULL[0], FULL[1] * 5 // 8), np.uint8), 5)
    t2 = time.perf_counter()
    row = {"launches": got, "want": want, "ids_equal_unpacked_run": same_ids,
           "host_rgb_to_i420_ms": (t1 - t0) * 1e3, "host_unpack_ids_ms": (t2 - t1) * 1e3,
           "device_color_equal": color_ok, "device_overlay_equal": overlay_ok,
           "h2d_bytes_per_batch": packed["h2d_bytes"] // batches,
           "h2d_bytes_rgb_target_per_batch": 8 * FULL[0] * FULL[1] * 3,
           "d2h_bytes_per_batch": packed["d2h_bytes"] // batches,
           "d2h_bytes_unpacked_per_batch": plain["d2h_bytes"] // batches,
           "run_fps": packed["fps"], "run_fps_unpacked": plain["fps"],
           "run_fps_device_outputs_8": outs[False]["fps"]}
    _emit(phase="transport_full", decode=list(dec), target=list(FULL), dtype="bfloat16", batch=8,
          frames=packed["frames"], ids_bits=5, **row, card=smi)
    del seg, outs
    torch.cuda.empty_cache()
    if (got != want or not (same_ids and color_ok and overlay_ok)
            or row["h2d_bytes_per_batch"] != 8 * dec[0] * dec[1] * 3 // 2
            or row["d2h_bytes_per_batch"] * 8 != row["d2h_bytes_unpacked_per_batch"] * 5):
        raise AssertionError(f"transport run: {row}")
    return row


def _cli_autotune(smi) -> dict:
    """Phase 30: the CLI once, as a user runs it: autotuning with warped
    reuse on 32 shapes frames at 1024x2048, batch 8; its temporal_autotune
    event and result line must parse."""
    import os

    cmd = [sys.executable, "-m", "tpuseg_torch.cli.seg_video", "--video", "shapes", "--size",
           "1024x2048", "--frames", "32", "--batch", "8", "--temporal-autotune", "0.9",
           "--temporal-warp"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"seg_video exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    event = next(ln for ln in lines if ln.get("event") == "temporal_autotune")
    line = lines[-1]
    _emit(phase="cli_autotune", command=" ".join(cmd[1:]), seconds=round(seconds, 1),
          choice=event["choice"], table=event["table"], result=line, card=smi)
    if "frames" not in line or line["frames"] != 32 or "autotune_choice" not in line:
        raise AssertionError(f"seg_video's result line: {line}")
    return {"event": event, "result": line}


# phases 31-33: segmentation training, the README's command (crop 512, batch
# 8, bf16) on --synthetic data: dense, masked and --sparse-exec
TRAIN_CROP = 512
TRAIN_BATCH = 8
TRAIN_SAMPLES = 64   # --synthetic 64: 8 train steps an epoch
TRAIN_STRUCTS = 10   # convs of block128reg_87.50 that --sparse-exec runs through B2
TRAIN_TIMED = "layer.6.1.conv2"  # the struct timed in phase 31
TRAIN_ENTRIES = {  # wrapper -> the role in which tpuseg's trainer launches B2
    "sparse_conv_train_forward": "tpuseg/ops/sparse_train.py:225-227 (forward)",
    "sparse_conv_train_dgrad": "tpuseg/ops/sparse_train.py:239 (dgrad)",
}
# phase 31's tile-geometry cases, (n, h, w): B2's bf16 tile is R =
# min(floor(256 / w), h) whole rows when w < 256 (``b2_tile_rows``), else
# a 256-pixel row segment; each runs at (k, d) in TILE_KD
TILE_CASES = (
    (2, 5, 64),     # h not a multiple of R = 4
    (2, 9, 96),     # w does not divide 256: R = 2, 192 of 256 tile rows
    (2, 7, 112),    # the maps of a crop-896 step
    (2, 6, 128),
    (1, 4, 8),      # floor(256 / 8) = 32 rows past h = 4: R = 4
    (1, 3, 200),    # R = 1
    (1, 2, 256),    # R = 1, the served width
    (1, 2, 300),    # R = 1, two row segments
)
TILE_KD = ((3, 1), (3, 4), (1, 1))
TRAIN_CLI = ["train", "--synthetic", str(TRAIN_SAMPLES), "-s", str(TRAIN_CROP),
             "--batch-size", str(TRAIN_BATCH), "--eval-every", "1"]
TRAIN_MASKED = ["--mc-pruning", "--pr-static", "--pr-config-path", SERVED_CONFIG]


def _train_case(torch, np, name, plan, wt, mask, x, dy) -> dict:
    """One struct on the card against its plain version: B2's forward (y)
    and dgrad (dx) within 2*K*eps of ``fused_sparse_conv_reference`` on the
    same packings, and of cuDNN's f64 conv and dgrad of the bf16 masked
    weight (K the dense contraction: these hold the packing and transpose
    indices); the f32 wgrad within 2*K*eps of the dense conv's weight
    gradient of the same bf16 operands on the mask; and the autograd route
    (``sparse_conv_train``) launching B2 once in the forward and once in the
    backward, its y within 2*K*eps of the f64 conv, its dx and dW (cast to
    bf16 by the route) within bf16 rounding of the f64 dgrad and the dense
    weight gradient, dW 0 off the mask."""
    from tpuseg_torch.ops import sparse_train as tst
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_apply, fused_sparse_conv_reference

    st = plan.struct
    n, h, w, _ = x.shape
    info = {"case": name, "shape": [n, h, w, st.cin], "cout": st.cout, "kernel": st.kernel,
            "dilation": st.dilation, "s": st.s, "st": st.st}
    vals = tst.pack_vals(wt, plan, torch.bfloat16)
    vals_t = tst._transpose_vals(vals, plan)
    dyc = dy.to(torch.bfloat16)
    k2 = st.kernel * st.kernel
    y_kernel = tst.sparse_conv_train_forward(x, vals, plan)
    dx_kernel = tst.sparse_conv_train_dgrad(dyc, vals_t, plan)
    y_err = _close(torch, np, "train_forward_vs_plain", y_kernel,
                   fused_sparse_conv_reference(x, tst._fwd_plan(vals, plan)), k2 * st.s * 128,
                   **info)
    dx_err = _close(torch, np, "train_dgrad_vs_plain", dx_kernel,
                    fused_sparse_conv_reference(dyc, tst._bwd_plan(vals_t, plan)),
                    k2 * st.st * 128, **info)
    pad = st.dilation * (st.kernel - 1) // 2
    # the dense conv and dgrad of the same bf16 operands, exact in f64
    w64 = wt.to(torch.bfloat16).double() * mask
    x64 = x.double().permute(0, 3, 1, 2).contiguous()
    dy64 = dyc.double().permute(0, 3, 1, 2).contiguous()
    y_dense = torch.nn.functional.conv2d(x64, w64, None, 1, pad, st.dilation)
    y_dense = y_dense.permute(0, 2, 3, 1).float()
    dx_dense = torch.nn.grad.conv2d_input(tuple(x64.shape), w64, dy64, 1, pad, st.dilation)
    dx_dense = dx_dense.permute(0, 2, 3, 1).float()
    del x64, dy64
    y_dense_err = _close(torch, np, "train_forward_vs_dense", y_kernel, y_dense,
                         k2 * st.cin, **info)
    dx_dense_err = _close(torch, np, "train_dgrad_vs_dense", dx_kernel, dx_dense,
                          k2 * st.cout, **info)
    dw_dense = torch.nn.grad.conv2d_weight(
        x.float().permute(0, 3, 1, 2), tuple(wt.shape), dyc.float().permute(0, 3, 1, 2), 1, pad,
        st.dilation) * mask
    dw_err = _close(torch, np, "train_wgrad_vs_dense", tst.sparse_wgrad(x, dyc, plan),
                    tst.pack_vals(dw_dense, plan, torch.float32), n * h * w, **info)
    # the autograd route
    fwd, dgrad = tst.sparse_conv_train_forward, tst.sparse_conv_train_dgrad
    _zero_counts(torch, fwd, dgrad, fused_sparse_conv_apply)
    xl, wl = x.float().requires_grad_(), wt.clone().requires_grad_()
    y = tst.sparse_conv_train(xl, wl, plan, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    in_forward = (fwd.launches, dgrad.launches)
    y.backward(dy)
    torch.cuda.synchronize()
    in_all = (fwd.launches, dgrad.launches, fused_sparse_conv_apply.launches)
    if in_forward != (1, 0) or in_all != (1, 1, 0):
        raise AssertionError(f"{name}: sparse_conv_train launched B2 (forward, dgrad) "
                             f"{in_forward} in the forward and (forward, dgrad, apply) {in_all} "
                             "in all; want (1, 0) and (1, 1, 0)")
    _close(torch, np, "train_autograd_y_vs_dense", y.detach(), y_dense, k2 * st.cin, **info)
    off = float((wl.grad * (1 - mask)).abs().max())
    grad_rel = float((wl.grad - dw_dense).abs().max() / dw_dense.abs().max())
    # the route returns dx in bf16: its rounding (2^-8) and the f32 sum's order
    dx_rel = float((xl.grad - dx_dense).abs().max() / dx_dense.abs().max())
    dx_tol = 2.0 ** -8 + 2 * k2 * st.cout * float(np.finfo(np.float32).eps)
    if off != 0.0 or not grad_rel <= 2.0 ** -8 or not dx_rel <= dx_tol:
        raise AssertionError(f"{name}: autograd dW off the mask {off}, vs the dense gradient "
                             f"{grad_rel} (limit 2^-8), dx vs the dense dgrad {dx_rel} "
                             f"(limit {dx_tol})")
    return {"y": y_err, "dx": dx_err, "dw": dw_err, "y_vs_dense": y_dense_err,
            "dx_vs_dense": dx_dense_err, "autograd_dw_rel": grad_rel, "autograd_dx_rel": dx_rel}


def _b2_grid(n, h, w, cout) -> tuple[int, int]:
    """(R, CTAs) of B2's bf16 launch on an (n, h, w) map with ``cout``
    output channels, as ``csrc/sparse_conv.cu`` computes them."""
    from tpuseg_torch.ops.sparse_conv import B2_TILE_PIXELS, b2_tile_rows

    r = b2_tile_rows(w, h)
    return r, n * -(-h // r) * -(-w // B2_TILE_PIXELS) * (cout // 128)


def _tile_rows_checks(torch, np, plan, x) -> dict:
    """B2 at rows per tile the wrapper names: every R the C entry point must
    reject raises (R < 1, or R > 1 with R * w > 256), and the legal R
    other than the wrapper's choice agree with the plain version."""
    from tpuseg_torch.ops import sparse_conv as tsc

    w, tile = x.shape[2], tsc.B2_TILE_PIXELS
    bad = [0, -1, tile // w + 1]
    for r in bad:
        try:
            tsc._launch_b2(x, plan, plan.kernel, plan.dilation, plan.cout, rows_per_tile=r)
        except RuntimeError:
            continue
        raise AssertionError(f"B2 took rows_per_tile={r} at w={w} without raising")
    want = tsc.fused_sparse_conv_reference(x, plan)
    errs = {r: _close(torch, np, "b2_forced_rows_vs_plain",
                      tsc._launch_b2(x, plan, plan.kernel, plan.dilation, plan.cout,
                                     rows_per_tile=r),
                      want, plan.kernel ** 2 * plan.s * 128, rows_per_tile=r,
                      shape=list(x.shape))
            for r in range(1, tile // w + 1) if r != tsc.b2_tile_rows(w, x.shape[1])}
    _emit(phase="b2_rows_per_tile_rejected", w=w, rejected=bad, legal_checked=list(errs))
    return errs


def _train_kernels(torch, np, dev, rng, smi) -> dict:
    """Phase 31: ``sparse_conv_train`` on the card against its plain version
    on each struct ``build_sparse_train_structs`` makes from
    block128reg_87.50 at its crop-512, batch-8 activation shape (every
    eligible conv of DRN-D-22 runs at output stride 8: 64x64) and on small
    cases with k in {1, 3} and d in {1, 2, 4} (one with an out-block of no
    in-block); a live tile of all-zero weights, then of nonzero weights,
    under one plan; a strided dy raising; the tile geometry of ``TILE_CASES``
    at each (k, d) of ``TILE_KD`` (R and the grid on a line before each);
    out-of-range rows per tile raising, and the legal ones the wrapper does
    not choose agreeing with the plain version; B2's forward and dgrad at
    ``TRAIN_TIMED``'s shape in turns against their plain versions and cuDNN's
    dense bf16 conv and dgrad of the masked weight."""
    import torch.nn.functional as F

    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.ops import sparse_train as tst
    from tpuseg_torch.ops.sparse_conv import b2_tile_rows, fused_sparse_conv_reference
    from tpuseg_torch.sparsity import create_masker

    params, _, spec = init_drnseg(0, ARCH, CLASSES)
    masks = create_masker(SERVED_CONFIG, seed=0).generate_masks(params)
    structs, report = tst.build_sparse_train_structs(masks, spec)
    if len(structs) != TRAIN_STRUCTS:
        raise AssertionError(f"{len(structs)} sparse-train structs, want {TRAIN_STRUCTS}: "
                             f"{report}")
    hw = TRAIN_CROP // 8
    cases = [(name, st, masks[f"{name}.weight"], (TRAIN_BATCH, hw, hw))
             for name, st in structs.items()]
    for k, d in ((1, 1), (3, 1), (3, 2), (3, 4)):
        m = _b2_mask(rng, k, 384, 256, 2, dead_out=(d == 2))
        cases.append((f"k{k}_d{d}", tst.plan_sparse_conv_train(m.transpose(2, 3, 1, 0),
                                                                dilation=d),
                       torch.from_numpy(m), (2, 24, 40)))
    for k, d in TILE_KD:
        m = _b2_mask(rng, k, 384, 256, 2)
        st = tst.plan_sparse_conv_train(m.transpose(2, 3, 1, 0), dilation=d)
        cases += [(f"tile_{n}x{h}x{w}_k{k}_d{d}", st, torch.from_numpy(m), (n, h, w))
                  for n, h, w in TILE_CASES]
    g = torch.Generator(device=dev).manual_seed(31)
    errs, kept = {}, {}
    for name, st, mask, (n, h, w) in cases:
        if name.startswith("tile_"):
            r, fwd_ctas = _b2_grid(n, h, w, st.cout)
            _emit(phase="b2_tile_geometry", case=name, shape=[n, h, w], rows_per_tile=r,
                  grid_forward=fwd_ctas, grid_dgrad=_b2_grid(n, h, w, st.cin)[1])
        plan, mask = st.to(dev), mask.to(dev)
        k2 = st.kernel * st.kernel
        wt = torch.randn((st.cout, st.cin, st.kernel, st.kernel), generator=g, device=dev)
        wt = wt * (2.0 / (k2 * st.cin)) ** 0.5 * mask
        x = torch.randn((n, h, w, st.cin), generator=g, device=dev).to(torch.bfloat16)
        dy = torch.randn((n, h, w, st.cout), generator=g, device=dev)
        errs[name] = _train_case(torch, np, name, plan, wt, mask, x, dy)
        if name == TRAIN_TIMED:
            kept = {"plan": plan, "wt": wt, "mask": mask, "x": x, "dy": dy}
    # a live tile of zero weights is still a step: the same plan stays right
    # once the tile's weights are nonzero
    plan, wt = kept["plan"], kept["wt"].clone()
    j, t, s = (int(v) for v in np.argwhere(plan.struct.nzsel != 0)[0])
    kb, (p, q) = int(plan.struct.rows[j, s]), divmod(t, plan.struct.kernel)
    tile = (slice(j * 128, (j + 1) * 128), slice(kb * 128, (kb + 1) * 128), p, q)
    zeroed = wt.clone()
    zeroed[tile] = 0.0
    for label, wv in (("zero_tile", zeroed), ("tile_refilled", wt)):
        errs[label] = _train_case(torch, np, f"{TRAIN_TIMED} {label}", plan, wv, kept["mask"],
                                  kept["x"], kept["dy"])
    # B2 checks dy's layout in the dgrad role too
    vals = tst.pack_vals(kept["wt"], plan, torch.bfloat16)
    vals_t = tst._transpose_vals(vals, plan)
    n, h, w, _ = kept["x"].shape
    strided = torch.randn((n, plan.struct.cout, h, w), device=dev, dtype=torch.bfloat16)
    if not _raises_on_strided(lambda: tst.sparse_conv_train_dgrad(
            strided.permute(0, 2, 3, 1), vals_t, plan)):
        raise AssertionError("the dgrad accepted a strided dy")
    forced = _tile_rows_checks(torch, np, tst._fwd_plan(vals, plan), kept["x"])
    # times at TRAIN_TIMED's shape
    st, x, dyc = plan.struct, kept["x"], kept["dy"].to(torch.bfloat16)
    fplan, bplan = tst._fwd_plan(vals, plan), tst._bwd_plan(vals_t, plan)
    pad = st.dilation * (st.kernel - 1) // 2
    w_b = kept["wt"].to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dyc.permute(0, 3, 1, 2)
    turns = _time_turns(torch, {
        "forward": lambda: tst.sparse_conv_train_forward(x, vals, plan),
        "forward_plain": lambda: fused_sparse_conv_reference(x, fplan),
        "forward_cudnn": lambda: F.conv2d(x_nchw, w_b, None, 1, pad, st.dilation),
        "dgrad": lambda: tst.sparse_conv_train_dgrad(dyc, vals_t, plan),
        "dgrad_plain": lambda: fused_sparse_conv_reference(dyc, bplan),
        "dgrad_cudnn": lambda: torch.nn.grad.conv2d_input(
            tuple(x_nchw.shape), w_b, dy_nchw, 1, pad, st.dilation),
    }, {"forward": 20, "forward_plain": 3, "forward_cudnn": 20, "dgrad": 20, "dgrad_plain": 3,
        "dgrad_cudnn": 20})
    pixels = n * h * w
    bounds = {"forward": _b2_bound(pixels, vals, plan.rows, st.cout),
              "dgrad": _b2_bound(pixels, vals_t, plan.rows_t, st.cin)}
    out = {}
    for role, wrapper in (("forward", "sparse_conv_train_forward"),
                          ("dgrad", "sparse_conv_train_dgrad")):
        out[wrapper] = {"ms": min(turns[role]), "plain_ms": min(turns[f"{role}_plain"]),
                        "library_ms": min(turns[f"{role}_cudnn"]),
                        "bound_ms": bounds[role][0], "bound_by": bounds[role][1],
                        "max_abs_err": max(e["y" if role == "forward" else "dx"]
                                           for e in errs.values())}
    _emit(phase="train_kernels", structs=report, cases=len(cases), errors=errs,
          forced_rows_errors=forced, timed=TRAIN_TIMED, shape=[n, h, w, st.cin],
          rows_per_tile=b2_tile_rows(w, h), grid_forward=_b2_grid(n, h, w, st.cout)[1], ms=turns,
          bound_ms={r: b[0] for r, b in bounds.items()}, card=smi)
    return out


def _train_batch(torch, np, dev, n, size, seed):
    """``--synthetic``-style images and labels (5 % ignored) on ``dev``."""
    rng = np.random.default_rng(seed)
    images = rng.random((n, size, size, 3), dtype=np.float32)
    labels = rng.integers(0, CLASSES, size=(n, size, size)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.05] = 255
    return torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)


def _masks_zero(torch, ts, masks) -> bool:
    return all(float((ts.params[k] * (1 - m)).abs().max()) == 0.0 for k, m in masks.items())


def _trainer(torch, dev, params, state, spec, masks=None, sparse=False, remat=False,
             dtype=None, lr=0.01):
    """(train state on ``dev``, train step, eval step) of the port's trainer
    (``dtype`` None: f32)."""
    from tpuseg_torch.ops.sparse_train import build_sparse_train_structs
    from tpuseg_torch.train import (create_train_state, make_eval_step, make_seg_train_step,
                                    make_sgd)

    def on(tensors):
        return {k: v.to(dev) for k, v in tensors.items()}

    plans = ({k: st.to(dev) for k, st in build_sparse_train_structs(masks, spec)[0].items()}
             if sparse else None)
    tx = make_sgd(lambda _: lr, 0.9, 1e-4)
    ts = create_train_state(on(params), on(state), tx, on(masks) if masks else None)
    return (ts, make_seg_train_step(spec, tx, compute_dtype=dtype, remat=remat,
                                    sparse_plans=plans),
            make_eval_step(spec, "seg", compute_dtype=dtype))


def _profiled_steps(torch, ts, step, batch, iters) -> tuple:
    """(train state, profile) of ``iters`` more steps under ``torch.profiler``
    (after one profiled step that is not read) with CUDA events recorded
    inside the same window: the device's busy ms a step (the sum of its
    kernels' and copies' times), the window's wall ms a step, its idle
    share 1 - busy/wall (not clamped: on one stream busy cannot exceed
    wall, and ``busy_exceeds_wall`` says if it did), and the 12 kernels with
    the most device time.  Only device activity is traced: tracing the
    host's ops too slowed these steps by up to half on the H100, so the
    window would no longer be the step it measures."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CUDA]
    # one step profiled first: a process's first profile pays the tracer's
    # set-up inside its window
    with torch.profiler.profile(activities=acts):
        ts, _m = step(ts, *batch)
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(iters):
            ts, _m = step(ts, *batch)
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end) / iters
    kernels: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3 / iters
    if not kernels:
        raise AssertionError("torch.profiler recorded no device time for the train steps")
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return ts, {"busy_ms_per_step": busy, "wall_ms_per_step": wall,
                "idle_share": 1 - busy / wall, "busy_exceeds_wall": busy > wall,
                "top_kernels_ms_per_step": [[k[:80], v] for k, v in top]}


def _timed_steps(torch, dev, ts, step, batch, masks=None, warmup=3, iters=5,
                 profile=False) -> dict:
    """ms a train step by CUDA events over ``iters`` steps after ``warmup``,
    the peak memory allocated over the timed steps, the last loss; the
    masked weights checked exactly 0 after each warm-up step and after the
    timed steps; B2's launches in the timed steps.  ``profile``: then
    ``iters`` steps more under ``_profiled_steps`` (masks checked after
    them too)."""
    from tpuseg_torch.ops import sparse_train as tst

    for _ in range(warmup):
        ts, m = step(ts, *batch)
        if masks and not _masks_zero(torch, ts, masks):
            raise AssertionError("a masked weight moved off 0")
    _zero_counts(torch, tst.sparse_conv_train_forward, tst.sparse_conv_train_dgrad)
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        ts, m = step(ts, *batch)
    end.record()
    end.synchronize()
    if masks and not _masks_zero(torch, ts, masks):
        raise AssertionError("a masked weight moved off 0")
    out = {"ms_per_step": start.elapsed_time(end) / iters,
           "peak_bytes": torch.cuda.max_memory_allocated(dev), "loss": float(m["loss"]),
           "b2_forward": tst.sparse_conv_train_forward.launches,
           "b2_dgrad": tst.sparse_conv_train_dgrad.launches}
    if profile:
        ts, out["profiled"] = _profiled_steps(torch, ts, step, batch, iters)
        if masks and not _masks_zero(torch, ts, masks):
            raise AssertionError("a masked weight moved off 0")
    return {"ts": ts, **out}


def _train_cli(argv) -> tuple[list, str]:
    """``python -m tpuseg_torch.cli.semantic_seg`` in this process: (its JSON
    lines, its whole output)."""
    import contextlib
    import io

    from tpuseg_torch.cli import semantic_seg

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        semantic_seg.main(argv)
    text = buf.getvalue()
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")], text


def _epoch_line(lines, epoch):
    line = next(ln for ln in lines if ln.get("epoch") == epoch and "train_loss" in ln)
    if not (math.isfinite(line["train_loss"]) and "val_miou" in line):
        raise AssertionError(f"epoch line {line}")
    return line


def _close_states(torch, np, label, got, want) -> None:
    """Params and BN state within ``tests/test_sparse_train.py``'s
    tolerances (rtol 2e-3, atol 5e-4)."""
    for part in ("params", "bn_state"):
        a, b = getattr(got, part), getattr(want, part)
        for k in b:
            np.testing.assert_allclose(a[k].float().cpu().numpy(), b[k].float().cpu().numpy(),
                                       rtol=2e-3, atol=5e-4, err_msg=f"{label}: {part} {k}")


def _dense_training(torch, np, dev, workdir, smi) -> dict:
    """Phase 32: the trainer's CLI, dense at full width (DRN-D-22, crop 512,
    batch 8, bf16, 8 steps and an evaluation), then resumed from its
    checkpoint for a second epoch; ms a step by CUDA events and the peak
    memory with and without --remat (bf16); f32: --remat's loss equal to
    the loss without it at full width and its peak lower, and one step on
    the card against the CPU at 64x64."""
    from tpuseg_torch.models.drnseg import init_drnseg

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    save = f"{workdir}/dense"
    lines, _ = _train_cli(TRAIN_CLI + ["--epochs", "1", "--save-dir", save])
    cli_peak = torch.cuda.max_memory_allocated(dev)
    epoch0 = _epoch_line(lines, 0)
    resumed, _ = _train_cli(TRAIN_CLI + ["--epochs", "2", "--resume", f"{save}/checkpoint.npz",
                                         "--save-dir", f"{workdir}/resume"])
    if [ln["epoch"] for ln in resumed if "train_loss" in ln] != [1]:
        raise AssertionError(f"the resumed run did not run epoch 1 alone: {resumed}")
    epoch1 = _epoch_line(resumed, 1)
    cli_s = time.perf_counter() - t0

    params, state, spec = init_drnseg(0, ARCH, CLASSES)
    batch = _train_batch(torch, np, dev, TRAIN_BATCH, TRAIN_CROP, 32)
    timed = {}
    for remat in (False, True):
        ts, step, _ = _trainer(torch, dev, params, state, spec, remat=remat,
                               dtype=torch.bfloat16)
        r = _timed_steps(torch, dev, ts, step, batch, profile=not remat)
        timed["remat" if remat else "plain"] = {k: v for k, v in r.items() if k != "ts"}
        del ts, step, r
        torch.cuda.empty_cache()
    # f32 at full width: --remat's loss and peak
    f32 = {}
    for remat in (False, True):
        ts, step, _ = _trainer(torch, dev, params, state, spec, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ts, m = step(ts, *batch)
        f32["remat" if remat else "plain"] = {"loss": float(m["loss"]),
                                              "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        del ts, step
        torch.cuda.empty_cache()
    if not (abs(f32["remat"]["loss"] - f32["plain"]["loss"]) <= 1e-6 * abs(f32["plain"]["loss"])
            and f32["remat"]["peak_bytes"] < f32["plain"]["peak_bytes"]
            and timed["remat"]["peak_bytes"] < timed["plain"]["peak_bytes"]):
        raise AssertionError(f"--remat: f32 {f32}, bf16 {timed}")
    # f32 parity: one step on the card against the CPU at 64x64
    small = _train_batch(torch, np, "cpu", 2, 64, 33)
    runs = {}
    for name in ("cuda", "cpu"):
        d = dev if name == "cuda" else torch.device("cpu")
        ts, step, _ = _trainer(torch, d, params, state, spec)
        runs[name] = step(ts, *(t.to(d) for t in small))
    loss_c, loss_h = float(runs["cuda"][1]["loss"]), float(runs["cpu"][1]["loss"])
    if not abs(loss_c - loss_h) <= 1e-4 * abs(loss_h):
        raise AssertionError(f"f32 train step loss on the card {loss_c}, on the CPU {loss_h}")
    _close_states(torch, np, "f32 card vs CPU", runs["cuda"][0], runs["cpu"][0])
    _emit(phase="train_dense", command=" ".join(TRAIN_CLI + ["--epochs", "1"]), epoch=epoch0, resumed_epoch=epoch1,
          cli_seconds=round(cli_s, 1), cli_peak_bytes=cli_peak, steps=timed,
          f32_full_width=f32, f32_parity={"loss_cuda": loss_c, "loss_cpu": loss_h,
                                          "size": [2, 64, 64]}, card=smi)
    return {"ms_per_step": timed["plain"]["ms_per_step"]}


def _sparse_training(torch, np, dev, workdir, smi) -> dict:
    """Phase 33: the README's masked command through the CLI with and
    without --sparse-exec (the counts zeroed just before the --sparse-exec
    run and read just after: B2 2 x 10 a step, in the forward and the
    dgrad, and none in its evaluation); ms a step by CUDA events of
    masked-dense and --sparse-exec (bf16), with B2's launches in those
    steps, masked weights exactly 0 and one evaluation launching no B2; f32
    at 64x64: the two trajectories agree over two steps."""
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.ops import sparse_train as tst
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_apply
    from tpuseg_torch.sparsity import create_masker

    fwd, dgrad = tst.sparse_conv_train_forward, tst.sparse_conv_train_dgrad
    steps = TRAIN_SAMPLES // TRAIN_BATCH
    lines, _ = _train_cli(TRAIN_CLI + ["--epochs", "1"] + TRAIN_MASKED
                          + ["--save-dir", f"{workdir}/masked"])
    masked_epoch = _epoch_line(lines, 0)
    _zero_counts(torch, fwd, dgrad, fused_sparse_conv_apply)
    lines, _ = _train_cli(TRAIN_CLI + ["--epochs", "1"] + TRAIN_MASKED
                          + ["--sparse-exec", "--save-dir", f"{workdir}/sparse"])
    torch.cuda.synchronize()
    launches = {"sparse_conv_train_forward": fwd.launches,
                "sparse_conv_train_dgrad": dgrad.launches,
                "fused_sparse_conv_apply": fused_sparse_conv_apply.launches}
    sparse_epoch = _epoch_line(lines, 0)
    report = next(ln["sparse_exec"] for ln in lines if "sparse_exec" in ln)
    want = TRAIN_STRUCTS * steps
    if (launches["sparse_conv_train_forward"], launches["sparse_conv_train_dgrad"],
            launches["fused_sparse_conv_apply"]) != (want, want, 0):
        raise AssertionError(f"--sparse-exec CLI launched {launches}; want {want} in the "
                             "forward and the dgrad, 0 served")
    if sparse_epoch["mean_weight_sparsity"] != masked_epoch["mean_weight_sparsity"]:
        raise AssertionError(f"weight sparsity {sparse_epoch} vs {masked_epoch}")

    params, state, spec = init_drnseg(0, ARCH, CLASSES)
    masks = create_masker(SERVED_CONFIG, seed=0).generate_masks(params)
    masks_dev = {k: v.to(dev) for k, v in masks.items()}
    batch = _train_batch(torch, np, dev, TRAIN_BATCH, TRAIN_CROP, 32)
    timed = {}
    for sparse in (False, True):
        ts, step, eval_step = _trainer(torch, dev, params, state, spec, masks, sparse,
                                       dtype=torch.bfloat16)
        r = _timed_steps(torch, dev, ts, step, batch, masks_dev, profile=True)
        per = (r["b2_forward"], r["b2_dgrad"])
        if per != ((TRAIN_STRUCTS * 5,) * 2 if sparse else (0, 0)):
            raise AssertionError(f"sparse={sparse}: B2 launched {per} in 5 steps")
        _zero_counts(torch, fwd, dgrad, fused_sparse_conv_apply)
        eval_step(r["ts"].params, r["ts"].bn_state, *batch)
        torch.cuda.synchronize()
        if fwd.launches or dgrad.launches or fused_sparse_conv_apply.launches:
            raise AssertionError("the evaluation launched B2")
        timed["sparse_exec" if sparse else "masked_dense"] = {
            k: v for k, v in r.items() if k != "ts"}
        del ts, step, r
        torch.cuda.empty_cache()
    # f32 at 64x64: the two trajectories over two steps at lr 0.005
    small = [_train_batch(torch, np, dev, 2, 64, 40 + i) for i in range(2)]
    traj = {}
    for sparse in (False, True):
        ts, step, _ = _trainer(torch, dev, params, state, spec, masks, sparse, lr=0.005)
        losses = []
        for b in small:
            ts, m = step(ts, *b)
            losses.append(float(m["loss"]))
            if not _masks_zero(torch, ts, masks_dev):
                raise AssertionError("a masked weight moved off 0")
        traj[sparse] = (ts, losses)
    np.testing.assert_allclose(traj[True][1], traj[False][1], rtol=1e-4)
    _close_states(torch, np, "f32 --sparse-exec vs masked dense", traj[True][0], traj[False][0])
    _emit(phase="train_sparse", command=" ".join(TRAIN_CLI + ["--epochs", "1"] + TRAIN_MASKED),
          sparse_exec=report,
          masked_epoch=masked_epoch, sparse_exec_epoch=sparse_epoch, cli_launches=launches,
          steps=timed, f32_losses={"masked_dense": traj[False][1], "sparse_exec": traj[True][1]},
          card=smi)
    return {"launches": launches, "ms_per_step": {k: v["ms_per_step"] for k, v in timed.items()}}


# phases 34-36: the trained-weights fidelity tool at its defaults (DRN-D-22,
# train size 128, batch 8, lr 0.05, up to 800 steps, 300 recovery steps, a
# 96-frame 128x256 video at 4 px/frame, serve batch 8), remat_mem, and
# seg_video serving the tool's checkpoint
FIDELITY_STAGES = (
    ("train", []),
    ("fidelity", []),
    ("compress", ["--variants", "block128reg_87.5", "--sparse-exec"]),
    ("compose", []),
    ("budget_curve", ["--speeds", "1.0,4.0"]),
)
FIDELITY_TRAIN_MIN = 60.0  # val mIoU (percent); tpuseg reached 86.95, a pruned model 10.66
INT8_TRAINED_MIN = 0.97    # int8 ids against their exact baseline (ROADMAP C's int8 floor)
PRETRAINED_SIZE = (128, 256)


def _counters():
    """{name: wrapper} of every launch counter on the served and trained
    paths (B1, B2 served and in training, B3's entry points and its two
    kernels, the stem route, the quantize pass, K3-K8 and the K3 + K4
    launch)."""
    from tpuseg_torch.ops import sparse_train as tst
    from tpuseg_torch.ops.sparse_conv import (
        fused_sparse_conv_apply, fused_sparse_conv_apply_q, fused_sparse_conv_q_bias_relu,
        quantize_activation, sparse_conv_q_kernel, sparse_conv_q_narrow_kernel)
    from tpuseg_torch.ops.temporal import (
        budget_select, frame_deltas, frame_deltas_budget, keyframe_select)
    from tpuseg_torch.ops.upsample import upsample_argmax
    from tpuseg_torch.video.flow import estimate_block_shifts, warp_ids
    from tpuseg_torch.video.yuv import i420_to_rgb_flat

    fns = (upsample_argmax, fused_sparse_conv_apply, tst.sparse_conv_train_forward,
           tst.sparse_conv_train_dgrad, fused_sparse_conv_apply_q, fused_sparse_conv_q_bias_relu,
           sparse_conv_q_kernel, sparse_conv_q_narrow_kernel,
           quantize_activation, frame_deltas, budget_select, frame_deltas_budget,
           keyframe_select, estimate_block_shifts, warp_ids, i420_to_rgb_flat)
    return {f.__name__: f for f in fns}


def _quiet(fn, argv):
    """``fn(argv)`` with its standard output captured: (its result, the
    text); the text's end goes to stderr when it raises."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn(argv)
    except BaseException:
        print(buf.getvalue()[-6000:], file=sys.stderr, flush=True)
        raise
    return out, buf.getvalue()


def _trained_fidelity(torch, out_dir, smi) -> dict:
    """Phase 34: ``python -m tpuseg_torch.tools.trained_fidelity`` in this
    process at its defaults, stage by stage, every launch count zeroed just
    before each stage and read just after; each stage's report row and
    seconds.  Gates: the exact rows agree with themselves, every GT mIoU in
    [0, 100], the train stage's val mIoU >= FIDELITY_TRAIN_MIN, the int8 rows
    >= INT8_TRAINED_MIN against their exact baseline, the kernels
    launched where their modes ran (the budgeted modes' selection in one
    launch, K4 never alone), and each B3 launch on one of its two kernels
    (the narrow one for the stem's convs alone, the calibrated stem handing
    int8 on from two of its three)."""
    from tpuseg_torch.tools import trained_fidelity

    counters = _counters()
    qpass = counters["quantize_activation"]
    stem_route = counters["fused_sparse_conv_q_bias_relu"]
    stages, launches = {}, {}
    for stage, flags in FIDELITY_STAGES:
        _zero_counts(torch, *counters.values())
        qpass.map_launches = stem_route.handoff_launches = 0
        t0 = time.perf_counter()
        _, text = _quiet(trained_fidelity.main, ["--stage", stage, "--out", out_dir] + flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[stage] = {k: f.launches for k, f in counters.items()}
        launches[stage]["quantize_map"] = qpass.map_launches
        launches[stage]["handoff"] = stem_route.handoff_launches
        with open(f"{out_dir}/report.json") as fh:
            stages[stage] = next(r for r in json.load(fh) if r["stage"] == stage)
        _emit(phase="trained_fidelity", stage=stage, seconds=round(seconds, 1),
              launches=launches[stage], row=stages[stage],
              log=[ln for ln in text.splitlines() if not ln.startswith("{")][-12:], card=smi)
    fid, comp = stages["fidelity"]["modes"], stages["compose"]["modes"]
    if fid["exact"]["ids_agreement_vs_exact"] != 1.0 or \
            comp["sparse_exact"]["ids_agreement_vs_sparse_exact"] != 1.0:
        raise AssertionError("an exact row does not agree with itself")
    mious = [r["gt_miou"] for r in list(fid.values()) + list(comp.values())] + [
        p["gt_miou"] for c in stages["budget_curve"]["curves"].values()
        for p in c["points"].values()]
    if not all(0 <= m <= 100 for m in mious):
        raise AssertionError(f"GT mIoU out of [0, 100]: {mious}")
    if not stages["train"]["val_miou"] >= FIDELITY_TRAIN_MIN:
        raise AssertionError(f"train stage val mIoU {stages['train']['val_miou']}")
    int8 = {**{k: fid[k]["ids_agreement_vs_exact"]
               for k in ("int8_dynamic", "int8_calib", "int8_stem_calib")},
            "compose.sparse_int8": comp["sparse_int8"]["ids_agreement_vs_sparse_exact"]}
    if not all(v >= INT8_TRAINED_MIN for v in int8.values()):
        raise AssertionError(f"int8 agreement on trained weights: {int8}")
    need = {"compress": ("sparse_conv_train_forward", "sparse_conv_train_dgrad"),
            "fidelity": ("upsample_argmax", "fused_sparse_conv_apply_q",
                         "fused_sparse_conv_q_bias_relu", "quantize_activation",
                         "frame_deltas", "frame_deltas_budget", "estimate_block_shifts",
                         "warp_ids", "i420_to_rgb_flat"),
            "compose": ("upsample_argmax", "fused_sparse_conv_apply_q", "frame_deltas_budget"),
            "budget_curve": ("upsample_argmax", "frame_deltas_budget")}
    missing = {st: [k for k in ks if not launches[st][k] > 0] for st, ks in need.items()}
    if any(missing.values()):
        raise AssertionError(f"kernels not launched in their stages: {missing}")
    # the budgeted modes select in one launch: K4 never runs alone
    if any(c["budget_select"] for c in launches.values()):
        raise AssertionError(f"K4 launched alone in a stage: "
                             f"{ {st: c['budget_select'] for st, c in launches.items()} }")
    # each B3 launch on one of its two kernels; the narrow one only for the
    # stem's convs, all three; every stem forward calibrated (the served
    # int8_stem_calib mode, and calibrate_scales through it), so conv0 and
    # conv1 hand int8 on and only conv0 quantizes its x
    for st, c in launches.items():
        stem = c["fused_sparse_conv_q_bias_relu"]
        if (c["sparse_conv_q_kernel"] + c["sparse_conv_q_narrow_kernel"]
                != c["fused_sparse_conv_apply_q"] or c["sparse_conv_q_narrow_kernel"] != stem
                or c["handoff"] * FRONTEND_STEM_CONVS != stem * (FRONTEND_STEM_CONVS - 1)
                or c["quantize_activation"] + c["handoff"] != c["fused_sparse_conv_apply_q"]):
            raise AssertionError(f"trained_fidelity {st}: B3's kernels {c}")
    _emit(phase="trained_fidelity_gates", train_val_miou=stages["train"]["val_miou"],
          int8_agreement=int8, gt_miou_range=[min(mious), max(mious)], card=smi)
    total = {k: sum(launches[st][k] for st in launches)
             for k in [*counters, "quantize_map", "handoff"]}
    return {"stages": stages, "launches": launches, "total": total}


def _remat_mem(smi) -> dict:
    """Phase 35: ``python -m tpuseg_torch.tools.remat_mem --cases seg``
    (DRN-D-22, 768x768, batch 4, bf16): its lines, and remat's temp_ratio < 1."""
    from tpuseg_torch.tools import remat_mem

    (res,), text = _quiet(remat_mem.main, ["--cases", "seg"])
    lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    _emit(phase="remat_mem", command="python -m tpuseg_torch.tools.remat_mem --cases seg",
          lines=lines, card=smi)
    if not res.get("temp_ratio", 1.0) < 1.0:
        raise AssertionError(f"remat_mem: temp_ratio {res.get('temp_ratio')} not below 1")
    return res


def _pretrained_serving(torch, np, dev, ckpt, workdir, smi) -> dict:
    """Phase 36: ``seg_video --pretrained <phase 34's checkpoint> --video
    shapes:2 --size 128x256`` (normalized with the shapes world's stats) in
    this process: its ids equal a ``VideoSegmenter`` built here from the same
    npz on the same frames, differ from the random-weights run, and score
    GT mIoU >= FIDELITY_TRAIN_MIN against the video's labels; then the host
    decoders this machine has and, where one is, a written video served with
    ``--video <file> --pretrained``."""
    from tpuseg_torch.cli import seg_video
    from tpuseg_torch.data.shapes import shapes_video
    from tpuseg_torch.metrics.seg import fast_hist, miou_from_hist
    from tpuseg_torch.models.drn import build_drn_spec
    from tpuseg_torch.tools.trained_fidelity import _shapes_stats
    from tpuseg_torch.train import load_checkpoint
    from tpuseg_torch.video.native_source import available
    from tpuseg_torch.video.pipeline import FrameSource, VideoSegmenter

    h, w = PRETRAINED_SIZE
    mean, std = (",".join(f"{v:.9g}" for v in a) for a in _shapes_stats())
    base = ["--size", f"{h}x{w}", "--frames", "24", "--batch", "8", "--mean", mean, "--std", std]
    (line, res), _ = _quiet(seg_video.main, ["--video", "shapes:2", "--pretrained", ckpt] + base)
    (_, rand), _ = _quiet(seg_video.main, ["--video", "shapes:2"] + base)
    params, state, _m, _o, _meta = load_checkpoint(ckpt)
    frames, labels = shapes_video(24, (h, w), seed=2)
    seg = VideoSegmenter(params, state, build_drn_spec(ARCH, num_classes=0, naming="seg"),
                         [float(v) for v in mean.split(",")], [float(v) for v in std.split(",")],
                         device=dev, compute_dtype=torch.bfloat16, batch=8, target_size=(h, w),
                         ids_bits=5)
    ids = seg.run(list(frames), need_color=False)["ids"]
    hist = sum(fast_hist(a.ravel(), b.ravel().astype(np.int32), 6)
               for a, b in zip(res["ids"], labels))
    gt = miou_from_hist(hist)
    same = bool(np.array_equal(res["ids"], ids))
    differ = not np.array_equal(res["ids"], rand["ids"])
    _emit(phase="pretrained_serving", command="seg_video --video shapes:2 --pretrained "
          f"{os.path.basename(ckpt)} " + " ".join(base), result=line,
          equals_in_process=same, differs_from_random=differ, gt_miou=gt,
          max_id=int(res["ids"].max()), card=smi)
    if not (same and differ and gt >= FIDELITY_TRAIN_MIN and int(res["ids"].max()) < 6):
        raise AssertionError(f"--pretrained: equal {same}, differs {differ}, GT mIoU {gt}")
    # host decode: what this machine has (no device path)
    have = {"native": available()}
    for mod in ("cv2", "imageio"):
        try:
            __import__(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    out = {"decoders": have, "decoder": None}
    if have["cv2"]:
        import cv2

        path = os.path.join(workdir, "pretrained.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
        for f in frames[:12]:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        src = FrameSource(path)
        n = sum(1 for _ in src)
        (fline, fres), _ = _quiet(seg_video.main, ["--video", path, "--pretrained", ckpt,
                                                   *base[:2], "--frames", "12", "--batch", "4",
                                                   *base[6:]])
        out.update(decoder=src.decoder, frames=n, result=fline)
        if not (n == 12 and fline["frames"] == 12 and fres["ids"].shape == (12, h, w)):
            raise AssertionError(f"--video file: {n} frames decoded, {fline}")
    _emit(phase="host_decode", **out, card=smi)
    return out


# phases 37-39: the classifier arm (DRN-D-22 classifier training with
# --sparse-exec at 224x224, the classifier CLIs, the cls tools)
CLS_CLASSES = 1000
CLS_CROP = 224
CLS_BATCH = 32
CLS_SMALL = 64       # f32 parity input side (maps 8x8 at output stride 8)
CLS_SMALL_MAPS = ((32, 28, 28), (8, 4, 4))  # B2's classifier maps at 224 and 32 inputs
CLS_SMALL_DILATIONS = (1, 2, 4)
CLS_SYNTHETIC_N = 256  # the CLIs' --synthetic-n: 4 batches of 64
CLS_CLI_BATCH = 64
R20_NARROW_PER_FORWARD = 16  # cifar_resnet20's int8 plans at stride-1 call sites
R20_MAP_PER_FORWARD = 6      # its layer1 convs: 16 channels padded to K = 32 through a map
D22_INT8_PER_FORWARD = 13    # drn_d_22's int8 plans (stages 4-8, >= 128 channels)
CLS_ACC_MIN = 0.5    # cls stage accuracies (chance 0.1)


def _cls_config(workdir) -> tuple[dict, str]:
    """block128reg_87.50's config with its ``layer_set`` in classifier
    naming (``layer.N.`` -> ``layerN.``), and the path it is written to."""
    import re

    with open(SERVED_CONFIG) as fh:
        cfg = json.load(fh)
    for c in cfg["configs"]:
        c["layer_set"] = [re.sub(r"^layer\.(\d+)\.", r"layer\1.", n) for n in c["layer_set"]]
    path = os.path.join(workdir, "drn_d_22_cls_block128reg_87.50.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return cfg, path


def _cls_trainer(torch, dev, params, state, spec, masks=None, sparse=False, dtype=None,
                 lr=0.01):
    """(train state on ``dev``, cls train step, cls eval step) of the
    port's classifier trainer (``dtype`` None: f32)."""
    from tpuseg_torch.ops.sparse_train import build_sparse_train_structs
    from tpuseg_torch.train import (create_train_state, make_cls_train_step, make_eval_step,
                                    make_sgd)

    def on(tensors):
        return {k: v.to(dev) for k, v in tensors.items()}

    plans = ({k: st.to(dev) for k, st in build_sparse_train_structs(masks, spec)[0].items()}
             if sparse else None)
    tx = make_sgd(lambda _: lr, 0.9, 1e-4)
    ts = create_train_state(on(params), on(state), tx, on(masks) if masks else None)
    return (ts, make_cls_train_step(spec, tx, compute_dtype=dtype, sparse_plans=plans),
            make_eval_step(spec, "cls", compute_dtype=dtype))


def _cls_batch(torch, np, dev, n, size, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(n, size, size, 3)).astype(np.float32)).to(dev),
            torch.from_numpy(rng.integers(0, CLS_CLASSES, n).astype(np.int32)).to(dev))


def _cls_small_maps(torch, np, dev, rng, smi) -> dict:
    """B2's forward and dgrad on the classifier's maps against their plain
    versions (``_train_case``: within 2*K*eps, and against cuDNN's f64 conv
    and dgrad): (32, 28, 28, 512), R = 9 with a last band of one real row,
    and (8, 4, 4, 512), where floor(256 / 4) = 64 rows would pass h = 4;
    d in {1, 2, 4}; R and the grid on a line before each; then the forward
    and the dgrad at (32, 28, 28, 512), d = 4 timed against their plain
    versions and cuDNN's dense conv and dgrad."""
    import torch.nn.functional as F

    from tpuseg_torch.ops import sparse_train as tst
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_reference

    g = torch.Generator(device=dev).manual_seed(37)
    errs, kept = {}, None
    for n, h, w in CLS_SMALL_MAPS:
        for d in CLS_SMALL_DILATIONS:
            m = _b2_mask(rng, 3, 512, 512, 2)
            st = tst.plan_sparse_conv_train(m.transpose(2, 3, 1, 0), dilation=d)
            name = f"cls_{n}x{h}x{w}_d{d}"
            r, fwd_ctas = _b2_grid(n, h, w, st.cout)
            _emit(phase="b2_tile_geometry", case=name, shape=[n, h, w], rows_per_tile=r,
                  grid_forward=fwd_ctas, grid_dgrad=_b2_grid(n, h, w, st.cin)[1])
            plan, mask = st.to(dev), torch.from_numpy(m).to(dev)
            wt = torch.randn((512, 512, 3, 3), generator=g, device=dev)
            wt = wt * (2.0 / (9 * 512)) ** 0.5 * mask
            x = torch.randn((n, h, w, 512), generator=g, device=dev).to(torch.bfloat16)
            dy = torch.randn((n, h, w, 512), generator=g, device=dev)
            errs[name] = _train_case(torch, np, name, plan, wt, mask, x, dy)
            if (n, h, w, d) == (*CLS_SMALL_MAPS[0], 4):
                kept = (plan, wt, x, dy)
    plan, wt, x, dy = kept
    st = plan.struct
    vals = tst.pack_vals(wt, plan, torch.bfloat16)
    vals_t = tst._transpose_vals(vals, plan)
    dyc = dy.to(torch.bfloat16)
    fplan, bplan = tst._fwd_plan(vals, plan), tst._bwd_plan(vals_t, plan)
    w_b = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dyc.permute(0, 3, 1, 2)
    turns = _time_turns(torch, {
        "forward": lambda: tst.sparse_conv_train_forward(x, vals, plan),
        "forward_plain": lambda: fused_sparse_conv_reference(x, fplan),
        "forward_cudnn": lambda: F.conv2d(x_nchw, w_b, None, 1, st.dilation, st.dilation),
        "dgrad": lambda: tst.sparse_conv_train_dgrad(dyc, vals_t, plan),
        "dgrad_plain": lambda: fused_sparse_conv_reference(dyc, bplan),
        "dgrad_cudnn": lambda: torch.nn.grad.conv2d_input(
            tuple(x_nchw.shape), w_b, dy_nchw, 1, st.dilation, st.dilation),
    }, {"forward": 20, "forward_plain": 3, "forward_cudnn": 20, "dgrad": 20, "dgrad_plain": 3,
        "dgrad_cudnn": 20})
    pixels = x.shape[0] * x.shape[1] * x.shape[2]
    bounds = {"forward": _b2_bound(pixels, vals, plan.rows, st.cout),
              "dgrad": _b2_bound(pixels, vals_t, plan.rows_t, st.cin)}
    _emit(phase="cls_b2_small_maps", cases=len(errs), errors=errs, timed_shape=list(x.shape),
          dilation=st.dilation, rows_per_tile=_b2_grid(*x.shape[:3], st.cout)[0], ms=turns,
          bound_ms={r: b[0] for r, b in bounds.items()}, card=smi)
    return {"errors": errs, "ms": turns, "bounds": bounds}


def _cls_training(torch, np, dev, rng, workdir, smi) -> dict:
    """Phase 37: the DRN-D-22 classifier (classifier naming, 1000 classes)
    at 224x224, batch 32, bf16, masked by block128reg_87.50 (its config
    rewritten to classifier naming): masked dense and ``--sparse-exec``, 3
    warm-up steps and 5 timed (CUDA events), with the peak memory; B2
    launched exactly twice per eligible conv in each timed ``--sparse-exec``
    step (forward and dgrad) and never in masked dense or in an evaluation;
    masked weights exactly 0.  f32 at 64x64: the two trajectories over two
    steps within phase 32's tolerances, and one ``--sparse-exec`` step on
    the card against the CPU.  Then B2 on the classifier's small maps
    (``_cls_small_maps``)."""
    from tpuseg_torch.models.drn import build_drn_spec, init_drn
    from tpuseg_torch.ops import sparse_train as tst
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_apply
    from tpuseg_torch.sparsity import create_masker

    fwd, dgrad = tst.sparse_conv_train_forward, tst.sparse_conv_train_dgrad
    spec = build_drn_spec(ARCH, num_classes=CLS_CLASSES, naming="cls")
    params, state = init_drn(0, spec)
    cfg, _ = _cls_config(workdir)
    masks = create_masker(cfg, seed=0).generate_masks(params)
    structs, report = tst.build_sparse_train_structs(masks, spec)
    if len(structs) != TRAIN_STRUCTS or any(k.startswith("layer.") for k in structs):
        raise AssertionError(f"{len(structs)} sparse-train structs in classifier naming, want "
                             f"{TRAIN_STRUCTS}: {report}")
    masks_dev = {k: v.to(dev) for k, v in masks.items()}
    batch = _cls_batch(torch, np, dev, CLS_BATCH, CLS_CROP, 37)
    timed, launches = {}, {}
    for sparse in (False, True):
        ts, step, eval_step = _cls_trainer(torch, dev, params, state, spec, masks, sparse,
                                           dtype=torch.bfloat16)
        r = _timed_steps(torch, dev, ts, step, batch, masks_dev)
        per = (r["b2_forward"], r["b2_dgrad"])
        if per != ((TRAIN_STRUCTS * 5,) * 2 if sparse else (0, 0)):
            raise AssertionError(f"classifier sparse={sparse}: B2 launched {per} in 5 steps")
        if not math.isfinite(r["loss"]):
            raise AssertionError(f"classifier sparse={sparse}: loss {r['loss']}")
        if sparse:
            launches = {"sparse_conv_train_forward": per[0], "sparse_conv_train_dgrad": per[1]}
        _zero_counts(torch, fwd, dgrad, fused_sparse_conv_apply)
        eval_step(r["ts"].params, r["ts"].bn_state, *batch)
        torch.cuda.synchronize()
        if fwd.launches or dgrad.launches or fused_sparse_conv_apply.launches:
            raise AssertionError("the classifier's evaluation launched B2")
        timed["sparse_exec" if sparse else "masked_dense"] = {
            k: v for k, v in r.items() if k != "ts"}
        del ts, step, r
        torch.cuda.empty_cache()
    # f32 at 64x64: the two trajectories, then the card against the CPU
    small = [_cls_batch(torch, np, dev, 2, CLS_SMALL, 40 + i) for i in range(2)]
    traj = {}
    for sparse in (False, True):
        ts, step, _ = _cls_trainer(torch, dev, params, state, spec, masks, sparse, lr=0.005)
        losses = []
        for b in small:
            ts, m = step(ts, *b)
            losses.append(float(m["loss"]))
            if not _masks_zero(torch, ts, masks_dev):
                raise AssertionError("a masked weight moved off 0")
        traj[sparse] = (ts, losses)
    np.testing.assert_allclose(traj[True][1], traj[False][1], rtol=1e-4)
    _close_states(torch, np, "classifier f32 --sparse-exec vs masked dense", traj[True][0],
                  traj[False][0])
    runs = {}
    for name in ("cuda", "cpu"):
        d = dev if name == "cuda" else torch.device("cpu")
        ts, step, _ = _cls_trainer(torch, d, params, state, spec, masks, True, lr=0.005)
        runs[name] = step(ts, *(t.to(d) for t in small[0]))
    loss_c, loss_h = float(runs["cuda"][1]["loss"]), float(runs["cpu"][1]["loss"])
    if not abs(loss_c - loss_h) <= 1e-4 * abs(loss_h):
        raise AssertionError(f"classifier f32 step loss on the card {loss_c}, on the CPU {loss_h}")
    _close_states(torch, np, "classifier f32 card vs CPU", runs["cuda"][0], runs["cpu"][0])
    _emit(phase="cls_train", arch=ARCH, naming="cls", classes=CLS_CLASSES,
          shape=[CLS_BATCH, CLS_CROP, CLS_CROP, 3], dtype="bfloat16", sparse_exec=report,
          steps=timed, launches=launches,
          f32_losses={"masked_dense": traj[False][1], "sparse_exec": traj[True][1]},
          f32_card_vs_cpu={"loss_cuda": loss_c, "loss_cpu": loss_h,
                           "size": [2, CLS_SMALL, CLS_SMALL]}, card=smi)
    small_maps = _cls_small_maps(torch, np, dev, rng, smi)
    return {"launches": launches, "steps": timed, "small_maps": small_maps}


def _cls_cli(torch, label, fn, argv, counters, smi) -> tuple:
    """``fn(argv)`` (a CLI's ``main``) in this process with every counter in
    ``counters``, B3's narrow-route count (``quant_conv_apply.
    narrow_launches``, read as ``narrow_b3``) and the quantize passes
    through a channel map (``quantize_map``) zeroed just before and read
    just after: (its result, its JSON lines, the counts)."""
    from tpuseg_torch.ops.quant import quant_conv_apply
    from tpuseg_torch.ops.sparse_conv import quantize_activation

    _zero_counts(torch, *counters)
    quant_conv_apply.narrow_launches = quantize_activation.map_launches = 0
    t0 = time.perf_counter()
    out, text = _quiet(fn, argv)
    torch.cuda.synchronize()
    counts = {f.__name__: f.launches for f in counters}
    counts["narrow_b3"] = quant_conv_apply.narrow_launches
    counts["quantize_map"] = quantize_activation.map_launches
    lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    _emit(phase="cls_cli", run=label, argv=argv, seconds=round(time.perf_counter() - t0, 1),
          lines=lines[-3:], progress=[ln for ln in text.splitlines() if "\t" in ln][-2:],
          launches=counts, card=smi)
    return out, lines, counts


def _recording_quant_convs(run):
    """``run()`` with every ``QuantConv`` dispatch recorded, routed as it
    would be: (its result, [(plan, bf16 route, copy of x, bias), ...])."""
    from tpuseg_torch.ops.quant import QuantConv

    recorded = []
    apply, apply_bias = QuantConv.apply, QuantConv.apply_bias_bf16

    def rec(plan, x):
        recorded.append((plan, False, x.clone(), None))
        return apply(plan, x)

    def rec_bias(plan, x, bias):
        recorded.append((plan, True, x.clone(), bias))
        return apply_bias(plan, x, bias)

    QuantConv.apply, QuantConv.apply_bias_bf16 = rec, rec_bias
    try:
        return run(), recorded
    finally:
        QuantConv.apply, QuantConv.apply_bias_bf16 = apply, apply_bias


def _quant_convs_bit_equal(torch, label, recorded, plans, smi, dtypes=None) -> int:
    """Every recorded ``QuantConv`` dispatch run again on the card
    (``QuantConv.apply`` or ``apply_bias_bf16``: kernel B3) and by its plain
    version (``quant_conv_reference``, then ``cast_bias_bf16`` on the bf16
    route) on the same input, bit for bit.  Fails on any mismatch, or
    unless each of the ``plans`` int8 convs was checked on inputs of each
    of ``dtypes`` (f32 and bf16 by default) and of no other.  Returns the
    number checked."""
    from tpuseg_torch.ops.quant import quant_conv_reference
    from tpuseg_torch.ops.sparse_conv import cast_bias_bf16

    dtypes = dtypes or (torch.float32, torch.bfloat16)
    mismatched, seen = [], {d: set() for d in dtypes}
    for plan, bf16_route, x, bias in recorded:
        want = quant_conv_reference(x, plan)
        if bf16_route:
            want = cast_bias_bf16(want, bias)
            got = plan.apply_bias_bf16(x, bias)
        else:
            got = plan.apply(x)
        seen.setdefault(x.dtype, set()).add(id(plan))
        if not (got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want)):
            mismatched.append([list(plan.w_q.shape), plan.dilation, list(x.shape), str(x.dtype)])
    torch.cuda.synchronize()
    per_dtype = {str(k): len(v) for k, v in seen.items()}
    _emit(phase="cls_b3_bit_equal", run=label, checked=len(recorded), plans=per_dtype,
          mismatched=mismatched[:8], card=smi)
    if mismatched or set(per_dtype.values()) != {plans} or len(per_dtype) != len(dtypes):
        raise AssertionError(f"{label}: B3 against its plain version, {len(mismatched)} of "
                             f"{len(recorded)} mismatched {mismatched[:4]}; plans checked "
                             f"{per_dtype}, want {plans} on {[str(d) for d in dtypes]} "
                             f"inputs")
    return len(recorded)


def _narrow_b3_times(torch, recorded, smi) -> dict:
    """B3's narrow route (``quant_conv_apply`` on cifar_resnet20's 3x3 convs
    of each width: 16 on 32x32 maps, 32 on 16x16, 64 on 8x8) timed at its
    recorded f32 input (batch ``CLS_CLI_BATCH``) against its plain version
    and cuDNN's bf16 conv of the same shape, with the route's quantize pass
    alone (through the packing's padding map where it has one; its bound:
    x read once, the int8 x and the scales written) beside it, and the route's
    and cuDNN's device time from CUDA graphs (``graph_ms``).  -> the rows by
    width, and the 16-wide one's numbers for the kernels line."""
    import torch.nn.functional as F

    from tpuseg_torch.ab_sparse_conv import graph_ms
    from tpuseg_torch.ops.quant import quant_conv_apply, quant_conv_reference
    from tpuseg_torch.ops.sparse_conv import b3_narrow_tile, quantize_activation

    rows = {}
    for c, side in ((16, 32), (32, 16), (64, 8)):
        plan, _, xin, _ = next(r for r in recorded if r[2].dtype == torch.float32
                               and tuple(r[2].shape) == (CLS_CLI_BATCH, side, side, c)
                               and tuple(r[0].w_q.shape) == (3, 3, c, c))
        pk = plan.packed
        w_b = plan.w_q.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        x_b = xin.to(torch.bfloat16).permute(0, 3, 1, 2)
        turns = _time_turns(torch, {
            "narrow_route": lambda: quant_conv_apply(xin, plan),
            "quantize": lambda: quantize_activation(xin, pk.x_scale, pk.in_chan,
                                                    vecs=pk.in_vecs),
            "plain": lambda: quant_conv_reference(xin, plan),
            "cudnn_bf16": lambda: F.conv2d(x_b, w_b, None, 1, 1),
        }, {"narrow_route": 20, "quantize": 20, "plain": 3, "cudnn_bf16": 20})
        n, h, w, _ = xin.shape
        pixels = n * h * w
        # the function: f32 x read once, the int8 weight and scales, f32 y
        # written once; 9 * cin * cout int8 products a pixel
        bound = _bound(xin.numel() * 4 + plan.w_q.numel() + c * 4 + pixels * c * 4,
                       2 * pixels * 9 * c * c, "int8")
        # the quantize pass: f32 x read once, the int8 x (as wide as the
        # packing's map) and the scales written
        cq = c if pk.in_chan is None else pk.in_chan.numel()
        q_bound = _bound(xin.numel() * 4 + pixels * cq + n * 4, pixels * cq, "f32")
        # the route's and cuDNN's device time, 20 calls in one CUDA graph:
        # back to back, the small convs' calls are paced by their host work
        device = {"route_device_ms": min(graph_ms(lambda: quant_conv_apply(xin, plan), 20)
                                         for _ in range(2)),
                  "cudnn_device_ms": min(graph_ms(lambda: F.conv2d(x_b, w_b, None, 1, 1), 20)
                                         for _ in range(2))}
        row = {"ms": min(turns["narrow_route"]), "plain_ms": min(turns["plain"]),
               "library_ms": min(turns["cudnn_bf16"]), "bound_ms": bound[0],
               "bound_by": bound[1], "quantize_ms": min(turns["quantize"]),
               "quantize_bound_ms": q_bound[0], "max_abs_err": 0.0, **device}
        rows[c] = row
        _emit(phase="cls_b3_narrow", conv=f"3x3 {c}->{c}", shape=[n, h, w, c],
              packing=[plan.packed.bk, plan.packed.bm], tile=list(b3_narrow_tile(n, h, w)),
              ms=turns, **{k: v for k, v in row.items() if not k.endswith("ms")},
              bound_ms=bound[0], quantize_bound_ms=q_bound[0], **device, card=smi)
    # the kernels line: the 16-wide conv's device times (route, cuDNN), so
    # that ms and library_ms stand beside the bound as the card's work
    main = rows[16]
    return {"by_width": rows, **main, "ms": main["route_device_ms"],
            "library_ms": main["cudnn_device_ms"]}


def _cls_clis(torch, np, workdir, smi) -> dict:
    """Phase 38: the classifier CLIs on the card, in this process, every
    launch count zeroed just before each run and read just after:
    ``rmbsnn -a drn_d_22 --sparse-exec`` on the classifier config (bf16, 1
    epoch of 4 steps: B2 twice per eligible conv a step, never served); ``-a
    cifar_resnet20 --evaluate --quantize`` in f32 and in bf16 (int8_layers
    >= 20, B3's narrow route launched 16 times a forward, B3 and the
    quantize pass once per narrow launch); ``-a drn_d_22 --evaluate
    --quantize`` in f32 and in bf16 (13 int8 plans at the classifier's
    4x4-2x2 maps, d = 2 and 4: B3 13 times a forward, unpadded).  Every
    ``QuantConv`` dispatch of those four runs is recorded and held bit-equal
    to its plain version on the card (``_quant_convs_bit_equal``), and the
    narrow route is timed at each of r20's widths (``_narrow_b3_times``);
    ``imagenet_train
    --dataset synthetic``;
    ``seg_video --pretrained x.pth`` on a reference-layout ``.pth`` this
    phase writes: ids equal to the same weights' npz, unequal to the random
    weights'."""
    from tpuseg_torch.cli import imagenet_train, rmbsnn, seg_video
    from tpuseg_torch.models.drn import jax_key
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.ops import sparse_train as tst
    from tpuseg_torch.ops.sparse_conv import (
        fused_sparse_conv_apply, fused_sparse_conv_apply_q, quantize_activation,
        sparse_conv_q_kernel, sparse_conv_q_narrow_kernel)
    from tpuseg_torch.train import save_checkpoint

    counters = (tst.sparse_conv_train_forward, tst.sparse_conv_train_dgrad,
                fused_sparse_conv_apply, fused_sparse_conv_apply_q, quantize_activation,
                sparse_conv_q_kernel, sparse_conv_q_narrow_kernel)
    _, cfg_path = _cls_config(workdir)
    total = Counter()
    synthetic = ["--dataset", "synthetic", "--synthetic-n", str(CLS_SYNTHETIC_N), "-b",
                 str(CLS_CLI_BATCH)]
    steps = CLS_SYNTHETIC_N // CLS_CLI_BATCH  # drop_last in training
    val_batches = -(-CLS_SYNTHETIC_N // CLS_CLI_BATCH)
    # rmbsnn --sparse-exec on DRN-D-22 (classifier naming), 32x32 synthetic
    _, lines, c = _cls_cli(torch, "rmbsnn_drn_sparse_exec", rmbsnn.main, synthetic + [
        "-a", ARCH, "--epochs", "1", "--dtype", "bfloat16", "--mc-pruning", "--pr-static",
        "--pr-config-path", cfg_path, "--sparse-exec", "--save-dir", f"{workdir}/cls_sparse"],
        counters, smi)
    report = next(ln["sparse_exec"] for ln in lines if "sparse_exec" in ln)
    eligible = sum(v.startswith("sparse-train") for v in report.values())
    want = TRAIN_STRUCTS * steps
    if (eligible, c["sparse_conv_train_forward"], c["sparse_conv_train_dgrad"],
            c["fused_sparse_conv_apply"]) != (TRAIN_STRUCTS, want, want, 0):
        raise AssertionError(f"rmbsnn --sparse-exec: {eligible} eligible, launches {c}")
    if not math.isfinite(lines[-1]["train_loss"]):
        raise AssertionError(f"rmbsnn --sparse-exec epoch line {lines[-1]}")
    total.update(c)
    # rmbsnn --evaluate --quantize in f32 and bf16: the zoo's narrow route,
    # then DRN-D-22's, every QuantConv dispatch recorded
    recorded = {"r20": [], "d22": []}
    res, res_d = {}, {}
    for dtype in ("float32", "bfloat16"):
        (res[dtype], _, c), rec = _recording_quant_convs(lambda: _cls_cli(
            torch, f"rmbsnn_r20_int8_{dtype}", rmbsnn.main, synthetic + [
                "-a", "cifar_resnet20", "--evaluate", "--quantize", "--dtype", dtype],
            counters, smi))
        recorded["r20"] += rec
        narrow = R20_NARROW_PER_FORWARD * val_batches
        if not (res[dtype]["int8_layers"] >= 20 and c["narrow_b3"] == narrow
                and c["fused_sparse_conv_apply_q"] == c["quantize_activation"] == narrow
                and c["sparse_conv_q_narrow_kernel"] == narrow
                and c["sparse_conv_q_kernel"] == 0
                and c["quantize_map"] == R20_MAP_PER_FORWARD * val_batches):
            raise AssertionError(f"rmbsnn cifar_resnet20 --quantize --dtype {dtype}: "
                                 f"{res[dtype]}, launches {c}")
        total.update(c)
        (res_d[dtype], _, c), rec = _recording_quant_convs(lambda: _cls_cli(
            torch, f"rmbsnn_d22_int8_{dtype}", rmbsnn.main, synthetic + [
                "-a", ARCH, "--evaluate", "--quantize", "--dtype", dtype], counters, smi))
        recorded["d22"] += rec
        b3 = D22_INT8_PER_FORWARD * val_batches
        if not (res_d[dtype]["int8_layers"] == D22_INT8_PER_FORWARD
                and c["fused_sparse_conv_apply_q"] == b3 and c["narrow_b3"] == 0
                and c["sparse_conv_q_kernel"] == b3 and c["sparse_conv_q_narrow_kernel"] == 0
                and c["quantize_map"] == 0):
            raise AssertionError(f"rmbsnn drn_d_22 --quantize --dtype {dtype}: "
                                 f"{res_d[dtype]}, launches {c}")
        total.update(c)
    checked = {"r20": _quant_convs_bit_equal(torch, "cifar_resnet20", recorded["r20"],
                                             R20_NARROW_PER_FORWARD, smi),
               "d22": _quant_convs_bit_equal(torch, ARCH, recorded["d22"],
                                             D22_INT8_PER_FORWARD, smi)}
    narrow_t = _narrow_b3_times(torch, recorded["r20"], smi)
    del recorded
    # imagenet_train, 1 epoch
    line, _, c = _cls_cli(torch, "imagenet_train", imagenet_train.main, synthetic + [
        "--epochs", "1", "-p", "1", "--save-dir", f"{workdir}/imagenet"], counters, smi)
    if not (line and line["epoch"] == 0 and 0 <= line["acc1"] <= 100):
        raise AssertionError(f"imagenet_train: {line}")
    # seg_video --pretrained x.pth
    params, state, _ = init_drnseg(jax_key(1), ARCH, CLASSES)
    sd = {("module.base." + k[len("layer."):] if k.startswith("layer.") else "module." + k): v
          for k, v in {**params, **state}.items()}
    sd["module.up.weight"] = params["up.weight"].expand(CLASSES, 1, 16, 16).clone()
    pth, npz = f"{workdir}/drnseg.pth", f"{workdir}/drnseg.npz"
    torch.save({"state_dict": sd, "epoch": 1}, pth)
    save_checkpoint(npz, params, state)
    base = ["--video", "shapes:2", "--size", "128x256", "--frames", "8", "--batch", "4"]
    (line_p, from_pth), _ = _quiet(seg_video.main, base + ["--pretrained", pth])
    (_, from_npz), _ = _quiet(seg_video.main, base + ["--pretrained", npz])
    (_, rand), _ = _quiet(seg_video.main, base)
    same = bool(np.array_equal(from_pth["ids"], from_npz["ids"]))
    differ = not np.array_equal(from_pth["ids"], rand["ids"])
    _emit(phase="cls_cli", run="seg_video_pretrained_pth", result=line_p, equals_npz=same,
          differs_from_random=differ, card=smi)
    if not (same and differ):
        raise AssertionError(f"seg_video --pretrained .pth: equal {same}, differs {differ}")
    return {"launches": dict(total), "narrow": narrow_t, "r20_int8": res, "d22_int8": res_d,
            "bit_equal_checked": checked}


def _cls_tools(torch, out_dir, smi) -> dict:
    """Phase 39: ``trained_fidelity --stage cls`` at its defaults (a
    cifar_resnet20 teacher of 500 steps at batch 128 on the classification
    proxy, RBGP 50 % masks, 300 recovery steps plain and with KD, bf16) with
    its report row and seconds (accuracies in [0, 1], the teacher's and
    the retrained ones >= CLS_ACC_MIN); then ``remat_mem --cases cls,kd``
    (temp_ratio < 1 in both)."""
    from tpuseg_torch.tools import remat_mem, trained_fidelity

    t0 = time.perf_counter()
    _, text = _quiet(trained_fidelity.main, ["--stage", "cls", "--out", out_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(f"{out_dir}/report.json") as fh:
        row = next(r for r in json.load(fh) if r["stage"] == "cls")
    accs = {k: row[k] for k in ("teacher_acc", "acc_at_mask_50pct", "retrain_plain_acc",
                                "retrain_kd_acc")}
    _emit(phase="cls_fidelity", seconds=round(seconds, 1), row=row,
          log=[ln for ln in text.splitlines() if not ln.startswith("{")][-6:], card=smi)
    if not (all(0 <= v <= 1 for v in accs.values())
            and min(accs["teacher_acc"], accs["retrain_plain_acc"],
                    accs["retrain_kd_acc"]) >= CLS_ACC_MIN):
        raise AssertionError(f"cls stage accuracies {accs}")
    res, text = _quiet(remat_mem.main, ["--cases", "cls,kd"])
    lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    _emit(phase="remat_mem", command="python -m tpuseg_torch.tools.remat_mem --cases cls,kd",
          lines=lines, card=smi)
    if not all(r.get("temp_ratio", 1.0) < 1.0 for r in res):
        raise AssertionError(f"remat_mem cls/kd: {[r.get('temp_ratio') for r in res]}")
    return {"row": row, "seconds": seconds, "remat": res}


# phase 40: the rest of bench_sparse, its modes called in this process
BENCH_MODES = ("fused", "frontend", "rmcdb", "layout", "model", "train", "trainer",
               "conv1split")
BENCH_METRICS = {  # mode -> the metric names it prints, in order (bench_sparse.py's)
    "fused": ["fused/dense_conv3x3_ms"] + [f"fused_sparse_conv_{p}pct"
                                          for p in ("50.0", "75.0", "87.5")]
    + ["phase_kernel_density_1.0"],
    "frontend": ["frontend/bf16_ms", "frontend/int8_stem_ms", "frontend/int8_stem_stage3_ms"],
    "rmcdb": ["rmcdb/dense_matmul_ms", "rmcdb_roll_bh64_b8_c2", "rmcdb_roll_bh64_b16_c1",
              "rmcdb_roll_bh64_b4_c2", "rmcdb_roll_bh128_b16_c2"],
    "layout": ["layout/nhwc_nchw_roundtrip_ms", "layout/nhwc_nwhc_roundtrip_ms",
               "layout/copy_ms"],
    "model": ["model_dense_fps"] + [f"model_{k}_87.5pct_fps" for k in (
        "sparse", "gathered", "gathered_exact", "sparse_int8", "gathered_int8",
        "gathered_exact_int8")] + [f"model_{k}_{p}pct_fps" for p in ("75.0", "50.0")
                                   for k in ("gathered", "gathered_exact")],
    "train": ["train_step_sparse_87.5pct"],
    "trainer": ["trainer_step_sparse_exec_block128reg_87.5"],
    "conv1split": ["conv1split/split1d_numerics_ok", "conv1split/split2d_numerics_ok",
                   "conv1split_ms"],
}
FRONTEND_STEM_CONVS = 3  # B3's stem route in both int8 rows, on the narrow kernel
FRONTEND_STAGE3_CONVS = 5  # B3's narrow route in int8_stem_stage3
TRAINER_B2_CONVS = 10
BENCH_LOOPS = 2  # each time_loop: the untimed loop and one timed


def _bench_counters():
    """{name: (wrapper, attribute)} of every launch count phase 40 reads."""
    from tpuseg_torch.ops import sparse_conv as sc
    from tpuseg_torch.ops import sparse_train as tst
    from tpuseg_torch.ops.quant import quant_conv_apply
    from tpuseg_torch.ops.upsample import upsample_argmax

    out = {f.__name__: (f, "launches") for f in (
        upsample_argmax, sc.fused_sparse_conv_apply, sc.fused_sparse_conv_apply_q,
        sc.fused_sparse_conv_q_bias_relu, sc.quantize_activation, tst.sparse_conv_train_forward,
        tst.sparse_conv_train_dgrad, sc.bsr_matmul_xw, sc.sparse_conv_q_kernel,
        sc.sparse_conv_q_narrow_kernel,
        *(getattr(sc, name) for name in B7_ENTRIES))}
    out["absmax"] = (sc.quantize_activation, "absmax_launches")
    out["handoff"] = (sc.fused_sparse_conv_q_bias_relu, "handoff_launches")
    out["narrow_b3"] = (quant_conv_apply, "narrow_launches")
    out["quantize_map"] = (sc.quantize_activation, "map_launches")
    return out


def _plan_launches(plans) -> Counter:
    """The launches of one forward through the plan dict ``plans``, each
    plan run once a forward: B2 once for a ``FusedSparseConv`` or
    ``CompactSparse``; B3 and its quantize pass once for each int8 plan
    (``QuantConv``, ``FusedSparseConvQ``, ``CompactSparseQ``,
    ``GatheredGroupConvQ``), the absmax pass too where its scale is per
    frame, the 128-wide or the narrow kernel (``sparse_conv_q_kernel``,
    ``sparse_conv_q_narrow_kernel``) by its packing, ``narrow_b3`` for a
    ``QuantConv`` on a narrow packing and
    ``quantize_map`` for a ``CompactSparseQ`` (its channel map) or a narrow
    packing padded through its map; none
    for the float gathered and RBGP plans, which run cuDNN's and cuBLAS's."""
    from tpuseg_torch.models.sparse_exec import CompactSparse, CompactSparseQ
    from tpuseg_torch.ops.gathered_conv import GatheredGroupConvQ
    from tpuseg_torch.ops.quant import QuantConv
    from tpuseg_torch.ops.sparse_conv import FusedSparseConv, FusedSparseConvQ

    out = Counter()
    for p in (plans or {}).values():
        if isinstance(p, (FusedSparseConv, CompactSparse)):
            out["fused_sparse_conv_apply"] += 1
            continue
        if isinstance(p, (QuantConv, GatheredGroupConvQ)):
            packed = p.packed
        elif isinstance(p, CompactSparseQ):
            packed = p.inner
        elif isinstance(p, FusedSparseConvQ):
            packed = p
        else:
            continue
        out["fused_sparse_conv_apply_q"] += 1
        out["quantize_activation"] += 1
        out["absmax"] += packed.x_scale is None
        out["narrow_b3"] += isinstance(p, QuantConv) and packed.narrow
        out["sparse_conv_q_narrow_kernel" if packed.narrow else "sparse_conv_q_kernel"] += 1
        out["quantize_map"] += isinstance(p, CompactSparseQ) or packed.in_chan is not None
    return out


def _check_loops(label, loops, wants) -> None:
    """Each timed loop's launches (every counter of ``_bench_counters``)
    equal to its row's ``wants`` entry, counters it omits 0."""
    if len(loops) != len(wants):
        raise AssertionError(f"bench_sparse {label}: {len(loops)} timed loops, want "
                             f"{len(wants)}")
    for i, (got, want) in enumerate(zip(loops, wants)):
        wrong = {k: (v, want.get(k, 0)) for k, v in got.items() if v != want.get(k, 0)}
        if wrong:
            raise AssertionError(f"bench_sparse {label} loop {i}: launches (got, want) {wrong}")


def _frontend_stage3_bit_equal(torch, np, dev, smi) -> int:
    """Phase 40: one forward of ``--frontend``'s ``int8_stem_stage3`` row on
    the bench's first frame, every input of its five stage-3 int8 convs
    recorded (block 0's 2x2 conv1 embedded in a 3x3 kernel and its 1x1
    downsample, 128 -> 64; the three 3x3 64 -> 64 convs; all on B3's
    narrow packings, N = 64), then each conv's ``quant_conv_apply`` on the card (kernel
    B3) held bit-equal to ``quant_conv_reference`` on the same bf16 input."""
    from tpuseg_torch import bench_sparse as bs
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.ops.fold_bn import fold_bn

    recorded = []

    class Recording(bs.Int8Frontend):
        def _iconv(self, x, name):
            recorded.append((self.plans[name][0], False, x.clone(), None))
            return super()._iconv(x, name)

    params, state, spec = init_drnseg(0, bs.ARCH, bs.CLASSES)
    fe = Recording(fold_bn(params, state, spec), dev, stage3=True)
    h, w = bs.MODEL_HW
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, size=(1, h, w * 3), dtype=np.uint8)).to(dev)
    with torch.inference_mode():
        fe(frames)
    shapes = sorted((tuple(p.w_q.shape), tuple(x.shape)) for p, _, x, _ in recorded)
    _emit(phase="frontend_stage3_convs", convs=[[list(a), list(b)] for a, b in shapes],
          card=smi)
    return _quant_convs_bit_equal(torch, "frontend int8_stem_stage3", recorded,
                                  FRONTEND_STAGE3_CONVS, smi, dtypes=(torch.bfloat16,))


def _bench_modes(torch, np, dev, smi) -> dict:
    """Phase 40: every mode of this slice of ``python -m
    tpuseg_torch.bench_sparse`` (``BENCH_MODES``; ``--model`` with
    ``--sweep``) called in this process on one ``Bench`` that times each
    loop once after its untimed loop (``time_loop`` with one repetition;
    INNER unchanged) and records each loop's launches; every launch count
    zeroed just before each mode and read just after.  Checks: each mode's
    metric names and keys, finite values; each loop's launches exactly
    (--model: B1 once a frame, B2, B3, the quantize and absmax passes as
    ``_plan_launches`` counts each row's plans; --frontend: B3's stem route
    3 times a frame in both int8 rows and its narrow route 5 times in
    int8_stem_stage3, static scales; --train: B2's forward once a step of
    the sparse loop, no dgrad, its gradient being w's alone; --trainer:
    B2's two training roles 10 times a step of the sparse loop; --rmcdb,
    --layout, --conv1split: none), and the mode's totals (--fused: B2, B3,
    B7a-f as phase 17 counts them); the conv1split gate (it raises).
    -> {"rows", "launches", "seconds"}."""
    from tpuseg_torch import bench_sparse as bs

    counters = _bench_counters()

    def counts():
        return {k: getattr(f, attr) for k, (f, attr) in counters.items()}

    class OnceBench(bs.Bench):
        """The bench timing each loop once, keeping its rows and the
        launches of each ``time_loop``."""

        def __init__(self, card):
            super().__init__(dev, card)
            self.rows, self.loops = [], []

        def emit(self, **kw):
            super().emit(**kw)
            self.rows.append(json.loads(json.dumps({**kw, "card": self.card})))

        def time_loop(self, step, carry, reps=3, inner=None):
            torch.cuda.synchronize()
            before = counts()
            t = super().time_loop(step, carry, reps=1, inner=inner)
            torch.cuda.synchronize()
            self.loops.append({k: v - before[k] for k, v in counts().items()})
            return t

    card = bs.card_label()
    if card != smi:
        raise AssertionError(f"bench_sparse.card_label() {card!r}, nvidia-smi {smi!r}")
    modes = {"fused": bs.bench_fused, "frontend": bs.bench_frontend, "rmcdb": bs.bench_rmcdb,
             "layout": bs.bench_layout, "model": lambda b: bs.bench_model(b, sweep=True),
             "train": bs.bench_train, "trainer": bs.bench_trainer,
             "conv1split": bs.bench_conv1split}
    benches, results, launches, seconds = {}, {}, {}, {}
    for m in BENCH_MODES:
        benches[m] = b = OnceBench(card)
        torch.cuda.synchronize()
        for f, attr in counters.values():
            setattr(f, attr, 0)
        t0 = time.perf_counter()
        results[m] = modes[m](b)
        torch.cuda.synchronize()
        seconds[m] = time.perf_counter() - t0
        launches[m] = counts()
        names = [r["metric"] for r in b.rows]
        if names != BENCH_METRICS[m]:
            raise AssertionError(f"bench_sparse {m}: metrics {names}, want {BENCH_METRICS[m]}")
        bad = [r for r in b.rows for k, v in r.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad or not all(r["card"] == smi for r in b.rows):
            raise AssertionError(f"bench_sparse {m}: rows {b.rows}")
        _emit(phase="bench_sparse_mode", mode=m, seconds=round(seconds[m], 3),
              launches={k: v for k, v in launches[m].items() if v},
              loops=[{k: v for k, v in lp.items() if v} for lp in b.loops], rows=b.rows)
        # each B3 launch quantizes its x, but where the stem hands int8 on
        if (launches[m]["quantize_activation"] + launches[m]["handoff"]
                != launches[m]["fused_sparse_conv_apply_q"]):
            raise AssertionError(f"bench_sparse {m}: quantize + hand-offs {launches[m]} != B3")
    # each loop's launches, from the rows' plans where the row has any
    frame = BENCH_LOOPS * bs.MODEL_INNER  # frames through one model / frontend loop
    plan_rows = results["model"]
    if [name for name, _ in plan_rows] != BENCH_METRICS["model"]:
        raise AssertionError(f"bench_sparse model: rows {[n for n, _ in plan_rows]}")
    _check_loops("model", benches["model"].loops, [
        {"upsample_argmax": frame, **{k: frame * v for k, v in _plan_launches(plans).items()}}
        for _, plans in plan_rows])
    # the stem's three convs on the narrow kernel under FRONTEND_XS, static:
    # conv0 quantizes its 48 channels through its padding map, then hands
    # conv1 its int8 x, conv1 hands conv2; the stage-3 convs quantize their own
    stem = {"fused_sparse_conv_q_bias_relu": frame * FRONTEND_STEM_CONVS, "quantize_map": frame,
            "handoff": frame * (FRONTEND_STEM_CONVS - 1)}
    b3_stage3 = frame * (FRONTEND_STEM_CONVS + FRONTEND_STAGE3_CONVS)
    _check_loops("frontend", benches["frontend"].loops, [
        {}, {**stem, "fused_sparse_conv_apply_q": frame * FRONTEND_STEM_CONVS,
             "quantize_activation": frame, "sparse_conv_q_narrow_kernel": frame
             * FRONTEND_STEM_CONVS},
        {**stem, "fused_sparse_conv_apply_q": b3_stage3,
         "quantize_activation": frame * (1 + FRONTEND_STAGE3_CONVS),
         "narrow_b3": frame * FRONTEND_STAGE3_CONVS, "sparse_conv_q_narrow_kernel": b3_stage3}])
    train = BENCH_LOOPS * bs.TRAIN_INNER
    _check_loops("train", benches["train"].loops, [{}, {"sparse_conv_train_forward": train}])
    trainer = BENCH_LOOPS * bs.TRAINER_INNER * TRAINER_B2_CONVS
    _check_loops("trainer", benches["trainer"].loops, [
        {}, {"sparse_conv_train_forward": trainer, "sparse_conv_train_dgrad": trainer}])
    for m in ("rmcdb", "layout", "conv1split"):
        _check_loops(m, benches[m].loops, [{}] * len(benches[m].loops))
    # every mode's totals: its loops' sum (nothing launched outside them),
    # and the fused mode's as phase 17 counts them
    for m in BENCH_MODES:
        total = Counter()
        for lp in benches[m].loops:
            total.update(lp)
        if any(launches[m][k] != total[k] for k in launches[m]):
            raise AssertionError(f"bench_sparse {m}: launches {launches[m]} outside its loops "
                                 f"{dict(total)}")
    want = {k: BENCH_LOOPS * bs.INNER * len(bs.SPARSITIES) for k in (
        "fused_sparse_conv_apply", "fused_sparse_conv_apply_q", "sparse_conv_q_kernel",
        "quantize_activation", *B7_ENTRIES)}
    want["phase_sparse_conv_apply"] += BENCH_LOOPS * bs.INNER  # density 1.0
    wrong = {k: (launches["fused"][k], v) for k, v in want.items() if launches["fused"][k] != v}
    if wrong or launches["fused"]["absmax"] or launches["fused"]["sparse_conv_q_narrow_kernel"]:
        raise AssertionError(f"bench_sparse fused: launches (got, want) {wrong}, absmax "
                             f"{launches['fused']['absmax']}, narrow B3 "
                             f"{launches['fused']['sparse_conv_q_narrow_kernel']}")
    rows = {m: benches[m].rows for m in BENCH_MODES}
    return {"rows": rows, "launches": launches, "seconds": seconds}


def _rmcdb_vs_dense(torch, np, dev, smi) -> float:
    """Phase 40: ``rmcdb_roll_matmul`` at the bench's four geometries (P =
    32768, 512x512, f32 plans and x, TF32 off) against the masked dense
    matmul on the card, within 2*K*eps (K = 512)."""
    from tpuseg_torch import bench_sparse as bs
    from tpuseg_torch.ops.rmcdb_lowering import detect_rmcdb_rolls, rmcdb_roll_matmul
    from tpuseg_torch.sparsity.rmcdb import BlockletType, RmcdbConfig, prune_as_rmcdb

    torch.backends.cuda.matmul.allow_tf32 = False  # as set before phase 3
    rng = np.random.default_rng(0)
    w = rng.normal(size=(bs.RMCDB_ROWS, bs.RMCDB_COLS)).astype(np.float32) * 0.05
    x = torch.from_numpy(rng.normal(size=(bs.RMCDB_P, bs.RMCDB_COLS)).astype(np.float32)).to(dev)
    err = 0.0
    for bh, b, count in bs.RMCDB_GEOMETRIES:
        mask, _ = prune_as_rmcdb(w, RmcdbConfig(bh=bh, bw=bh, spo=0.0,
                                                bl_types=[BlockletType(b, b)],
                                                bl_counts=[count]))
        mask = mask.astype(np.float32)
        plan = detect_rmcdb_rolls(w, mask, bh, bh, b, dtype=torch.float32).to(dev)
        want = x @ torch.from_numpy(w * mask).to(dev).t()
        err = max(err, _close(torch, np, "rmcdb_roll_vs_masked_dense",
                              rmcdb_roll_matmul(x, plan), want, bs.RMCDB_COLS,
                              geometry=[bh, b, count], density=plan.density, card=smi))
    return err


def _native_sparsity(np, smi) -> dict:
    """Phase 40: the port's native sparsity library built on this machine
    (``g++`` into ``tpuseg_torch/_build/``) and one rmb mask, a 512x4608
    layer (DRN-D-22's layer.6 3x3 convs' matrix) at 64x64 blocks, 50 % outer
    sparsity, 8 2x2 blocklets, equal to the numpy path; build and mask
    seconds."""
    from tpuseg_torch import native, native_build
    from tpuseg_torch.sparsity.rmb import BlockletType, RmbConfig, prune_as_rmb

    t0 = time.perf_counter()
    path = native_build.build_sparsity()
    build_s = time.perf_counter() - t0
    mat = np.random.default_rng(5).normal(size=(512, 4608)).astype(np.float32)
    cfg = RmbConfig(64, 64, 0.5, [BlockletType(2, 2)], [8])
    native.lib()
    t0 = time.perf_counter()
    got = native.rmb_prune(mat, 64, 64, 0.5, cfg.bl_types, cfg.bl_counts)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, _ = prune_as_rmb(mat.astype(np.float64), cfg)
    numpy_s = time.perf_counter() - t0
    equal = bool(np.array_equal(got, want.astype(np.float32)))
    row = {"library": os.path.relpath(path), "build_s": build_s, "rmb_native_s": native_s,
           "rmb_numpy_s": numpy_s, "mask_equal": equal, "density": float(got.mean())}
    _emit(phase="native_sparsity", **row, card=smi)
    if not equal or os.path.dirname(os.path.realpath(path)) != os.path.realpath(
            native_build.BUILD_DIR):
        raise AssertionError(f"native sparsity: {row}")
    return row


PROFILE_SEG_VIDEO = ["--video", "synthetic", "--size", "1024x2048", "--frames", "8",
                     "--batch", "8"]
PROFILE_SEG_VIDEO_FORWARDS = 2  # run()'s warm-up forward and one batch of 8
PROFILE_TRAIN = ["train", "--synthetic", "8", "-s", "512", "--batch-size", "4", "--epochs", "1",
                 "--eval-every", "1"]


def _trace_events(logdir) -> tuple[list, str, int]:
    import glob

    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"{logdir}: want one trace file, found {files}")
    with open(files[0]) as fh:
        return json.load(fh)["traceEvents"], files[0], os.path.getsize(files[0])


def _profile_dirs(torch, workdir, smi) -> dict:
    """Phase 41: ``seg_video --profile-dir`` (8 synthetic 1024x2048 frames,
    batch 8) and ``semantic_seg train --profile-dir`` (2 steps of crop 512,
    batch 4): each writes one Chrome trace holding CUDA kernel events, the
    serving one B1's kernel; the trace sizes and event counts."""
    from tpuseg_torch.cli import semantic_seg, seg_video

    from tpuseg_torch.ops.upsample import upsample_argmax

    out = {}
    for name, fn, argv in (("seg_video", seg_video.main, PROFILE_SEG_VIDEO),
                           ("semantic_seg", semantic_seg.main,
                            PROFILE_TRAIN + ["--save-dir", f"{workdir}/prof_train_run"])):
        logdir = f"{workdir}/prof_{name}"
        _zero_counts(torch, upsample_argmax)
        t0 = time.perf_counter()
        _quiet(fn, argv + ["--profile-dir", logdir])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        b1 = upsample_argmax.launches
        events, path, size = _trace_events(logdir)
        kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        row = {"seconds": seconds, "b1_launches": b1, "trace_bytes": size, "events": len(events),
               "kernel_events": len(kernels),
               "b1_kernel_events": sum("upsample_argmax_kernel" in k for k in kernels),
               "cpu_op_events": sum(e.get("cat") == "cpu_op" for e in events)}
        _emit(phase="profile_dir", command=name, argv=argv, **row, card=smi)
        if not kernels or (name == "seg_video" and not (
                row["b1_kernel_events"] and b1 == PROFILE_SEG_VIDEO_FORWARDS)):
            raise AssertionError(f"{name} --profile-dir: {row}")
        out[name] = row
    return out


# phases 42-45: data-parallel training, serving over a mesh, spatial
# H-sharding and the directory envelope (tpuseg_torch.parallel,
# tpuseg_torch.train.orbax_ckpt).  The script needs one card, so the
# multi-rank paths run as two gloo ranks sharing cuda:0 (NCCL refuses two
# ranks on one GPU); NCCL itself runs a one-rank group.
DP_CROP = 512
DP_BATCH = 8  # global: 4 a rank
DP_STEPS = 2
MESH_BATCH = 8
SPATIAL_RANKS = 2


def _f32_card(device):
    """torch with TF32 off (phase 3's setting), this rank's device, and a
    synchronize for it."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":  # the device the rank joined its group on
        dev = torch.device("cuda", torch.cuda.current_device())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    return torch, dev, sync


def _params_digest(ts) -> str:
    import hashlib

    h = hashlib.sha256()
    for part in (ts.params, ts.bn_state):
        for k in sorted(part):
            h.update(part[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_setup(torch, np, dev, batch, crop):
    """(train state, step, batch) of phase 42's run: DRN-D-22, f32,
    --sparse-exec on block128reg_87.50's static masks, lr 0.01."""
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.sparsity import create_masker

    params, state, spec = init_drnseg(0, ARCH, CLASSES)
    masks = create_masker(SERVED_CONFIG, seed=0).generate_masks(params, is_static=True)
    ts, step, _ = _trainer(torch, dev, params, state, spec, masks=masks, sparse=True)
    return ts, step, _train_batch(torch, np, dev, batch, crop, 42)


def _rank_nccl_one(init, device) -> dict:
    """Phase 42 (a), in a process of its own: a one-rank NCCL group on
    cuda:0, one all_reduce, and one step through ``shard_train_step`` (and
    the same step with its collectives driven over NCCL)."""
    import numpy as np
    import torch.distributed as dist

    from tpuseg_torch.parallel import make_mesh, shard_train_step
    from tpuseg_torch.parallel.mesh import Ranks

    torch, dev, sync = _f32_card(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init,
                            world_size=1, rank=0)
    t = torch.arange(8, dtype=torch.float32, device=dev)
    dist.all_reduce(t)
    sync()
    if not torch.equal(t, torch.arange(8, dtype=torch.float32, device=dev)):
        raise AssertionError(f"one-rank NCCL all_reduce changed the tensor: {t}")
    ts, step, batch = _dp_setup(torch, np, dev, 2, 64)
    mesh = make_mesh(data=1, devices=[dev])
    _, m = shard_train_step(step, mesh)(ts, *batch)
    _, m_nccl = step(ts, *batch, ranks=Ranks(group=None, size=1, rank=0))
    return {"backend": dist.get_backend(), "loss": float(m["loss"]),
            "loss_nccl_collectives": float(m_nccl["loss"])}


def _rank_dp_train(device, crop, batch, steps) -> dict:
    """Phase 42 (b), in each of two gloo ranks on cuda:0: DP_STEPS steps of
    the global batch's half; per step the replica digest, B2's launches
    and the ms of the step; then the ms of one flat all-reduce of every
    gradient (the step's own collective)."""
    import numpy as np

    from tpuseg_torch.ops import sparse_train as tst
    from tpuseg_torch.parallel import make_mesh, shard_batch, shard_train_step

    torch, dev, sync = _f32_card(device)
    mesh = make_mesh(data=2, devices=[dev, dev])
    ts, step, (images, labels) = _dp_setup(torch, np, dev, batch, crop)
    step = shard_train_step(step, mesh)
    x, y = shard_batch(mesh, [images, labels])
    out = {"digests": [], "b2": [], "ms": [], "loss": []}
    for _ in range(steps):
        sync()
        tst.sparse_conv_train_forward.launches = tst.sparse_conv_train_dgrad.launches = 0
        t0 = time.perf_counter()
        ts, m = step(ts, x, y)
        sync()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["b2"].append((tst.sparse_conv_train_forward.launches,
                          tst.sparse_conv_train_dgrad.launches))
        out["digests"].append(_params_digest(ts))
        out["loss"].append(float(m["loss"]))
        if mesh.rank == 0 and len(out["loss"]) == 1:  # the state the reference checks
            out["params"] = {k: v.cpu() for k, v in ts.params.items()}
            out["bn_state"] = {k: v.cpu() for k, v in ts.bn_state.items()}
    ranks = mesh.ranks()
    grads = {k: torch.zeros_like(v) for k, v in ts.params.items()}
    ranks.sum_grads(grads)
    sync()
    t0 = time.perf_counter()
    ranks.sum_grads(grads)
    sync()
    out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
    out["allreduce_bytes"] = sum(v.numel() * 4 for v in grads.values())
    return out


def _data_parallel_training(torch, np, dev, smi) -> dict:
    """Phase 42: (a) a one-rank NCCL group; (b) two gloo ranks sharing
    cuda:0 train DRN-D-22 at crop 512, global batch 8, f32, --sparse-exec
    on block128reg_87.50 masks, for DP_STEPS steps: the replicas bit-equal
    after each step, the parameters and running stats within phase 32's
    f32 tolerance of one process's 8-batch steps, and each rank's B2
    forward and dgrad launches equal to that step's."""
    import tempfile

    from tpuseg_torch.ops import sparse_train as tst
    from tpuseg_torch.parallel.mesh import spawn_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        nccl = spawn_ranks(_rank_nccl_one, 1, dev.type, args=(f"file://{tmp}/store", dev.type),
                           timeout=300)[0]
    if nccl["backend"] != ("nccl" if dev.type == "cuda" else "gloo") or not abs(nccl["loss"] - nccl["loss_nccl_collectives"]) <= \
            1e-5 * abs(nccl["loss"]):
        raise AssertionError(f"one-rank NCCL step: {nccl}")
    nccl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spawn_ranks(_rank_dp_train, 2, dev.type, args=(dev.type, DP_CROP, DP_BATCH, DP_STEPS),
                        backend="gloo", timeout=600)
    ranks_s = time.perf_counter() - t0
    for i in range(DP_STEPS):
        if ranks[0]["digests"][i] != ranks[1]["digests"][i]:
            raise AssertionError(f"replicas differ after step {i + 1}")
    # one process, the whole batch: the reference and the 1-rank step time
    ts, step, batch = _dp_setup(torch, np, dev, DP_BATCH, DP_CROP)
    one = {"b2": [], "ms": [], "loss": []}
    first = None
    for _ in range(DP_STEPS):
        _zero_counts(torch, tst.sparse_conv_train_forward, tst.sparse_conv_train_dgrad)
        t1 = time.perf_counter()
        ts, m = step(ts, *batch)
        torch.cuda.synchronize()
        one["ms"].append((time.perf_counter() - t1) * 1e3)
        one["b2"].append((tst.sparse_conv_train_forward.launches,
                          tst.sparse_conv_train_dgrad.launches))
        one["loss"].append(float(m["loss"]))
        first = first or ts
    for r in ranks:
        if [tuple(b) for b in r["b2"]] != one["b2"]:
            raise AssertionError(f"B2 launches a rank {r['b2']}, one process {one['b2']}")
    # the first step against one process's (the trajectories of masked
    # steps drift apart at float rounding after it: on the CPU at crop 64
    # rounding-level input changes move the second step's loss past 1e-4)
    if not abs(ranks[0]["loss"][0] - one["loss"][0]) <= 1e-4 * abs(one["loss"][0]):
        raise AssertionError(f"2-rank loss {ranks[0]['loss']}, one process {one['loss']}")

    class _State:
        params, bn_state = ranks[0]["params"], ranks[0]["bn_state"]

    _close_states(torch, np, "2 gloo ranks vs one process, step 1", _State, first)
    del ts, first, step, batch
    torch.cuda.empty_cache()
    b2 = {"sparse_conv_train_forward": sum(r["b2"][i][0] for r in ranks for i in range(DP_STEPS)),
          "sparse_conv_train_dgrad": sum(r["b2"][i][1] for r in ranks for i in range(DP_STEPS))}
    _emit(phase="data_parallel_training", ranks=2, backend="gloo", device="cuda:0 (shared)",
          crop=DP_CROP, global_batch=DP_BATCH, steps=DP_STEPS, dtype="float32",
          sparse_exec=SERVED_CONFIG, replicas_bit_equal=True,
          ms_per_step_2_ranks=[r["ms"] for r in ranks], ms_per_step_1_rank=one["ms"],
          allreduce_ms=[r["allreduce_ms"] for r in ranks],
          allreduce_bytes=ranks[0]["allreduce_bytes"],
          b2_launches_per_rank_step=ranks[0]["b2"], b2_launches_one_process_step=one["b2"],
          loss_2_ranks=ranks[0]["loss"], loss_1_rank=one["loss"], nccl_one_rank=nccl,
          nccl_phase_seconds=round(nccl_s, 1), ranks_seconds=round(ranks_s, 1), card=smi)
    return {"launches": b2}


def _serving_mesh(torch, np, dev, params, state, spec, frames, smi) -> dict:
    """Phase 43: ``VideoSegmenter(mesh=make_mesh(data=2, devices=[cuda:0,
    cuda:0]))`` at 1024x2048, batch 8: f32 dense ids bit-equal to the
    one-device segmenter at the replicas' batch (4), int8 ids agreeing
    >= 0.99 with the one-device int8 segmenter at batch 8 and bit-equal at
    batch 4; B1, B3 and the quantize pass launched exactly once per
    replica forward; a replica copied to the card gives the same ids; a
    Pallas-lowered plan refused."""
    from tpuseg_torch.ops.sparse_conv import (fused_sparse_conv_apply_q, quantize_activation,
                                              sparse_conv_q_kernel, sparse_conv_q_narrow_kernel)
    from tpuseg_torch.ops.upsample import upsample_argmax
    from tpuseg_torch.parallel import make_mesh
    from tpuseg_torch.video.pipeline import VideoSegmenter

    mesh = make_mesh(data=2, devices=[dev, dev])
    served = frames[:MESH_BATCH]
    calib = frames[MESH_BATCH:MESH_BATCH + 4]
    counters = (upsample_argmax, fused_sparse_conv_apply_q, quantize_activation,
                sparse_conv_q_kernel, sparse_conv_q_narrow_kernel)

    def serve(quantize, batch, on_mesh):
        seg = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                             compute_dtype=torch.float32, batch=batch, quantize=quantize,
                             calib_frames=calib if quantize else None,
                             mesh=mesh if on_mesh else None)
        # one forward of a replica's frames: the per-forward launch counts
        x = torch.from_numpy(np.stack(served[:batch]).reshape(batch, FULL[0], -1)).to(dev)
        seg.ids_for(x)
        _zero_counts(torch, *counters)
        seg.ids_for(x)
        torch.cuda.synchronize()
        per_forward = [f.launches for f in counters]
        _zero_counts(torch, *counters)
        t0 = time.perf_counter()
        res = seg.run(served, need_color=False)
        torch.cuda.synchronize()
        out = {"ids": res["ids"], "seconds": time.perf_counter() - t0, "fps": res["fps"],
               "launches": [f.launches for f in counters], "per_forward": per_forward}
        if on_mesh:
            # a replica for another card is this segmenter copied there
            # (weights, frontend, plans): on cuda:0 its ids are the same
            with torch.inference_mode():
                rep = seg._replica_on(torch.device(dev))._replica_ids(x[:batch // 2])
                if not torch.equal(rep, seg._replica_ids(x[:batch // 2])):
                    raise AssertionError("a copied replica's ids differ")
        del seg
        torch.cuda.empty_cache()
        return out

    out = {}
    for quantize in (False, True):
        tag = "int8" if quantize else "f32"
        m = serve(quantize, MESH_BATCH, True)
        one4 = serve(quantize, MESH_BATCH // 2, False)
        if not np.array_equal(m["ids"], one4["ids"]):
            raise AssertionError(f"{tag}: mesh ids differ from the one-device segmenter at "
                                 f"batch {MESH_BATCH // 2}")
        # run(): the untimed first call and the timed one, each split over
        # the 2 replicas, each replica one forward of 4 frames
        want = [4 * n for n in one4["per_forward"]]
        if m["launches"] != want or m["per_forward"] != [2 * n for n in one4["per_forward"]]:
            raise AssertionError(f"{tag}: launches on the mesh {m['launches']} "
                                 f"(a forward {m['per_forward']}), want {want}")
        # B3's every launch on its 128-wide kernel
        if quantize and not (m["launches"][1] > 0
                             and m["launches"][1] == m["launches"][2] == m["launches"][3]
                             and m["launches"][4] == 0):
            raise AssertionError(f"int8: B3 {m['launches'][1]}, quantize {m['launches'][2]}, "
                                 f"its kernels {m['launches'][3:]}")
        one8 = serve(quantize, MESH_BATCH, False)
        agree = _agreement(m["ids"], one8["ids"])
        if quantize and agree < 0.99:
            raise AssertionError(f"int8 mesh vs one device (batch 8) agreement {agree} < 0.99")
        out[tag] = {"launches": dict(zip(("upsample_argmax", "b3", "quantize",
                                          "sparse_conv_q_kernel",
                                          "sparse_conv_q_narrow_kernel"), m["launches"])),
                    "agreement_vs_batch8": agree, "mesh_seconds": m["seconds"],
                    "one_device_seconds": one8["seconds"], "mesh_fps": m["fps"],
                    "one_device_fps": one8["fps"]}
    masked, pallas, _ = _pruned(torch, params, state, spec, SERVED_CONFIG, "pallas",
                                torch.bfloat16)
    try:
        VideoSegmenter(masked, state, spec, MEAN, STD, device=dev, batch=MESH_BATCH,
                       exec_plans=pallas, mesh=mesh)
    except ValueError as e:
        refused = str(e)[:80]
    else:
        raise AssertionError("a Pallas-lowered plan was served over the mesh")
    _emit(phase="serving_mesh", mesh={"data": 2, "devices": "cuda:0, cuda:0"},
          size=list(FULL), batch=MESH_BATCH, f32=out["f32"], int8=out["int8"],
          pallas_refused=refused, card=smi)
    return {"upsample_argmax": out["f32"]["launches"]["upsample_argmax"]
            + out["int8"]["launches"]["upsample_argmax"],
            "fused_sparse_conv_apply_q": out["int8"]["launches"]["b3"],
            "sparse_conv_q_kernel": out["int8"]["launches"]["sparse_conv_q_kernel"],
            "sparse_conv_q_narrow_kernel": out["int8"]["launches"]["sparse_conv_q_narrow_kernel"],
            "quantize_activation": out["int8"]["launches"]["quantize"]}


def _rank_spatial(device, full) -> dict:
    """Phase 44, in each of SPATIAL_RANKS gloo ranks on cuda:0: the
    H-sharded f32 forward of full-width DRN-D-22 on one 1024x2048 frame
    (``spatial_forward``), its largest difference from the unsharded
    forward, and the ms of each (the second of two calls)."""
    import numpy as np

    from tpuseg_torch.models.drnseg import drnseg_forward, init_drnseg
    from tpuseg_torch.parallel import make_mesh, spatial_forward

    torch, dev, sync = _f32_card(device)
    params, state, spec = init_drnseg(0, ARCH, CLASSES)
    params = {k: v.to(dev) for k, v in params.items()}
    state = {k: v.to(dev) for k, v in state.items()}
    mesh = make_mesh(data=1, spatial=SPATIAL_RANKS, devices=[dev] * SPATIAL_RANKS)
    x = torch.from_numpy(np.random.default_rng(44).random((1, *full, 3),
                                                           dtype=np.float32)).to(dev)
    fwd = spatial_forward(
        lambda p, s, v, ranks: drnseg_forward(p, s, v, spec, train=False, ranks=ranks)[0],
        mesh)
    times = {}
    for name, fn in (("spatial", lambda: fwd(params, state, x)),
                     ("unsharded", lambda: drnseg_forward(params, state, x, spec,
                                                          train=False)[0])):
        with torch.no_grad():
            for _ in range(2):
                sync()
                t0 = time.perf_counter()
                y = fn()
                sync()
                times[name] = (time.perf_counter() - t0) * 1e3
        times[name + "_out"] = y
    got, want = times.pop("spatial_out"), times.pop("unsharded_out")
    err = (got - want).abs()
    bad = int((err > 2e-4 + 2e-4 * want.abs()).sum())
    return {"ms": times, "max_abs_err": float(err.max()), "violations": bad,
            "shape": list(got.shape)}


def _spatial(torch, dev, smi) -> dict:
    """Phase 44: SPATIAL_RANKS gloo ranks on cuda:0, one 1024x2048 f32
    frame through full-width DRN-D-22 with H sharded: the logits within
    tpuseg's 2e-4 (rtol and atol) of the unsharded forward."""
    from tpuseg_torch.parallel.mesh import spawn_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(_rank_spatial, SPATIAL_RANKS, dev.type, args=(dev.type, FULL),
                        backend="gloo", timeout=600)
    for r in ranks:
        if r["violations"] or r["shape"] != [1, *FULL, CLASSES]:
            raise AssertionError(f"spatial forward: {r}")
    _emit(phase="spatial_forward", ranks=SPATIAL_RANKS, backend="gloo",
          device="cuda:0 (shared)", size=list(FULL), dtype="float32",
          ms=[r["ms"] for r in ranks], max_abs_err=max(r["max_abs_err"] for r in ranks),
          tolerance={"rtol": 2e-4, "atol": 2e-4}, seconds=round(time.perf_counter() - t0, 1),
          card=smi)
    return ranks[0]


def _directory_envelope(torch, np, dev, workdir, smi) -> dict:
    """Phase 45: the directory envelope of a full-width DRN-D-22 train
    state (f32 params, BN state, momentum): a blocking save; an async save
    that returns after staging while a train step runs, then
    ``wait_for_saves``; both load with arrays equal to the saved state; a
    committed ``.new`` preferred, an uncommitted one removed by the next
    save, ``.old`` the fallback."""
    import shutil

    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.train import load_checkpoint, save_checkpoint
    from tpuseg_torch.train.checkpoint import _flatten_opt
    from tpuseg_torch.train.orbax_ckpt import wait_for_saves

    params, state, spec = init_drnseg(0, ARCH, CLASSES)
    ts, step, _ = _trainer(torch, dev, params, state, spec)
    batch = _train_batch(torch, np, dev, DP_BATCH // 2, DP_CROP, 45)
    ts, _ = step(ts, *batch)  # a live momentum
    path = f"{workdir}/envelope/checkpoint.orbax"

    def save(ts, **kw):
        save_checkpoint(path, ts.params, ts.bn_state, opt_state=ts.opt_state,
                        meta={"epoch": int(ts.step)}, **kw)

    def equal(ts):
        p, b, _, opt, meta = load_checkpoint(path)
        want_opt = _flatten_opt(ts.opt_state)
        return (meta["epoch"] == ts.step
                and all(torch.equal(p[k], ts.params[k].cpu()) for k in ts.params)
                and all(torch.equal(b[k], ts.bn_state[k].cpu()) for k in ts.bn_state)
                and opt.keys() == want_opt.keys()
                and all(np.array_equal(opt[k], v) for k, v in want_opt.items()))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save(ts)
    blocking_ms = (time.perf_counter() - t0) * 1e3
    if not equal(ts):
        raise AssertionError("a blocking directory save did not load back equal")
    ts_saved = ts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts2, _ = step(ts, *batch)
    torch.cuda.synchronize()
    step_alone_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    save(ts_saved, async_save=True)
    staged_ms = (time.perf_counter() - t0) * 1e3
    ts2, _ = step(ts_saved, *batch)
    torch.cuda.synchronize()
    step_during_ms = (time.perf_counter() - t0) * 1e3 - staged_ms
    t1 = time.perf_counter()
    wait_for_saves()
    wait_ms = (time.perf_counter() - t1) * 1e3
    if not equal(ts_saved):
        raise AssertionError("an async directory save did not load back equal")
    # recovery: a committed .new wins, .old serves, an uncommitted .new goes
    shutil.copytree(path, path + ".new")
    save(ts2)
    if os.path.exists(path + ".new") or not equal(ts2):
        raise AssertionError("the committed .new was not swapped in before the next save")
    shutil.copytree(path, path + ".new")
    os.remove(os.path.join(path + ".new", ".metadata"))
    if not equal(ts2):
        raise AssertionError("an uncommitted .new was read")
    save(ts2)
    if os.path.exists(path + ".new"):
        raise AssertionError("an uncommitted .new survived a save")
    shutil.move(path, path + ".old")
    if not equal(ts2):
        raise AssertionError(".old was not the fallback")
    nbytes = sum(f.stat().st_size for f in os.scandir(path + ".old"))
    _emit(phase="directory_envelope", bytes=nbytes, blocking_save_ms=blocking_ms,
          async_staged_ms=staged_ms, step_alone_ms=step_alone_ms,
          step_during_async_save_ms=step_during_ms, wait_after_step_ms=wait_ms,
          recovery=["committed .new preferred", "uncommitted .new removed", ".old fallback"],
          card=smi)
    del ts, ts2, ts_saved, step, batch
    torch.cuda.empty_cache()
    return {}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    from tpuseg_torch.ops import _build

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. card, versions, build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    _emit(phase="card", name=kind, nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          device_count=torch.cuda.device_count())
    t0 = time.perf_counter()
    lib_path, log = _build.build_library()
    build_s = time.perf_counter() - t0
    _build.load_library()
    _emit(phase="build", seconds=round(build_s, 3), library=lib_path.split("/")[-1],
          ptxas=[ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "Compiling entry" in ln])
    # the worker process that makes phase 23's inputs during phases 19-20
    import multiprocessing

    worker = multiprocessing.get_context("spawn").Pool(1)
    try:
        return _phases(torch, np, dev, t_start, smi, kind, worker)
    finally:
        worker.terminate()
        worker.join()


def _phases(torch, np, dev, t_start, smi, kind, worker) -> int:
    """Phases 2-41 and the closing lines (``main`` builds, then runs these
    with the worker process that makes phase 23's and 27's inputs)."""
    from tpuseg_torch.data.shapes import shapes_video
    from tpuseg_torch.models.drnseg import bilinear_upsample_kernel, init_drnseg
    from tpuseg_torch.ops import _build
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_apply, quantize_activation
    from tpuseg_torch.ops.upsample import upsample_argmax, upsample_argmax_reference
    from tpuseg_torch.video.pipeline import SyntheticFrames, VideoSegmenter

    # 2. kernel vs plain on the card: bit-equal ids
    rng = np.random.default_rng(0)
    sym = bilinear_upsample_kernel()
    max_abs_err = _b1_vs_plain(torch, np, dev, rng, sym)

    # 3. slice parity in f32: CUDA (kernel) vs CPU (plain versions)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params, state, spec = init_drnseg(0, ARCH, CLASSES)
    small = list(SyntheticFrames(2, (256, 512), seed=0))
    ids = {}
    for name in ("cuda", "cpu"):
        seg = VideoSegmenter(params, state, spec, MEAN, STD, device=name,
                             compute_dtype=torch.float32, batch=2)
        ids[name] = seg.run(small, need_color=False)["ids"]
    agree = _agreement(ids["cuda"], ids["cpu"])
    _emit(phase="slice_parity_f32", tf32=False, size=[256, 512], frames=2,
          ids_agreement=agree, limit=0.999)
    if agree < 0.999:
        raise AssertionError(f"f32 CUDA vs CPU ids agreement {agree} < 0.999")

    # 4. the slice at full width and size
    t0 = time.perf_counter()
    frames = list(shapes_video(32, FULL, seed=0)[0])
    gen_s = time.perf_counter() - t0
    serve = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                           compute_dtype=torch.bfloat16, batch=8)
    torch.cuda.synchronize()
    upsample_argmax.launches = 0
    res = serve.run(frames, need_color=False)
    torch.cuda.synchronize()
    launches = upsample_argmax.launches
    out = dense_ids = res["ids"]
    assert out.shape == (32,) + FULL and out.dtype == np.uint8, (out.shape, out.dtype)
    assert int(out.max()) < CLASSES
    if launches <= 0:
        raise AssertionError("the served slice never launched the upsample_argmax kernel")
    ref32 = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                           compute_dtype=torch.float32, batch=8)
    agree_bf16 = _agreement(out, ref32.run(frames, need_color=False)["ids"])
    _emit(phase="slice_full", arch=ARCH, classes=CLASSES, size=list(FULL),
          dtype="bfloat16", batch=8, frames=res["frames"], run_fps=res["fps"],
          run_seconds=res["seconds"], launches=launches,
          bf16_vs_f32_ids_agreement=agree_bf16, limit=0.9,
          frame_gen_seconds=round(gen_s, 3))
    if agree_bf16 < 0.9:
        raise AssertionError(f"bf16 vs f32 ids agreement {agree_bf16} < 0.9")
    bench = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                           compute_dtype=torch.bfloat16, batch=32)
    device_fps = bench.benchmark_device_fps(FULL)
    _emit(phase="device_fps", arch=ARCH, size=list(FULL), dtype="bfloat16",
          batch=32, device_fps=device_fps, card=smi)
    del serve, ref32, bench
    torch.cuda.empty_cache()

    # 5. kernel vs plain time at the serving shape, in turns
    x = torch.from_numpy(
        rng.normal(size=SERVING_LOGITS).astype(np.float32)).to(dev, torch.bfloat16)
    plain = [_time_ms(torch, lambda: upsample_argmax_reference(x, sym), 3)]
    kern = [_time_ms(torch, lambda: upsample_argmax(x, sym), 20) for _ in range(2)]
    plain.append(_time_ms(torch, lambda: upsample_argmax_reference(x, sym), 3))
    kernel_ms, plain_ms = min(kern), min(plain)
    # B1's bound from this run's weights, at the card's lane rate
    from tpuseg_torch.ops.upsample import _kernel_1d, _phase_weights

    a, b = _phase_weights(_kernel_1d(sym))
    n_out = SERVING_LOGITS[0] * 64 * SERVING_LOGITS[1] * SERVING_LOGITS[2]
    b1_old_bound = _bound(x.numel() * 2 + n_out, n_out * SERVING_LOGITS[3] * 4.375, "f32")
    lane_rate, sm_clock_mhz = _lane_rate(torch)
    *b1_bound, b1_parts = _b1_bound(SERVING_LOGITS, 2, a, b, lane_rate)
    _emit(phase="kernel_time", shape=list(SERVING_LOGITS), dtype="bfloat16",
          kernel_ms=kern, plain_ms=plain, bound_ms=b1_bound[0], bound_by=b1_bound[1],
          bound_parts=b1_parts, instructions=_b1_instructions(a, b),
          old_bound_ms=b1_old_bound[0], old_bound="4.375 f32 ops at 67e12 (FMA counted 2)",
          lane_instructions_per_s=lane_rate, sm_clock_max_mhz=sm_clock_mhz,
          bound_share=b1_bound[0] / kernel_ms, card=smi)
    del x

    # 6. B2 vs plain on the card (f32 plain convs with TF32 off, set above)
    masked, plans, report = _pruned(torch, params, state, spec, SERVED_CONFIG, "pallas",
                                    torch.bfloat16)
    from tpuseg_torch.ops.fold_bn import fold_bn

    b2_err = _b2_vs_plain(torch, np, dev, rng, plans, fold_bn(masked, state, spec))
    torch.cuda.empty_cache()

    # 7. pruned slice parity in f32: CUDA (kernel) vs CPU (plain versions)
    pmasked, pplans, _ = _pruned(torch, params, state, spec, PARITY_CONFIG, "pallas",
                                 torch.float32)
    ids = {}
    for name in ("cuda", "cpu"):
        seg = VideoSegmenter(pmasked, state, spec, MEAN, STD, device=name,
                             compute_dtype=torch.float32, batch=2, exec_plans=pplans)
        ids[name] = seg.run(small, need_color=False)["ids"]
    agree = _agreement(ids["cuda"], ids["cpu"])
    _emit(phase="pruned_parity_f32", config=PARITY_CONFIG, lowering="pallas", tf32=False,
          size=[256, 512], frames=2, ids_agreement=agree, limit=0.999)
    if agree < 0.999:
        raise AssertionError(f"pruned f32 CUDA vs CPU ids agreement {agree} < 0.999")
    del seg

    # 8. the pruned slice at full width and size
    serve = VideoSegmenter(masked, state, spec, MEAN, STD, device=dev,
                           compute_dtype=torch.bfloat16, batch=8, exec_plans=plans)
    torch.cuda.synchronize()
    fused_sparse_conv_apply.launches = 0
    upsample_argmax.launches = 0
    res = serve.run(frames, need_color=False)
    torch.cuda.synchronize()
    b2_launches, up_launches = fused_sparse_conv_apply.launches, upsample_argmax.launches
    out = pruned_ids = res["ids"]
    assert out.shape == (32,) + FULL and out.dtype == np.uint8, (out.shape, out.dtype)
    assert int(out.max()) < CLASSES
    forwards = 1 + -(-len(frames) // 8)  # run()'s untimed first call + 4 batches
    if b2_launches != B2_PER_FORWARD * forwards or up_launches != forwards:
        raise AssertionError(f"pruned run launched B2 {b2_launches} and upsample_argmax "
                             f"{up_launches} times; want {B2_PER_FORWARD * forwards} "
                             f"and {forwards}")
    dense32 = VideoSegmenter(masked, state, spec, MEAN, STD, device=dev,
                             compute_dtype=torch.float32, batch=8)
    agree_dense = _agreement(out, dense32.run(frames, need_color=False)["ids"])
    _emit(phase="pruned_full", config=SERVED_CONFIG, lowering="pallas", size=list(FULL),
          dtype="bfloat16", batch=8, frames=res["frames"], run_fps=res["fps"],
          run_seconds=res["seconds"], b2_launches=b2_launches,
          upsample_launches=up_launches,
          lowered=sum(1 for v in report.values() if not v.startswith("dense")),
          vs_f32_masked_dense_ids_agreement=agree_dense, limit=0.9)
    if agree_dense < 0.9:
        raise AssertionError(f"pruned bf16 vs f32 masked dense agreement {agree_dense} < 0.9")
    del serve, dense32
    torch.cuda.empty_cache()
    _, gplans, _ = _pruned(torch, params, state, spec, SERVED_CONFIG, "gathered",
                           torch.bfloat16)
    variants = {"pallas": plans, "gathered_exact": gplans, "masked_dense": None}
    pruned_fps = {}
    for name, vplans in variants.items():
        bench = VideoSegmenter(masked, state, spec, MEAN, STD, device=dev,
                               compute_dtype=torch.bfloat16, batch=32, exec_plans=vplans)
        pruned_fps[name] = bench.benchmark_device_fps(FULL, inner=16, reps=2)
        del bench
        torch.cuda.empty_cache()
    _emit(phase="pruned_device_fps", config=SERVED_CONFIG, size=list(FULL), dtype="bfloat16",
          batch=32, device_fps=pruned_fps, card=smi)

    # 9. B2 vs plain vs the dense cuDNN conv at the layer.6.1.conv2 serving shape
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_reference

    plan = plans["layer.6.1.conv2"].to(dev)
    (sn, sh, sw, sc), sk, sd = SERVING_SPARSE
    assert (plan.cin, plan.kernel, plan.dilation) == (sc, sk, sd), plan
    x = torch.from_numpy(rng.normal(size=(sn, sh, sw, sc)).astype(np.float32)).to(dev, torch.bfloat16)
    w_dense = masked["layer.6.1.conv2.weight"].to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    x_nchw = x.permute(0, 3, 1, 2)
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_bias_bf16

    bias6 = torch.randn(plan.cout, device=dev).to(torch.bfloat16)
    turns = _time_turns(torch, {
        "plain": lambda: fused_sparse_conv_reference(x, plan),
        "kernel": lambda: fused_sparse_conv_apply(x, plan),
        "dense_cudnn": lambda: torch.nn.functional.conv2d(x_nchw, w_dense, None, 1, sd, sd),
        "bf16_bias_route": lambda: fused_sparse_conv_bias_bf16(x, plan, bias6),
        "two_passes": lambda: fused_sparse_conv_apply(x, plan).to(torch.bfloat16) + bias6,
    }, {"plain": 3, "kernel": 10, "dense_cudnn": 10, "bf16_bias_route": 10, "two_passes": 10})
    b2_ms, b2_plain_ms = min(turns["kernel"]), min(turns["plain"])
    b2_cudnn_ms = min(turns["dense_cudnn"])
    b2_bound = _b2_bound(sn * sh * sw, plan.vals, plan.rows, plan.cout)
    _emit(phase="b2_time", conv="layer.6.1.conv2", shape=[sn, sh, sw, sc], dilation=sd,
          s=plan.s, dtype="bfloat16", kernel_ms=turns["kernel"], plain_ms=turns["plain"],
          dense_cudnn_ms=turns["dense_cudnn"], bf16_bias_route_ms=turns["bf16_bias_route"],
          two_passes_ms=turns["two_passes"], bound_ms=b2_bound[0], bound_by=b2_bound[1],
          kernel_tflops=2 * sn * sh * sw * sk * sk * plan.s * 128 * plan.cout / b2_ms / 1e9,
          card=smi)

    del x_nchw
    torch.cuda.empty_cache()

    # 10. B3 vs its exact plain version on the card, bit-equal
    from tpuseg_torch.ops.fold_bn import fold_bn
    from tpuseg_torch.ops.quant import build_quant_plans
    from tpuseg_torch.ops.sparse_conv import (fused_sparse_conv_apply_q, sparse_conv_q_kernel,
                                              sparse_conv_q_narrow_kernel)

    dense_int8 = build_quant_plans(fold_bn(params, state, spec), spec)
    served = _served_b3_plans(dense_int8, plans, gplans, fold_bn(masked, state, spec))
    quantize_err = _quantize_vs_cpu(torch, np, dev, rng)
    b3_err = _b3_vs_plain(torch, np, dev, rng, served)
    map_times = _quantize_map_times(torch, dev, served, smi)
    del served
    torch.cuda.empty_cache()

    # 11. int8 slice parity in f32: CUDA (B3) vs CPU (plain versions)
    _int8_parity_f32(torch, np, {"dense": (params, None), "block128_75.00 pallas":
                                 (pmasked, pplans)}, state, spec, small)
    torch.cuda.empty_cache()

    # 12. int8 at full width and size: counts zeroed just before each run
    int8_variants = {  # label -> (params, float plans, calibration frames, float ids)
        "dense": (params, None, None, dense_ids),
        "dense_calibrated": (params, None, frames[:8], None),
        "pallas": (masked, plans, None, pruned_ids),
        "gathered": (masked, gplans, None, pruned_ids),
    }
    forwards = 1 + -(-len(frames) // 8)
    b3_launches = q_launches = map_launches = 0
    int8_ids = {}
    for label, (vparams, vplans, calib, float_ids) in int8_variants.items():
        serve = VideoSegmenter(vparams, state, spec, MEAN, STD, device=dev,
                               compute_dtype=torch.bfloat16, batch=8, exec_plans=vplans,
                               quantize=True, calib_frames=calib)
        kinds = Counter(type(p).__name__ for p in serve.exec_plans.values())
        if calib is not None:
            static = [n for n, p in serve.exec_plans.items() if p.x_scale is not None]
            if len(static) != 13 or len(serve.exec_plans) != 13:
                raise AssertionError(f"calibrated: {len(static)} of {len(serve.exec_plans)} "
                                     "int8 plans carry a static scale; want 13 of 13")
        torch.cuda.synchronize()
        _zero_counts(torch, fused_sparse_conv_apply_q, fused_sparse_conv_apply, upsample_argmax,
                     sparse_conv_q_kernel, sparse_conv_q_narrow_kernel)
        quantize_activation.launches = quantize_activation.absmax_launches = 0
        quantize_activation.map_launches = 0
        res = serve.run(frames, need_color=False)
        torch.cuda.synchronize()
        b3, b2, up = (fused_sparse_conv_apply_q.launches, fused_sparse_conv_apply.launches,
                      upsample_argmax.launches)
        wide, narrow = sparse_conv_q_kernel.launches, sparse_conv_q_narrow_kernel.launches
        quant, absmax = quantize_activation.launches, quantize_activation.absmax_launches
        qmap = quantize_activation.map_launches
        out = res["ids"]
        assert out.shape == (32,) + FULL and out.dtype == np.uint8, (out.shape, out.dtype)
        assert int(out.max()) < CLASSES
        if b3 != B3_PER_FORWARD[label] * forwards or b2 != 0 or up != forwards:
            raise AssertionError(f"int8 {label}: B3 {b3}, B2 {b2}, upsample_argmax {up} "
                                 f"launches; want {B3_PER_FORWARD[label] * forwards}, 0, "
                                 f"{forwards}")
        # every launch on B3's 128-wide kernel
        if wide != b3 or narrow != 0:
            raise AssertionError(f"int8 {label}: B3 {b3} launches, its kernels: 128-wide "
                                 f"{wide}, narrow {narrow}")
        # one quantize pass per B3 launch; the absmax pass only without static scales
        if quant != b3 or absmax != (0 if calib is not None else b3):
            raise AssertionError(f"int8 {label}: quantize {quant}, absmax {absmax} launches "
                                 f"for {b3} B3 launches")
        # the quantize passes through a channel map: CompactSparseQ's, one a forward each
        if qmap != MAP_PER_FORWARD[label] * forwards:
            raise AssertionError(f"int8 {label}: {qmap} quantize passes through a channel "
                                 f"map; want {MAP_PER_FORWARD[label] * forwards}")
        b3_launches += b3
        q_launches += quant
        map_launches += qmap
        int8_ids[label] = out
        ref_label, ref = (("float", float_ids) if float_ids is not None
                          else ("dynamic int8", int8_ids["dense"]))
        agree, limit = _agreement(out, ref), INT8_FULL_MIN[label]
        _emit(phase="int8_full", variant=label, size=list(FULL), dtype="bfloat16", batch=8,
              frames=res["frames"], run_fps=res["fps"], plans=kinds,
              calibrated_frames=0 if calib is None else len(calib), b3_launches=b3,
              quantize_launches=quant, absmax_launches=absmax, quantize_map_launches=qmap,
              b2_launches=b2, upsample_launches=up, ids_agreement=agree,
              agreement_with=ref_label, limit=limit)
        if agree < limit:
            raise AssertionError(f"int8 {label} vs {ref_label} ids agreement {agree} < {limit}")
        del serve
        torch.cuda.empty_cache()

    # 13. int8 device fps, and B3 vs plain vs B2 vs cuDNN at layer.6.1.conv2
    int8_fps = {}
    for label, (vparams, vplans, calib, _) in int8_variants.items():
        bench = VideoSegmenter(vparams, state, spec, MEAN, STD, device=dev,
                               compute_dtype=torch.bfloat16, batch=32, exec_plans=vplans,
                               quantize=True, calib_frames=calib)
        int8_fps[label] = bench.benchmark_device_fps(FULL, inner=16, reps=2)
        del bench
        torch.cuda.empty_cache()
    _emit(phase="int8_device_fps", size=list(FULL), dtype="bfloat16", batch=32,
          device_fps=int8_fps, card=smi)
    from tpuseg_torch.ops.quant import full_support_packing, quantize_weight
    from tpuseg_torch.ops.sparse_conv import (
        fused_sparse_conv_q_bias_bf16, fused_sparse_conv_q_bias_bf16_reference,
        quantize_activation_reference, quantize_fused_plan)

    qplan = quantize_fused_plan(plans["layer.6.1.conv2"]).to(dev)
    # the dense int8 conv as dense int8 serving runs it: the unpruned weight
    w6 = params["layer.6.1.conv2.weight"].numpy().transpose(2, 3, 1, 0)
    qdense = full_support_packing("layer.6.1.conv2", *quantize_weight(w6), sd, sd).to(dev)
    xq, xs = quantize_activation(x, None)
    out6 = {dt: torch.empty((sn, sh, sw, qplan.cout), device=dev, dtype=dt)
            for dt in (torch.float32, torch.bfloat16)}
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def b3_kernel_only(bf16_out):
        o = out6[torch.bfloat16 if bf16_out else torch.float32]
        err = lib.tpuseg_sparse_conv_q(
            xq.data_ptr(), qplan.vals_k.data_ptr(), qplan.rows.data_ptr(),
            qplan.steps.data_ptr(), qplan.nsteps.data_ptr(), qplan.w_scale.data_ptr(),
            xs.data_ptr(), bias6.data_ptr() if bf16_out else None, o.data_ptr(),
            sn, sh, sw, sc, qplan.cout, qplan.s, qplan.kernel, qplan.dilation, int(bf16_out),
            stream)
        assert err == 0, err

    x_nchw = x.permute(0, 3, 1, 2)
    turns = _time_turns(torch, {
        "b3_plain": lambda: fused_sparse_conv_q_bias_bf16_reference(x, qplan, bias6),
        "b3_served": lambda: fused_sparse_conv_q_bias_bf16(x, qplan, bias6),
        "b3_f32": lambda: fused_sparse_conv_apply_q(x, qplan),
        "b3_kernel_only": lambda: b3_kernel_only(True),
        "b3_kernel_only_f32": lambda: b3_kernel_only(False),
        "quantize": lambda: quantize_activation(x, None),
        "quantize_static": lambda: quantize_activation(x, 0.013),
        "quantize_plain": lambda: quantize_activation_reference(x, None),
        "b2": lambda: fused_sparse_conv_apply(x, plan),
        "dense_cudnn_bias": lambda: torch.nn.functional.conv2d(x_nchw, w_dense, bias6, 1, sd,
                                                               sd),
        "b3_dense_s4_served": lambda: fused_sparse_conv_q_bias_bf16(x, qdense, bias6),
    }, {"b3_plain": 2, "b3_served": 10, "b3_f32": 10, "b3_kernel_only": 10,
        "b3_kernel_only_f32": 10, "quantize": 10, "quantize_static": 10, "quantize_plain": 3,
        "b2": 10, "dense_cudnn_bias": 10, "b3_dense_s4_served": 5})
    b3_ms, b3_plain_ms = min(turns["b3_served"]), min(turns["b3_plain"])
    k_ms = min(turns["b3_kernel_only"])
    # the served function: bf16 x in (all of it: the per-frame scale is its
    # absmax), the live int8 tiles, bf16 y out with its bias, int8 operations
    b3_live = _live_tiles(qplan.vals)
    b3_bound = _bound(x.numel() * 2 + b3_live * 128 * 128 + qplan.w_scale.numel() * 4
                      + qplan.rows.numel() * 4 + qplan.cout * 2 + sn * sh * sw * qplan.cout * 2,
                      2 * sn * sh * sw * b3_live * 128 * 128, "int8")
    # the quantize pass's function: x read once, int8 x and the scales
    # written once; one division an element
    q_ms, q_plain_ms = min(turns["quantize"]), min(turns["quantize_plain"])
    q_bound = _bound(x.numel() * 3 + sn * 4, x.numel(), "f32")
    _emit(phase="b3_time", conv="layer.6.1.conv2", shape=[sn, sh, sw, sc], dilation=sd,
          s=qplan.s, live_tiles=b3_live, x_dtype="bfloat16", ms=turns, card=smi,
          bound_ms=b3_bound[0], bound_by=b3_bound[1], quantize_bound_ms=q_bound[0],
          kernel_tops=2 * sn * sh * sw * b3_live * 128 * 128 / k_ms / 1e9,
          dense_s4_live_tiles=_live_tiles(qdense.vals),
          dense_s4_served_tops=2 * sn * sh * sw * _live_tiles(qdense.vals) * 128 * 128
          / min(turns["b3_dense_s4_served"]) / 1e9)

    del x_nchw, xq, out6
    torch.cuda.empty_cache()
    _served_w128_times(torch, dev, x, plan, qplan, bias6, smi)
    del x
    torch.cuda.empty_cache()

    # 14-16. slice 4's kernels vs their plain versions (TF32 off, set above)
    b4_err = _b4_vs_plain(torch, np, dev, rng, smi)
    b56_err = _b56_vs_plain(torch, np, dev, rng)
    b7_err = _b7_vs_plain(torch, np, dev, rng, smi)
    # 17. this slice's paths, counts zeroed just before each
    s4_launches = _slice4_paths(torch, dev)
    # 18. times at the batch-32 shapes
    s4_times = _slice4_times(torch, np, dev, smi)

    # 19-21. the int8 stem: B3's stem route and the padded quantize pass on
    # recorded inputs, f32 parity, bench.py's int8_stem mode; during 19 and
    # 20 the worker makes phase 23's frames and CPU selection
    budget_inputs = worker.apply_async(_budget_inputs)
    frames_dev = torch.from_numpy(np.stack(frames).reshape(len(frames), FULL[0], -1)).to(dev)
    stem_seg = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                              compute_dtype=torch.bfloat16, batch=32, quantize=True,
                              quantize_stem=True, calib_frames=frames[:8])
    stem_k = _int8_stem_kernels(torch, np, dev, stem_seg, frames_dev, smi)
    _int8_stem_parity_f32(torch, np, params, state, spec, small)
    inputs = budget_inputs.get(timeout=900)
    worker.close()
    stem_full = _int8_stem_full(torch, np, dev, params, state, spec, frames,
                                int8_ids["dense_calibrated"], stem_seg, frames_dev, smi)
    del stem_seg, frames_dev
    torch.cuda.empty_cache()
    # 22-24. batched temporal serving: K3 and K4, bench.py's
    # sparse_int8_budget8, interval mode
    temporal_k = _temporal_kernels(torch, np, dev, frames, smi)
    budget = _budget_full(torch, np, dev, masked, state, spec, gplans, frames[:8], inputs, smi)
    _interval_full(torch, np, dev, params, state, spec, frames, smi)
    # 25-30. this slice: K5-K8 against their plain versions, interval and
    # budgeted serving with nearest and warped reuse, the sequential adaptive
    # mode, the yuv420 transport with the device resize and packed ids, the
    # CLI's autotuning
    new_k = _new_kernels(torch, np, dev, frames, smi)
    interval_warp = _interval_warp_full(torch, np, dev, params, state, spec, frames, smi)
    budget_warp = _budget_warp_full(torch, np, dev, masked, state, spec, gplans, frames[:8],
                                    inputs, smi)
    del inputs
    sequential = _sequential_full(torch, np, dev, params, state, spec, frames, smi)
    transport = _transport_full(torch, np, dev, params, state, spec, smi)
    _cli_autotune(smi)
    # 31-33. segmentation training: sparse_conv_train's two B2 roles against
    # their plain version, then the trainer's CLI dense, masked and with
    # --sparse-exec at crop 512, batch 8
    train_k = _train_kernels(torch, np, dev, rng, smi)
    torch.cuda.empty_cache()
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        _dense_training(torch, np, dev, workdir, smi)
        train_sparse = _sparse_training(torch, np, dev, workdir, smi)
        torch.cuda.empty_cache()
        # 34-36. the trained-weights fidelity tool, remat_mem, and seg_video
        # serving the tool's checkpoint
        fidelity = _trained_fidelity(torch, f"{workdir}/fidelity", smi)
        torch.cuda.empty_cache()
        _remat_mem(smi)
        torch.cuda.empty_cache()
        _pretrained_serving(torch, np, dev, f"{workdir}/fidelity/{ARCH}_shapes.npz", workdir, smi)
        torch.cuda.empty_cache()
        # 37-39. the classifier arm: DRN-D-22 classifier training with
        # --sparse-exec at 224x224 and B2 on the classifier's small maps, the
        # classifier CLIs (B3's padded route), the cls tools
        cls_train = _cls_training(torch, np, dev, rng, workdir, smi)
        torch.cuda.empty_cache()
        cls_clis = _cls_clis(torch, np, workdir, smi)
        torch.cuda.empty_cache()
        _cls_tools(torch, f"{workdir}/fidelity_cls", smi)
        torch.cuda.empty_cache()
        # 40-41. the rest of bench_sparse (every mode of this slice), the
        # frontend's stage-3 int8 convs bit-equal to their plain version,
        # the RMCDB roll lowering against the masked dense matmul, the
        # native sparsity library; --profile-dir in both CLIs
        t40 = time.perf_counter()
        bench = _bench_modes(torch, np, dev, smi)["launches"]
        torch.cuda.empty_cache()
        _frontend_stage3_bit_equal(torch, np, dev, smi)
        _rmcdb_vs_dense(torch, np, dev, smi)
        _native_sparsity(np, smi)
        torch.cuda.empty_cache()
        t41 = time.perf_counter()
        profiles = _profile_dirs(torch, workdir, smi)
        torch.cuda.empty_cache()
        # 42-45. data-parallel training (a one-rank NCCL group; two gloo
        # ranks sharing the card), serving over a mesh, the H-sharded
        # forward, the directory envelope
        t42 = time.perf_counter()
        dp = _data_parallel_training(torch, np, dev, smi)
        t43 = time.perf_counter()
        mesh_serving = _serving_mesh(torch, np, dev, params, state, spec, frames, smi)
        t44 = time.perf_counter()
        _spatial(torch, dev, smi)
        t45 = time.perf_counter()
        _directory_envelope(torch, np, dev, workdir, smi)
        _emit(phase="phase_seconds", phase_40=round(t41 - t40, 1),
              phase_41=round(t42 - t41, 1), phase_42=round(t43 - t42, 1),
              phase_43=round(t44 - t43, 1), phase_44=round(t45 - t44, 1),
              phase_45=round(time.perf_counter() - t45, 1))

    _emit(phase="total", seconds=round(time.perf_counter() - t_start, 1))
    sc_src, b2_src = "tpuseg/ops/sparse_conv.py", "tpuseg_torch/csrc/sparse_conv.cu"

    def entry(name, source, replaces, launched, err, ms, plain, bound, library):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launched, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library}

    def s4(name, source, replaces, err):
        t = s4_times[name]
        return entry(name, source, replaces, s4_launches[name], err, t["ms"], t["plain_ms"],
                     (t["bound_ms"], t["bound_by"]), t["library_ms"])

    def timed(name, source, replaces, launched, t):
        e = entry(name, source, replaces, launched, 0.0, t["ms"], t["plain_ms"],
                  (t["bound_ms"], t["bound_by"]), t["library_ms"])
        if "device_ms" in t:  # K5-K8: torch.profiler's device time beside back to back
            e["device_ms"] = t["device_ms"]
        return e

    # B3's entry points and the quantize kernels: the four int8 runs, the
    # int8-stem run and the budgeted run
    phase12_b3 = b3_launches  # all on B3's 128-wide kernel (checked there)
    b3_launches += stem_full["launches"]["b3"] + budget["launches"]["fused_sparse_conv_apply_q"]
    q_launches += stem_full["launches"]["quantize"] + budget["launches"]["quantize_activation"]
    map_launches += stem_full["launches"]["quantize_map"]
    # and phase 34's stages (read around each stage)
    fid = fidelity["total"]
    launches += fid["upsample_argmax"]
    b2_launches += fid["fused_sparse_conv_apply"]
    b3_launches += fid["fused_sparse_conv_apply_q"]
    q_launches += fid["quantize_activation"]
    map_launches += fid["quantize_map"]
    # and phase 38's classifier CLIs
    b3_launches += cls_clis["launches"]["fused_sparse_conv_apply_q"]
    q_launches += cls_clis["launches"]["quantize_activation"]
    map_launches += cls_clis["launches"]["quantize_map"]
    # and phase 40's bench modes (read around each mode) and phase 41's run
    launches += bench["model"]["upsample_argmax"] + profiles["seg_video"]["b1_launches"]
    for mode in ("fused", "model", "frontend"):
        b2_launches += bench[mode]["fused_sparse_conv_apply"]
        b3_launches += bench[mode]["fused_sparse_conv_apply_q"]
        q_launches += bench[mode]["quantize_activation"]
        map_launches += bench[mode]["quantize_map"]
    for name in B7_ENTRIES:
        s4_launches[name] += bench["fused"][name]
    # and phase 43's serving replicas
    launches += mesh_serving["upsample_argmax"]
    b3_launches += mesh_serving["fused_sparse_conv_apply_q"]
    q_launches += mesh_serving["quantize_activation"]
    # B3's two kernels, counted where each is launched: phase 12's runs, then
    # the runs above
    b3_runs = (stem_full["launches"], budget["launches"], fid, cls_clis["launches"],
               *(bench[mode] for mode in ("fused", "model", "frontend")), mesh_serving)
    b3_narrow = sum(r["sparse_conv_q_narrow_kernel"] for r in b3_runs)
    b3_wide = phase12_b3 + sum(r["sparse_conv_q_kernel"] for r in b3_runs)
    if b3_wide + b3_narrow != b3_launches:
        raise AssertionError(f"B3: {b3_launches} launches by its entry points, {b3_wide} on "
                             f"its 128-wide kernel and {b3_narrow} on the narrow one")
    # the stem route: its three convs on the narrow kernel (as phases 21, 34
    # and 40 check), counted in its own row apart from B3's other narrow convs
    stem_launches = (stem_full["launches"]["b3_stem"] + fid["fused_sparse_conv_q_bias_relu"]
                     + bench["frontend"]["fused_sparse_conv_q_bias_relu"])
    if not 0 < stem_launches <= b3_narrow:
        raise AssertionError(f"the stem route's {stem_launches} launches are not among the "
                             f"narrow kernel's {b3_narrow}")
    stem_conv1 = stem_k["convs"][1]  # the stem route's main shape: the 256->256 conv
    # the quantize_map row: the pass through layer.6.1.conv1's map (384 live)
    qmap_main = next(k for k in map_times if k.startswith(QUANTIZE_MAP_MAIN))

    kernels = [
        entry("upsample_argmax", "tpuseg_torch/csrc/upsample_argmax.cu",
              "tpuseg/ops/upsample.py:91", launches, max_abs_err, kernel_ms, plain_ms,
              b1_bound, None),
        entry("sparse_conv", b2_src, f"{sc_src}:270", b2_launches, b2_err, b2_ms,
              b2_plain_ms, b2_bound, b2_cudnn_ms),
        entry("sparse_conv_q", "tpuseg_torch/csrc/sparse_conv_q.cu", f"{sc_src}:1294",
              b3_wide, b3_err, b3_ms, b3_plain_ms, b3_bound, None),
        entry("quantize", "tpuseg_torch/csrc/quantize.cu", f"{sc_src}:1312-1324",
              q_launches - map_launches, quantize_err, q_ms, q_plain_ms, q_bound, None),
        s4("bsr_matmul_xw", b2_src, f"{sc_src}:84", b4_err),
        s4("bsr_matmul", "tpuseg_torch/csrc/bsr_matmul.cu", "tpuseg/ops/bsr.py:105",
           b56_err["bsr_matmul"]),
        s4("bsr_matmul_gathered", "tpuseg_torch/csrc/bsr_matmul.cu", "tpuseg/ops/bsr.py:187",
           b56_err["bsr_matmul_gathered"]),
    ] + [s4(name, b2_src, f"{sc_src}:{line}", b7_err[name])
         for name, (_, _, line) in B7_ENTRIES.items()] + [
        timed("sparse_conv_q_stem", "tpuseg_torch/csrc/sparse_conv_q_narrow.cu",
              "tpuseg/ops/polyphase.py:349-359", stem_launches, stem_conv1),
        # K3 alone (interval nearest reuse), and the budgeted modes' one
        # launch of K3 with K4's scan in its last block, in K4's row
        timed("frame_deltas", "tpuseg_torch/csrc/temporal.cu", "tpuseg/video/pipeline.py:670-678",
              interval_warp["launches"]["frame_deltas"] + fid["frame_deltas"],
              temporal_k["frame_deltas"]),
        timed("budget_select", "tpuseg_torch/csrc/temporal.cu",
              "tpuseg/video/pipeline.py:680-704",
              budget["launches"]["frame_deltas_budget"]
              + budget_warp["launches"]["frame_deltas_budget"] + fid["frame_deltas_budget"]
              + fid["budget_select"], temporal_k["budget_select"]),
    ] + [timed(name, source, replaces, launched + fid[name], new_k[name])
         for name, launched in (
             ("keyframe_select", sequential["launches"]["keyframe_select"]),
             ("estimate_block_shifts", interval_warp["launches"]["estimate_block_shifts"]
              + budget_warp["launches"]["estimate_block_shifts"]),
             ("warp_ids", interval_warp["launches"]["warp_ids"]
              + budget_warp["launches"]["warp_ids"]),
             ("i420_to_rgb_flat", transport["launches"]["i420_to_rgb_flat"]))
         for _, source, replaces in [FLOW_ENTRIES[name]]] + [
        entry(name, b2_src, f"{sc_src}:270", train_sparse["launches"][name] + fid[name]
              + cls_train["launches"][name] + cls_clis["launches"][name]
              + bench["train"][name] + bench["trainer"][name] + dp["launches"][name],
              t["max_abs_err"], t["ms"], t["plain_ms"], (t["bound_ms"], t["bound_by"]),
              t["library_ms"])
        for name, t in train_k.items()] + [
        timed("sparse_conv_q_narrow", "tpuseg_torch/csrc/sparse_conv_q_narrow.cu",
              f"{sc_src}:1294", b3_narrow - stem_launches, cls_clis["narrow"]),
        entry("quantize_map", "tpuseg_torch/csrc/quantize.cu",
              "tpuseg/models/sparse_exec.py:71", map_launches, quantize_err,
              map_times[qmap_main]["ms"], map_times[qmap_main]["plain_ms"],
              (map_times[qmap_main]["bound_ms"], map_times[qmap_main]["bound_by"]), None)]
    bad = [k["name"] for k in kernels if not k["launches"] > 0]
    if bad:
        raise AssertionError(f"kernels never launched on their path: {bad}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
