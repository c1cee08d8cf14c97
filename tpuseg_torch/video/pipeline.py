"""Video segmentation serving: frames -> device -> fused inference -> ids.

Counterpart of ``tpuseg/video/pipeline.py``: dense, with sparse execution
plans, or int8 (``quantize=True``, optionally calibrated, optionally with
the int8 stem), exact or with batched temporal reuse (interval and budgeted
modes); no sequential adaptive mode, nearest or warped reuse, device resize
or device outputs yet.  Per batch of flat uint8 frames the device runs the
BN-folded polyphase frontend (normalize fused after space-to-depth), the
dilated stages, the 1x1 seg head and the fused x8 upsample+argmax CUDA
kernel; only uint8 frames go up and uint8 class ids come down.  Color and
overlay are rebuilt on the host from the ids (an integer gather,
bit-identical to doing it on the device).

``run`` keeps two batches in flight: each batch's ids are copied to pinned
host memory with ``non_blocking=True`` and a CUDA event marks the copy's
end, so the fetch overlaps the next batch's upload and compute; ``collect``
waits on that event only.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpuseg_torch.data.cityscapes import CITYSCAPE_PALETTE
from tpuseg_torch.device import resolve_device
from tpuseg_torch.metrics.meters import FpsMeter
from tpuseg_torch.models.drn import DrnSpec
from tpuseg_torch.models.drnseg import drnseg_logits
from tpuseg_torch.models.sparse_exec import plans_to, quantize_sparse_plans
from tpuseg_torch.ops.fold_bn import fold_bn
from tpuseg_torch.ops.polyphase import (
    FusedStage3Frontend,
    PolyphaseFrontend,
    calibrate_stem_scales,
)
from tpuseg_torch.ops.quant import build_quant_plans, calibrate_scales
from tpuseg_torch.ops.temporal import budget_select, frame_deltas
from tpuseg_torch.ops.upsample import upsample_argmax


class SyntheticFrames:
    """Deterministic frame generator for tests/benchmarks (no codec dep)."""

    def __init__(self, n: int, size: tuple[int, int], seed: int = 0):
        self.n = n
        self.size = size
        self.seed = seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        h, w = self.size
        for _ in range(self.n):
            yield rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)


def _fused_stage3(spec: DrnSpec) -> bool:
    """True when stage 3 is two basic blocks: the shape
    ``FusedStage3Frontend`` folds (drn_d_22/24)."""
    stage3 = spec.stages[3][1]
    return (stage3.kind == "blocks" and len(stage3.blocks) == 2
            and stage3.blocks[0].kind == "basic")


class VideoSegmenter:
    """Batched end-to-end video segmentation on one device (exact mode).

    ``params``/``bn_state`` are the port's CPU weights (``init_drnseg`` or
    ``from_jax_params``); BN is folded here and the weights move to
    ``device`` in ``compute_dtype`` (conv weights channels_last).  The
    frontend is chosen from the spec: ``FusedStage3Frontend`` for a stage 3
    of two basic blocks, ``PolyphaseFrontend`` otherwise.

    ``exec_plans`` serves a pruned model: a per-conv plan dict from
    ``tpuseg_torch.models.sparse_exec.build_sparse_plans`` (built from the
    same masked weights, BN-folded), moved to ``device`` once here.  Its
    dtype is the plans' own, independent of ``compute_dtype``.

    ``quantize=True`` runs the eligible convs of stages 4-8 in int8
    (``tpuseg_torch.ops.quant.build_quant_plans``, built from the f32 folded
    weights before they are cast), with per-frame activation scales; given
    ``calib_frames`` ((H, W, 3) uint8 frames at the serving size) the scales
    are calibrated (``calibrate_scales``) and static.  The user's
    ``exec_plans`` are lifted to int8 with the same scales
    (``quantize_sparse_plans``) and take precedence per conv, as in
    ``tpuseg``.

    ``quantize_stem=True`` (with or without ``quantize``) runs the three
    folded stem convs in int8 (``PolyphaseFrontend(int8_stem=True)``).
    With ``quantize`` and ``calib_frames`` the order is ``tpuseg``'s: the
    stem's scales first (``calibrate_stem_scales``), then those of stages
    4-8 through the now-int8 stem, then the plans rebuilt with them.

    Temporal reuse, ``tpuseg``'s batched modes without nearest or warped
    reuse:
    - ``temporal_interval=N``: each batch forwards every Nth frame, and each
      frame takes its preceding keyframe's ids;
    - ``temporal_thresh=T`` with ``temporal_budget=K``: per batch the frame
      deltas (kernel K3) and the budgeted keyframe choice (K4) run on the
      device, one K-frame forward serves the chosen frames, and every frame
      takes its keyframe's ids.  The carry (last raw frame, the live
      keyframe's ids, accumulated drift, keyframes so far) stays on the
      device across ``run()`` batches; the first frame ever is promoted.
    ``temporal_thresh`` without a budget (the sequential mode),
    ``temporal_nearest`` and ``temporal_warp`` raise: not ported yet."""

    def __init__(
        self,
        params,
        bn_state,
        spec: DrnSpec,
        mean,
        std,
        *,
        device,
        compute_dtype: torch.dtype = torch.bfloat16,
        batch: int = 8,
        palette: np.ndarray = CITYSCAPE_PALETTE,
        want_overlay: bool = False,
        exec_plans: dict | None = None,
        quantize: bool = False,
        quantize_stem: bool = False,
        calib_frames=None,
        temporal_interval: int = 1,
        temporal_thresh: float | None = None,
        temporal_budget: int | None = None,
        temporal_nearest: bool = False,
        temporal_warp: bool = False,
    ):
        _check_temporal(batch, temporal_interval, temporal_thresh, temporal_budget,
                        temporal_nearest, temporal_warp)
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        if spec.variant != "D":
            raise ValueError(f"{spec.arch}: DRNSeg serving needs a DRN-D backbone")
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.spec = spec
        self.batch = batch
        self.want_overlay = want_overlay
        self.palette_np = np.asarray(palette, np.uint8)
        self.temporal_interval = temporal_interval
        self.temporal_thresh = temporal_thresh
        self.temporal_budget = temporal_budget
        self._carry = None  # budgeted mode: persists across run() batches

        folded = fold_bn(params, bn_state, spec)
        frontend = dict(device=self.device, dtype=compute_dtype, normalize=(mean, std),
                        int8_stem=quantize_stem)
        if _fused_stage3(spec):
            self.stem_fn, self.stem_stages = FusedStage3Frontend(folded, **frontend), 4
        else:
            self.stem_fn, self.stem_stages = PolyphaseFrontend(folded, **frontend), 3
        # the upsample kernel stays on the host: its phase weights are
        # computed there and passed to the kernel by value
        self.up_kernel = folded.pop("up.weight").float().cpu()
        self.params = {}
        for k, v in folded.items():
            v = v.to(device=self.device, dtype=compute_dtype)
            if v.dim() == 4:
                v = v.contiguous(memory_format=torch.channels_last)
            self.params[k] = v
        self.mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self.std = torch.tensor(std, dtype=torch.float32, device=self.device)
        if quantize:
            # int8 plans from the f32 folded weights (``folded`` is still f32
            # on the host: only ``self.params`` were cast)
            exec_plans = self._int8_plans(folded, exec_plans, calib_frames, mean, std,
                                          quantize_stem)
        self.exec_plans = plans_to(exec_plans, self.device)

    def _int8_plans(self, folded, user_plans, calib_frames, mean, std, quantize_stem) -> dict:
        """``tpuseg``'s order: dense int8 plans; with calibration frames,
        the int8 stem's static scales (``quantize_stem``), then static
        scales from a forward on this device (float stages, the stem as
        served), then the plans rebuilt with them; the user's plans lifted
        with the same scales and merged over the dense ones."""
        plans = build_quant_plans(folded, self.spec)
        scales = None
        if calib_frames is not None and len(calib_frames) and plans:
            arr = np.stack([np.asarray(f) for f in calib_frames])
            # the frontend needs H and W divisible by 8 (the serving gate in
            # ids_for); otherwise calibrate on the normalized non-stem path
            use_stem = arr.shape[1] % 8 == 0 and arr.shape[2] % 8 == 0
            if use_stem:
                cal = arr.reshape(arr.shape[0], arr.shape[1], -1)  # raw flat bytes
            else:
                cal = ((arr.astype(np.float32) / 255.0 - np.asarray(mean, np.float32))
                       / np.asarray(std, np.float32))
            batches = [cal[i:i + self.batch] for i in range(0, len(cal), self.batch)]
            if quantize_stem and use_stem:
                calibrate_stem_scales(self.stem_fn, batches)
            scales = calibrate_scales(
                self.params, {}, self.spec, batches, plans=plans,
                compute_dtype=self.compute_dtype,
                stem_fn=self.stem_fn if use_stem else None,
                stem_stages=self.stem_stages if use_stem else 1)
            plans = build_quant_plans(folded, self.spec, x_scales=scales)
        if user_plans:
            plans = {**plans, **quantize_sparse_plans(user_plans, x_scales=scales)}
        return plans

    @torch.inference_mode()
    def ids_for(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """Flat uint8 frames (B, H, W*3) on the device -> uint8 class ids
        (B, H, W): frontend/normalize -> DRNSeg logits -> fused
        upsample+argmax -> crop."""
        b, h, wc = frames_u8.shape
        w = wc // 3
        if h % 8 == 0 and w % 8 == 0:
            # the frontend normalizes after its space-to-depth; feed raw bytes
            x, stem_fn, stem_stages = frames_u8, self.stem_fn, self.stem_stages
        else:
            x = frames_u8.reshape(b, h, w, 3).float() / 255.0
            x = (x - self.mean) / self.std
            stem_fn, stem_stages = None, 1
        seg = drnseg_logits(
            self.params, {}, x, self.spec, compute_dtype=self.compute_dtype,
            stem_fn=stem_fn, stem_stages=stem_stages, sparse_plans=self.exec_plans,
        )
        ids = upsample_argmax(seg, self.up_kernel)
        # inputs not divisible by 8 round the feature grid up, so the
        # upsampled map can overshoot the frame by a few pixels — crop
        return ids[:, :h, :w]

    @torch.inference_mode()
    def _forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """One batch in exact or interval mode -> (B, H, W) ids: with
        ``temporal_interval`` N only every Nth frame is forwarded and each
        frame takes its preceding keyframe's ids (``tpuseg`` pipeline.py:
        521-535, 572-576)."""
        n = self.temporal_interval
        if n == 1:
            return self.ids_for(frames_u8)
        ids = self.ids_for(frames_u8[::n])
        return ids.repeat_interleave(n, dim=0)[:frames_u8.shape[0]]

    def _make_carry(self, h: int, w: int) -> tuple:
        """Fresh budgeted-mode carry for (h, w) frames, on the device: the
        previous raw frame (flat), the live keyframe's ids, the accumulated
        drift and the keyframe count; 0 keyframes forces the first frame
        ever to promote (``tpuseg`` pipeline.py:840-861)."""
        dev = self.device
        return (torch.zeros((h, w * 3), dtype=torch.uint8, device=dev),
                torch.zeros((h, w), dtype=torch.uint8, device=dev),
                torch.zeros((1,), dtype=torch.float32, device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev))

    @torch.inference_mode()
    def _budget_step(self, frames_u8: torch.Tensor, carry: tuple):
        """One batch of budgeted temporal serving (``tpuseg``'s
        ``program_budget``, pipeline.py:642-778, without nearest and warp)
        -> (ids (B, H, W), flags (B,) bool, the new carry).  Frame deltas
        (K3), the keyframe choice (K4), one K-frame forward of the chosen
        frames (unfilled slots forward frame 0), and each frame's ids from
        its keyframe's slot, or the carried ids before the batch's first
        keyframe.  Nothing leaves the device."""
        prev, key_ids, acc0, n_keyed = carry
        k = self.temporal_budget
        d = frame_deltas(frames_u8, prev)
        flags, fwd_idx, keyslot, acc0, n_keyed = budget_select(
            d, acc0, n_keyed, self.temporal_thresh, k)
        ids_k = self.ids_for(frames_u8.index_select(0, fwd_idx))
        ids = torch.where((keyslot >= 0).view(-1, 1, 1),
                          ids_k.index_select(0, keyslot.clamp(0, k - 1)), key_ids)
        return ids, flags, (frames_u8[-1].clone(), ids[-1].clone(), acc0, n_keyed)

    def run(
        self,
        frames,
        *,
        max_frames: int | None = None,
        need_color: bool = True,
    ) -> dict:
        """Stream (H, W, 3) uint8 frames through the device, ``batch`` at a
        time (the last batch padded with repeats of its last frame), two
        batches in flight.

        Returns a dict with ``ids`` (N, H, W) uint8, ``color`` (palette or
        overlay, when ``need_color``), ``frames``, ``seconds`` and ``fps``
        (wall clock from the first submit to the last collect; the first
        batch also runs once untimed, so first-call costs stay out) and
        ``batch_times`` (overlapping under pipelining, diagnostic only); in
        budgeted mode also ``promoted`` and ``promotion_rate``, over the
        returned frames only.  The untimed first call leaves the budgeted
        carry as it found it."""
        cuda = self.device.type == "cuda"
        adaptive = self.temporal_budget is not None
        promoted_flags = []
        ids_out, color_out = [], []
        batch_times = []
        fps_meter = FpsMeter()
        n_done = 0
        pending = []
        first = True
        t_wall0 = None

        def call_program(x):
            if not adaptive:
                return self._forward(x), None
            if self._carry is None:
                self._carry = self._make_carry(x.shape[1], x.shape[2] // 3)
            ids, flags, self._carry = self._budget_step(x, self._carry)
            return ids, flags

        def submit(buf):
            nonlocal first, t_wall0
            arr = np.stack(buf)
            pad = 0
            if arr.shape[0] < self.batch:
                pad = self.batch - arr.shape[0]
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
            # flat (B, H, W*3): the same bytes as (B, H, W, 3), a numpy view
            x = torch.from_numpy(arr.reshape(arr.shape[0], arr.shape[1], -1))
            if cuda:
                x = x.pin_memory().to(self.device, non_blocking=True)
            if first:
                # first-call costs (kernel build, cuDNN plans) stay untimed;
                # the warmup would advance the budgeted carry: restore it
                carry0 = self._carry
                call_program(x)
                if cuda:
                    torch.cuda.synchronize(self.device)
                self._carry = carry0
                first = False
            t0 = time.perf_counter()
            if t_wall0 is None:
                t_wall0 = t0
            ids, flags = call_program(x)
            done = None
            if cuda:
                # start the device->host copies now so they overlap the next
                # batch; collect() waits on the event, not the device
                host = torch.empty(ids.shape, dtype=torch.uint8, pin_memory=True)
                host.copy_(ids, non_blocking=True)
                if flags is not None:
                    flags_host = torch.empty(flags.shape, dtype=torch.bool, pin_memory=True)
                    flags = flags_host.copy_(flags, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                ids = host
            return ids, done, arr.shape[0] - pad, t0, arr, flags

        def collect(flight):
            ids, done, n, t0, frames_host, flags = flight
            if done is not None:
                done.synchronize()
            ids = ids.numpy()
            if flags is not None:
                promoted_flags.append(flags.numpy()[:n])
            color = None
            if need_color:
                # host reconstruction from ids: palette gather / overlay blend
                color = self.palette_np[ids]
                if self.want_overlay:
                    color = (frames_host // 2 + color // 2).astype(np.uint8)
            dt = time.perf_counter() - t0
            batch_times.append((dt, n))
            ids_out.append(ids[:n])
            if color is not None:
                color_out.append(color[:n])
            fps_meter.tick()
            return n

        DEPTH = 2  # batches in flight; depth 2 overlaps D2H with compute
        flights = []

        def n_flight():
            return sum(f[2] for f in flights)

        for frame in frames:
            pending.append(frame)
            if len(pending) == self.batch:
                flights.append(submit(pending))
                pending = []
                if len(flights) > DEPTH:
                    n_done += collect(flights.pop(0))
            if max_frames is not None and n_done + n_flight() >= max_frames:
                break
        if pending and (max_frames is None or n_done + n_flight() < max_frames):
            flights.append(submit(pending))
        while flights:
            n_done += collect(flights.pop(0))

        total_t = (time.perf_counter() - t_wall0) if t_wall0 is not None else 0.0
        total_n = sum(n for _, n in batch_times)
        ids_all = np.concatenate(ids_out) if ids_out else np.zeros((0,), np.uint8)
        color_all = np.concatenate(color_out) if color_out else np.zeros((0,), np.uint8)
        if max_frames is not None and len(ids_all) > max_frames:
            # the last flush can overshoot the request; return exactly
            # max_frames
            ids_all = ids_all[:max_frames]
            color_all = color_all[:max_frames]
            total_n = max_frames
        out = {
            "ids": ids_all,
            "color": color_all,
            "frames": total_n,
            "seconds": total_t,
            "fps": total_n / total_t if total_t > 0 else 0.0,
            "batch_times": batch_times,
        }
        if adaptive:
            # promotions over exactly the returned frames (tpuseg
            # pipeline.py:1063-1073): flights past a max_frames cut do not
            # count
            flags = (np.concatenate(promoted_flags)[:total_n] if promoted_flags
                     else np.zeros((0,), bool))
            out["promoted"] = int(flags.sum())
            out["promotion_rate"] = out["promoted"] / total_n if total_n else 0.0
        return out

    def benchmark_device_fps(
        self, size: tuple[int, int], inner: int = 32, reps: int = 3
    ) -> float:
        """Device throughput (frames/sec) at (H, W): ``inner`` batches back
        to back, timed with CUDA events, best of ``reps``.  Each batch's
        input carries one byte of the previous batch's ids, so every
        iteration depends on the one before (bench.py's methodology); in
        interval mode each batch forwards its keyframes.  Raises on a CPU
        segmenter (a device rate comes only from the card) and in budgeted
        mode, whose rate depends on the content
        (``benchmark_adaptive_device_fps``)."""
        if self.device.type != "cuda":
            raise RuntimeError(
                "benchmark_device_fps times a CUDA device; this segmenter "
                f"runs on {self.device}")
        if self.temporal_budget is not None:
            raise ValueError("the budgeted mode's device rate depends on the content; use "
                             "benchmark_adaptive_device_fps with real frames")
        h, w = size
        with torch.inference_mode():
            frames = torch.zeros((self.batch, h, w * 3), dtype=torch.uint8,
                                 device=self.device)

            def loop():
                for _ in range(inner):
                    ids = self._forward(frames)
                    frames.view(-1)[:1].copy_(ids[0, 0, :1])

            loop()  # warm (kernel build, cuDNN plans)
            torch.cuda.synchronize(self.device)
            best = float("inf")
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loop()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1000.0 / inner)
        return self.batch / best

    def benchmark_adaptive_device_fps(self, frames, reps: int = 3) -> dict:
        """Device rate of budgeted temporal serving on real frames (its rate
        depends on the content), ``tpuseg``'s method (pipeline.py:
        1120-1187): full batches only (the remainder is dropped, never
        padded), all on the device, chained through the carry from a fresh
        one with no host sync, timed with CUDA events, best of ``reps``.
        Returns ``device_fps``, ``promotion_rate`` (of these frames),
        ``frames`` and ``frames_dropped``.  Raises on a CPU segmenter and
        outside the budgeted mode."""
        if self.device.type != "cuda":
            raise RuntimeError(
                "benchmark_adaptive_device_fps times a CUDA device; this segmenter "
                f"runs on {self.device}")
        if self.temporal_budget is None:
            raise ValueError("benchmark_adaptive_device_fps times the budgeted temporal mode")
        arr = np.stack([np.asarray(f) for f in frames])
        b = self.batch
        if len(arr) < b:
            raise ValueError(f"need at least one full batch ({b}) of frames, got {len(arr)}")
        dropped = len(arr) % b
        arr = arr[:len(arr) - dropped]
        h, w = arr.shape[1], arr.shape[2]
        with torch.inference_mode():
            xs = torch.from_numpy(arr.reshape(len(arr) // b, b, h, -1)).to(self.device)
            carry0 = self._make_carry(h, w)

            def loop():
                carry, promoted = carry0, []
                for fb in xs:
                    _, flags, carry = self._budget_step(fb, carry)
                    promoted.append(flags)
                return promoted

            n_promoted = int(torch.cat(loop()).sum())  # warm (kernel build, cuDNN plans)
            best = float("inf")
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loop()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1000.0)
        n = len(arr)
        return {"device_fps": n / best, "promotion_rate": n_promoted / n, "frames": n,
                "frames_dropped": dropped}


def _check_temporal(batch, interval, thresh, budget, nearest, warp) -> None:
    """``tpuseg``'s argument checks of the temporal modes (pipeline.py:
    404-432, 825-835) as ``ValueError``s, and the modes not ported yet."""
    if interval < 1:
        raise ValueError(f"temporal_interval must be >= 1, got {interval}")
    if interval > 1 and thresh is not None:
        raise ValueError("temporal_interval and temporal_thresh are mutually exclusive")
    if budget is not None and thresh is None:
        raise ValueError("temporal_budget requires temporal_thresh")
    if nearest:
        raise ValueError("temporal_nearest is not ported yet (ROADMAP A19)")
    if warp:
        raise ValueError("temporal_warp is not ported yet (ROADMAP A19)")
    if thresh is not None and budget is None:
        raise ValueError("temporal_thresh without temporal_budget (the sequential adaptive "
                         "mode) is not ported yet (ROADMAP A19)")
    if budget is not None and not 0 < budget <= batch:
        raise ValueError(f"temporal_budget {budget} must be in 1..batch ({batch})")
