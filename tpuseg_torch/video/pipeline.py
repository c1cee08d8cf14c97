"""Video segmentation serving: frames -> device -> fused inference -> ids.

Counterpart of ``tpuseg/video/pipeline.py`` in exact mode: dense, with
sparse execution plans, or int8 (``quantize=True``, optionally calibrated);
no temporal reuse, int8 stem, device resize or device outputs yet.  Per
batch of flat uint8 frames the device runs the BN-folded polyphase frontend
(normalize fused after space-to-depth), the dilated stages, the 1x1 seg
head and the fused x8 upsample+argmax CUDA kernel; only uint8 frames go up
and uint8 class ids come down.  Color and overlay are rebuilt on the host
from the ids (an integer gather, bit-identical to doing it on the device).

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
from tpuseg_torch.ops.polyphase import FusedStage3Frontend, PolyphaseFrontend
from tpuseg_torch.ops.quant import build_quant_plans, calibrate_scales
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
    ``tpuseg``."""

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
        calib_frames=None,
    ):
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

        folded = fold_bn(params, bn_state, spec)
        frontend = dict(device=self.device, dtype=compute_dtype, normalize=(mean, std))
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
            exec_plans = self._int8_plans(folded, exec_plans, calib_frames, mean, std)
        self.exec_plans = plans_to(exec_plans, self.device)

    def _int8_plans(self, folded, user_plans, calib_frames, mean, std) -> dict:
        """``tpuseg``'s order: dense int8 plans; with calibration frames,
        static scales from a float forward on this device, then the plans
        rebuilt with them; the user's plans lifted with the same scales and
        merged over the dense ones."""
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
        ``batch_times`` (overlapping under pipelining, diagnostic only)."""
        cuda = self.device.type == "cuda"
        ids_out, color_out = [], []
        batch_times = []
        fps_meter = FpsMeter()
        n_done = 0
        pending = []
        first = True
        t_wall0 = None

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
                # first-call costs (kernel build, cuDNN plans) stay untimed
                self.ids_for(x)
                if cuda:
                    torch.cuda.synchronize(self.device)
                first = False
            t0 = time.perf_counter()
            if t_wall0 is None:
                t_wall0 = t0
            ids = self.ids_for(x)
            done = None
            if cuda:
                # start the device->host copy now so it overlaps the next
                # batch; collect() waits on the event, not the device
                host = torch.empty(ids.shape, dtype=torch.uint8, pin_memory=True)
                host.copy_(ids, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                ids = host
            return ids, done, arr.shape[0] - pad, t0, arr

        def collect(flight):
            ids, done, n, t0, frames_host = flight
            if done is not None:
                done.synchronize()
            ids = ids.numpy()
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
        return {
            "ids": ids_all,
            "color": color_all,
            "frames": total_n,
            "seconds": total_t,
            "fps": total_n / total_t if total_t > 0 else 0.0,
            "batch_times": batch_times,
        }

    def benchmark_device_fps(
        self, size: tuple[int, int], inner: int = 32, reps: int = 3
    ) -> float:
        """Device throughput (frames/sec) at (H, W): ``inner`` batches back
        to back, timed with CUDA events, best of ``reps``.  Each batch's
        input carries one byte of the previous batch's ids, so every
        iteration depends on the one before (bench.py's methodology).
        Raises on a CPU segmenter: a device rate comes only from the card."""
        if self.device.type != "cuda":
            raise RuntimeError(
                "benchmark_device_fps times a CUDA device; this segmenter "
                f"runs on {self.device}")
        h, w = size
        with torch.inference_mode():
            frames = torch.zeros((self.batch, h, w * 3), dtype=torch.uint8,
                                 device=self.device)

            def loop():
                for _ in range(inner):
                    ids = self.ids_for(frames)
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
