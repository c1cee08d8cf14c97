"""Video segmentation serving: frames -> device -> fused inference -> ids.

Counterpart of ``tpuseg/video/pipeline.py``: dense, with sparse execution
plans, or int8 (``quantize=True``, optionally calibrated, optionally with
the int8 stem); exact or with temporal reuse (interval, budgeted and
sequential adaptive modes, nearest and warped reuse); RGB or I420 frames,
resized on the device or not; ids packed or not, or color and overlay made
on the device.  Per batch of flat uint8 frames the device runs the BN-folded
polyphase frontend (normalize fused after space-to-depth), the dilated
stages, the 1x1 seg head and the fused x8 upsample+argmax CUDA kernel; only
uint8 frames go up and uint8 class ids (or images) come down.  By default
color and overlay are rebuilt on the host from the ids (an integer gather,
bit-identical to doing it on the device).

``FrameSource`` decodes video files (the native decoder, cv2 or imageio),
as RGB or as I420 planes for the yuv420 transport.

``run`` keeps two batches in flight: each batch's ids are copied to pinned
host memory with ``non_blocking=True`` and a CUDA event marks the copy's
end, so the fetch overlaps the next batch's upload and compute; ``collect``
waits on that event only.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch
import torch.nn.functional as F

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
from tpuseg_torch.ops.idpack import pack_ids, unpack_ids
from tpuseg_torch.ops.temporal import frame_deltas, frame_deltas_budget, keyframe_select
from tpuseg_torch.ops.upsample import upsample_argmax
from tpuseg_torch.video.flow import estimate_block_shifts, pooled_luma, warp_ids
from tpuseg_torch.video.yuv import i420_geometry, i420_to_rgb_flat, rgb_to_i420


class FrameSource:
    """Decode the frames of a video file, resized to ``size`` (height,
    width) when given, as (H, W, 3) uint8 RGB or, with ``fmt="i420"``, as
    packed (H*3/2, W) I420 planes for ``VideoSegmenter``'s yuv420 transport
    (``tpuseg``'s ``FrameSource``; reference: the FrameCapture decode loop,
    seg_video.py:113-139).

    The decoders are tried in ``tpuseg``'s order: the native threaded
    decoder (``video/native_source.py``, which emits I420 itself), then cv2,
    then imageio with PIL's bilinear resize; the last two make I420 on the
    host (``video/yuv.py::rgb_to_i420``, after cropping to the packing
    grid).  Each pass over the source decodes the file from its start;
    ``decoder`` names the decoder of the latest pass (``"native"``,
    ``"cv2"`` or ``"imageio"``; None before the first)."""

    def __init__(self, path: str, size: tuple[int, int] | None = None,
                 native: bool = True, fmt: str = "rgb"):
        if fmt not in ("rgb", "i420"):
            raise ValueError(f"fmt must be 'rgb' or 'i420', got {fmt!r}")
        self.path = path
        self.size = size  # (height, width)
        self.native = native
        self.fmt = fmt
        self.decoder = None

    def __iter__(self):
        if self.native:
            from tpuseg_torch.video.native_source import NativeFrameSource, available

            if available():
                try:
                    source = NativeFrameSource(self.path, self.size, fmt=self.fmt)
                except (RuntimeError, FileNotFoundError):
                    source = None  # cv2 below, as in tpuseg
                if source is not None:
                    self.decoder = "native"
                    try:
                        yield from source
                    finally:
                        source.close()
                    return
        if self.fmt == "i420":
            rgb = FrameSource(self.path, self.size, native=False)
            for frame in rgb:
                self.decoder = rgb.decoder
                h, w = frame.shape[:2]
                frame = frame[: h // 4 * 4, : w // 2 * 2]  # the packing grid
                yield rgb_to_i420(frame)[0]
            return
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            self.decoder = "cv2"
            cap = cv2.VideoCapture(self.path)
            try:
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                    if self.size is not None:
                        h, w = self.size
                        frame = cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)
                    yield frame
            finally:
                cap.release()
            return
        import imageio.v3 as iio
        from PIL import Image

        self.decoder = "imageio"
        for frame in iio.imiter(self.path):
            if self.size is not None:
                h, w = self.size
                frame = np.asarray(Image.fromarray(frame).resize((w, h), Image.BILINEAR))
            yield np.asarray(frame, dtype=np.uint8)


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


def _plan_replicable(plan) -> bool:
    """True for the per-conv plans ``tpuseg`` lets a serving mesh partition
    (they lower to plain XLA there: gathered and grouped convs, RBGP, int8
    ``QuantConv``).  Its Pallas-backed plans (``FusedSparseConv(Q)``,
    ``CompactSparse(Q)``) stay single-device, and so do the port's."""
    from tpuseg_torch.ops.gathered_conv import GatheredGroupConv, GatheredGroupConvQ
    from tpuseg_torch.ops.quant import QuantConv
    from tpuseg_torch.ops.rbgp_matmul import RbgpPlan

    return isinstance(plan, (GatheredGroupConv, GatheredGroupConvQ, QuantConv, RbgpPlan))


class VideoSegmenter:
    """Batched end-to-end video segmentation on one device, or on the data
    axis of a mesh (``mesh=``).

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
    ``calib_frames`` ((H, W, 3) uint8 frames) the scales are calibrated
    (``calibrate_scales``, on the frames as the device resizes them) and
    static.  The user's ``exec_plans`` are lifted to int8 with the same
    scales (``quantize_sparse_plans``) and take precedence per conv, as in
    ``tpuseg``.

    ``quantize_stem=True`` (with or without ``quantize``) runs the three
    folded stem convs in int8 (``PolyphaseFrontend(int8_stem=True)``).
    With ``quantize`` and ``calib_frames`` the order is ``tpuseg``'s: the
    stem's scales first (``calibrate_stem_scales``), then those of stages
    4-8 through the now-int8 stem, then the plans rebuilt with them.

    Transport, on the device, in ``tpuseg``'s order:
    - ``transport="yuv420"`` ships planar I420 (1.5 bytes a pixel; run()
      converts RGB frames on the host, ``video/yuv.py``) and kernel K8 turns
      it back into RGB before anything else;
    - ``target_size=(H, W)`` resizes frames of another size on the device
      (bilinear, half-pixel centres, no antialias, rounded half to even,
      clipped to uint8: ``resize_frames``), so frames ship at decode size;
      the interval and budgeted modes resize only the forwarded frames;
    - ``ids_bits=B`` packs the fetched ids to B bits a pixel on the device
      (``ops/idpack.py``; exact, run() unpacks them);
    - ``device_outputs=True`` gathers the palette and blends the overlay
      (``frames // 2 + color // 2``) on the device and fetches them with the
      ids; by default only ids come down and run() rebuilds color and overlay
      on the host (the same integer gather and blend).

    Temporal reuse, ``tpuseg``'s modes:
    - ``temporal_interval=N``: each batch forwards every Nth frame, and each
      frame takes its preceding keyframe's ids;
    - ``temporal_thresh=T`` with ``temporal_budget=K``: per batch the frame
      deltas (kernel K3) and the budgeted keyframe choice (K4) run on the
      device, one K-frame forward serves the chosen frames, and every frame
      takes its keyframe's ids.  The carry (last raw frame, the live
      keyframe's ids, accumulated drift, keyframes so far) stays on the
      device across ``run()`` batches; the first frame ever is promoted;
    - ``temporal_thresh=T`` alone, the sequential mode: a frame is promoted
      when its mean |delta| against the live keyframe exceeds T (kernel K5).
      The choice depends on pixels only, never on a forward, so K5 picks the
      whole batch's keyframes first, one count comes back to the host (the
      mode's one sync a batch) and one batched forward serves exactly the
      promoted frames.  A frame's ids do not depend on its batchmates (int8
      scales are per frame), so they are the ids ``tpuseg``'s batch-1
      forward under ``lax.cond`` gives, up to the summation order a
      convolution picks for a batch size;
    - ``temporal_nearest`` (interval and budgeted modes): a frame takes the
      ids of the keyframe behind or ahead of it in the batch with the smaller
      accumulated |delta| path (ties stay causal);
    - ``temporal_warp`` (interval and budgeted modes): the reused ids are
      moved along per-block shifts estimated on pooled luma (``video/flow.py``,
      kernels K6 and K7); the target H and W must divide by 128.

    ``mesh`` (``tpuseg_torch.parallel.make_mesh(data=N, devices=[...])``,
    no process group) serves data-parallel over its devices, ``tpuseg``'s
    serving mesh: the weights and plans are copied to each device (one copy
    per distinct device), every forward's frames are split over the
    replicas in order, each replica runs the same program on its own device
    (kernels B1 and, for int8 plans, B3 launch once per replica) and the ids
    are gathered on the first device, where the rest of the batch (reuse,
    outputs) runs.  ``tpuseg``'s guards hold: the batch must divide by the
    mesh's size, the adaptive temporal modes are refused (they are
    sequential), and so are plans its partitioner cannot split
    (``FusedSparseConv(Q)``, ``CompactSparse(Q)``)."""

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
        device_outputs: bool = False,
        target_size: tuple[int, int] | None = None,
        exec_plans: dict | None = None,
        quantize: bool = False,
        quantize_stem: bool = False,
        calib_frames=None,
        temporal_interval: int = 1,
        temporal_thresh: float | None = None,
        temporal_budget: int | None = None,
        temporal_nearest: bool = False,
        temporal_warp: bool = False,
        transport: str = "rgb",
        ids_bits: int | None = None,
        mesh=None,
    ):
        _check_temporal(batch, temporal_interval, temporal_thresh, temporal_budget,
                        temporal_nearest, temporal_warp)
        if mesh is not None:
            if mesh.rank is not None:
                raise ValueError("a serving mesh is driven by one process (no process group)")
            if temporal_thresh is not None:
                raise ValueError("adaptive temporal reuse is sequential frame-to-frame; "
                                 "use interval mode or a single device")
            if batch % mesh.size:
                raise ValueError(f"batch {batch} must divide over the {mesh.size}-device mesh")
            device = mesh.devices.flat[0]
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        if spec.variant != "D":
            raise ValueError(f"{spec.arch}: DRNSeg serving needs a DRN-D backbone")
        if transport not in ("rgb", "yuv420"):
            raise ValueError(f"transport must be 'rgb' or 'yuv420', got {transport!r}")
        if ids_bits is not None and not 1 <= ids_bits <= 8:
            raise ValueError(f"ids_bits must be in 1..8, got {ids_bits}")
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.spec = spec
        self.batch = batch
        self.want_overlay = want_overlay
        self.device_outputs = device_outputs
        self.target_size = tuple(target_size) if target_size is not None else None
        self.transport = transport
        self.palette_np = np.asarray(palette, np.uint8)
        self.temporal_interval = temporal_interval
        self.temporal_thresh = temporal_thresh
        self.temporal_budget = temporal_budget
        self.temporal_nearest = temporal_nearest
        self.temporal_warp = temporal_warp
        self._carry = None  # adaptive modes: persists across run() batches
        self._nearest_maps = {}  # interval nearest: (frames, keys) -> index tensors

        folded = fold_bn(params, bn_state, spec)
        n_cls = folded["seg.weight"].shape[0]
        if ids_bits is not None and n_cls > 1 << ids_bits:
            raise ValueError(f"ids_bits={ids_bits} cannot hold {n_cls} classes")
        self.ids_bits = ids_bits if ids_bits is not None and ids_bits < 8 else None
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
        self.palette_dev = torch.from_numpy(self.palette_np).to(self.device)
        if quantize:
            # int8 plans from the f32 folded weights (``folded`` is still f32
            # on the host: only ``self.params`` were cast)
            exec_plans = self._int8_plans(folded, exec_plans, calib_frames, mean, std,
                                          quantize_stem)
        self.exec_plans = plans_to(exec_plans, self.device)
        self._replicas = None
        if mesh is not None:
            unsafe = sorted(k for k, p in (self.exec_plans or {}).items()
                            if not _plan_replicable(p))
            if unsafe:
                raise ValueError(
                    "Pallas-backed exec plans are opaque to the GSPMD partitioner: "
                    f"{unsafe}; use the gathered lowering (--sparse-lowering gathered, the "
                    "CLI default) or serve single-device")
            # one replica per device of the data axis, one copy per distinct
            # device (this segmenter serves its own device)
            copies = {self.device: self}
            for d in mesh.devices.flat:
                d = resolve_device(d)
                if d not in copies:
                    copies[d] = self._replica_on(d)
            self._replicas = [copies[resolve_device(d)] for d in mesh.devices.flat]

    def _replica_on(self, device: torch.device) -> "VideoSegmenter":
        """A serving replica on ``device``: this segmenter's folded weights,
        frontend and plans copied there (folded, planned and calibrated
        once, here), for ``_replica_ids``."""
        rep = copy.copy(self)
        rep.device = device
        rep.params = {k: v.to(device) for k, v in self.params.items()}
        rep.mean, rep.std = self.mean.to(device), self.std.to(device)
        rep.stem_fn = self.stem_fn.to(device)
        rep.exec_plans = plans_to(self.exec_plans, device)
        return rep

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
            if (arr.ndim == 4 and self.target_size is not None
                    and arr.shape[1:3] != self.target_size):
                # device-resize serving: calibrate on the resize the served
                # batches get, on the same device
                th, tw = self.target_size
                x = torch.from_numpy(arr.reshape(arr.shape[0], arr.shape[1], -1)).to(self.device)
                arr = resize_frames(x, self.target_size).cpu().numpy().reshape(-1, th, tw, 3)
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
        upsample+argmax -> crop.  Over a mesh the frames are split over the
        replicas in order (each runs this on its own device) and the ids
        gathered here."""
        if self._replicas is None:
            return self._replica_ids(frames_u8)
        parts = frames_u8.tensor_split(len(self._replicas))
        ids = [rep._replica_ids(x.to(rep.device, non_blocking=True))
               for rep, x in zip(self._replicas, parts) if x.shape[0]]
        return torch.cat([i.to(self.device, non_blocking=True) for i in ids])

    def _replica_ids(self, frames_u8: torch.Tensor) -> torch.Tensor:
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

    def _ingest(self, x: torch.Tensor) -> torch.Tensor:
        """Shipped frames -> flat (B, h, w*3) uint8 RGB at decode size."""
        return i420_to_rgb_flat(x) if self.transport == "yuv420" else x

    def _resize(self, frames: torch.Tensor) -> torch.Tensor:
        return resize_frames(frames, self.target_size) if self.target_size else frames

    def _outputs(self, ids: torch.Tensor, frames: torch.Tensor | None):
        """-> (what run() fetches as ids, the device image or None):
        packed ids (``ids_bits``), or with ``device_outputs`` the ids and
        the palette gather or overlay blend of the (resized) frames."""
        if not self.device_outputs:
            return (pack_ids(ids, self.ids_bits) if self.ids_bits else ids), None
        b, h, w = ids.shape
        color = self.palette_dev.index_select(0, ids.reshape(-1).to(torch.int32))
        color = color.reshape(b, h, w, 3)
        if self.want_overlay:
            return ids, frames.reshape(b, h, w, 3) // 2 + color // 2
        return ids, color

    def _interval_key_of(self, raw: torch.Tensor, n_keys: int) -> torch.Tensor:
        """Interval mode with ``temporal_nearest``: K3 with ``prev = raw[0]``
        gives d[0] = 0 and d[i] = delta(i, i-1), and ``interval_nearest_keys``
        maps it to each frame's keyframe (its index maps cached on the
        device per batch shape)."""
        key = (raw.shape[0], n_keys)
        if key not in self._nearest_maps:
            self._nearest_maps[key] = _interval_maps(*key, self.temporal_interval, self.device)
        d = frame_deltas(raw, raw[0])
        return interval_nearest_keys(d, self.temporal_interval, n_keys, self._nearest_maps[key])

    def _warp(self, ids, key_luma, luma):
        dy, dx = estimate_block_shifts(key_luma.contiguous(), luma)
        return warp_ids(ids.contiguous(), dy, dx, scale=8, block=16)

    @torch.inference_mode()
    def _program(self, x: torch.Tensor):
        """One batch in exact or interval mode (``tpuseg``'s ``program``,
        pipeline.py:515-604) -> ``_outputs``: with ``temporal_interval`` N
        only every Nth frame is resized and forwarded, and each frame takes
        its keyframe's ids (the preceding one, or with ``temporal_nearest``
        the nearer one by drift), warped with ``temporal_warp``."""
        frames = self._ingest(x)
        raw, n = frames, self.temporal_interval
        if n > 1 and not self.device_outputs:
            fwd = self._resize(frames[::n])
        else:
            frames = self._resize(frames)
            fwd = frames[::n] if n > 1 else frames
        ids = self.ids_for(fwd)
        if n > 1:
            nb = raw.shape[0]
            key_of = self._interval_key_of(raw, ids.shape[0]) if self.temporal_nearest else None
            if key_of is not None:
                ids = ids.index_select(0, key_of)
            else:
                ids = ids.repeat_interleave(n, dim=0)[:nb]
            if self.temporal_warp:
                h, w = ids.shape[1], ids.shape[2]
                cs = pooled_luma(raw, grid=(h // 8, w // 8))
                ks = (cs[::n].index_select(0, key_of) if key_of is not None
                      else cs[::n].repeat_interleave(n, dim=0)[:nb])
                ids = self._warp(ids, ks, cs)
        return self._outputs(ids, frames)

    def _make_carry(self, h: int, w: int) -> tuple:
        """Fresh adaptive-mode carry for frames of decode size (h, w), on
        the device; 0 keyframes forces the first frame ever to promote
        (``tpuseg`` pipeline.py:840-861).  Budgeted: the previous raw frame
        (flat, decode size), the live keyframe's ids (target size), the
        accumulated drift, the keyframe count, and with ``temporal_warp``
        the live keyframe's pooled luma (target /8 grid).  Sequential: the
        live keyframe's pixels and ids (target size) and the count."""
        th, tw = self.target_size or (h, w)
        dev = self.device
        ids = torch.zeros((th, tw), dtype=torch.uint8, device=dev)
        n = torch.zeros((1,), dtype=torch.int32, device=dev)
        if self.temporal_budget is None:
            return torch.zeros((th, tw * 3), dtype=torch.uint8, device=dev), ids, n
        carry = (torch.zeros((h, w * 3), dtype=torch.uint8, device=dev), ids,
                 torch.zeros((1,), dtype=torch.float32, device=dev), n)
        if self.temporal_warp:
            carry += (torch.zeros((th // 8, tw // 8), dtype=torch.float32, device=dev),)
        return carry

    def _decode_hw(self, x) -> tuple[int, int]:
        """(h, w) of the decoded frames of a shipped batch (flat RGB or I420)."""
        if self.transport == "yuv420":
            return i420_geometry(x.shape[1]), x.shape[2]
        return x.shape[1], x.shape[2] // 3

    @torch.inference_mode()
    def _budget_step(self, x: torch.Tensor, carry: tuple):
        """One batch of budgeted temporal serving (``tpuseg``'s
        ``program_budget``, pipeline.py:642-778) -> (ids, image, flags (B,)
        bool, the new carry).  Frame deltas (K3) and the keyframe choice (K4)
        at decode size in one launch, one K-frame forward of the chosen
        frames, resized (unfilled slots forward frame 0), each frame's ids
        from its keyframe's slot (with ``temporal_nearest`` the nearer
        promotion by drift, behind or ahead) or the carried ids before the
        batch's first keyframe, then warped with ``temporal_warp``.  The
        carry keeps the unwarped ids.  Nothing leaves the device."""
        frames = self._ingest(x)
        prev, key_ids, acc0, n_keyed = carry[:4]
        k = self.temporal_budget
        d, flags, fwd_idx, keyslot, acc_new, n_new = frame_deltas_budget(
            frames, prev, acc0, n_keyed, self.temporal_thresh, k)
        ids_k = self.ids_for(self._resize(frames.index_select(0, fwd_idx)))
        slot = (budget_nearest_slots(d, fwd_idx, keyslot, acc0, k) if self.temporal_nearest
                else keyslot)
        keyed = (slot >= 0).view(-1, 1, 1)
        slot_c = slot.clamp(0, k - 1)
        ids = torch.where(keyed, ids_k.index_select(0, slot_c), key_ids)
        new = [frames[-1].clone(), ids[-1].clone(), acc_new, n_new]
        if self.temporal_warp:
            h, w = ids.shape[1], ids.shape[2]
            small = pooled_luma(frames, grid=(h // 8, w // 8))
            key_small = torch.where(keyed, small.index_select(0, fwd_idx).index_select(0, slot_c),
                                    carry[4])
            ids = self._warp(ids, key_small, small)
            new.append(key_small[-1].clone())
        frames_t = self._resize(frames) if self.device_outputs else None
        return (*self._outputs(ids, frames_t), flags, tuple(new))

    @torch.inference_mode()
    def _sequential_step(self, x: torch.Tensor, carry: tuple):
        """One batch of the sequential adaptive mode (``tpuseg``'s
        ``program_adaptive``, pipeline.py:606-640) -> (ids, image, flags (B,)
        bool, the new carry): K5 picks every keyframe of the batch against
        the carried one, the promoted count comes to the host (one sync),
        one forward serves exactly the promoted frames, and each frame takes
        its keyframe's ids (the carried ids before the first)."""
        frames = self._resize(self._ingest(x))
        kf, key_ids, n_keyed = carry
        flags, keyslot, fwd_idx, _, count, n_new, kf_new = keyframe_select(
            frames, kf, n_keyed, self.temporal_thresh)
        promoted = int(count)  # the mode's one host sync a batch
        if promoted:
            ids_k = self.ids_for(frames.index_select(0, fwd_idx[:promoted]))
            ids = torch.where((keyslot >= 0).view(-1, 1, 1),
                              ids_k.index_select(0, keyslot.clamp(min=0)), key_ids)
        else:
            ids = key_ids.expand(frames.shape[0], -1, -1).contiguous()
        return (*self._outputs(ids, frames), flags, (kf_new, ids[-1].clone(), n_new))

    def _call(self, x: torch.Tensor):
        """One shipped batch through the configured mode -> (ids, image,
        flags or None); the adaptive modes advance ``self._carry``."""
        if self.temporal_thresh is None:
            return (*self._program(x), None)
        if self._carry is None:
            self._carry = self._make_carry(*self._decode_hw(x))
        step = self._budget_step if self.temporal_budget is not None else self._sequential_step
        ids, image, flags, self._carry = step(x, self._carry)
        return ids, image, flags

    def _host_overlay(self, frames_host: np.ndarray, color: np.ndarray) -> np.ndarray:
        """run()'s host blend: the shipped frames (RGB, or I420 planes from
        the source, turned into RGB with K8's plain version) at decode size,
        resized to the ids' size with PIL bilinear when they differ, as
        ``tpuseg`` does (pipeline.py:989-1011)."""
        if frames_host.ndim == 3:
            h_dec = i420_geometry(frames_host.shape[1])
            frames_host = i420_to_rgb_flat(torch.from_numpy(frames_host)).numpy().reshape(
                frames_host.shape[0], h_dec, -1, 3)
        imgs = frames_host.reshape(frames_host.shape[:3] + (3,))
        if imgs.shape[1:3] != color.shape[1:3]:
            from PIL import Image

            th, tw = color.shape[1:3]
            imgs = np.stack([np.asarray(Image.fromarray(f).resize((tw, th), Image.BILINEAR))
                             for f in imgs])
        return (imgs // 2 + color // 2).astype(np.uint8)

    def run(
        self,
        frames,
        *,
        max_frames: int | None = None,
        need_color: bool = True,
    ) -> dict:
        """Stream (H, W, 3) uint8 frames (or, with ``transport="yuv420"``,
        packed (H*3/2, W) I420 planes) through the device, ``batch`` at a
        time (the last batch padded with repeats of its last frame), two
        batches in flight.

        Returns a dict with ``ids`` (N, H, W) uint8, ``color`` (palette or
        overlay, when ``need_color``), ``frames``, ``seconds`` and ``fps``
        (wall clock from the first submit to the last collect; the first
        batch also runs once untimed, so first-call costs stay out),
        ``batch_times`` (overlapping under pipelining, diagnostic only),
        ``h2d_bytes`` and ``d2h_bytes`` (the timed batches' frames up, ids
        and images down); in the adaptive modes also ``promoted`` and
        ``promotion_rate``, over the returned frames only.  The untimed first
        call leaves the adaptive carry as it found it."""
        cuda = self.device.type == "cuda"
        adaptive = self.temporal_thresh is not None
        promoted_flags = []
        ids_out, color_out = [], []
        batch_times = []
        fps_meter = FpsMeter()
        n_done = 0
        pending = []
        first = True
        t_wall0 = None
        moved = {"h2d_bytes": 0, "d2h_bytes": 0}

        def submit(buf):
            nonlocal first, t_wall0
            arr = np.stack(buf)
            pad = 0
            if arr.shape[0] < self.batch:
                pad = self.batch - arr.shape[0]
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
            frames_host = arr
            if self.transport == "yuv420" and arr.ndim == 4:
                arr = rgb_to_i420(arr)  # a 3-D stack is already I420 planes
            # flat (B, H, W*3): the same bytes as (B, H, W, 3), a numpy view
            x = torch.from_numpy(arr.reshape(arr.shape[0], arr.shape[1], -1))
            if cuda:
                x = x.pin_memory().to(self.device, non_blocking=True)
            if first:
                # first-call costs (kernel build, cuDNN plans) stay untimed;
                # the warmup would advance the adaptive carry: restore it
                carry0 = self._carry
                self._call(x)
                if cuda:
                    torch.cuda.synchronize(self.device)
                self._carry = carry0
                first = False
            t0 = time.perf_counter()
            if t_wall0 is None:
                t_wall0 = t0
            ids, image, flags = self._call(x)
            if not need_color:
                image = None
            moved["h2d_bytes"] += x.numel()
            moved["d2h_bytes"] += ids.numel() + (image.numel() if image is not None else 0)
            done = None
            if cuda:
                # start the device->host copies now so they overlap the next
                # batch; collect() waits on the event, not the device
                ids = torch.empty(ids.shape, dtype=torch.uint8,
                                  pin_memory=True).copy_(ids, non_blocking=True)
                if image is not None:
                    image = torch.empty(image.shape, dtype=torch.uint8,
                                        pin_memory=True).copy_(image, non_blocking=True)
                if flags is not None:
                    flags = torch.empty(flags.shape, dtype=torch.bool,
                                        pin_memory=True).copy_(flags, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            return ids, image, done, arr.shape[0] - pad, t0, frames_host, flags

        def collect(flight):
            ids, image, done, n, t0, frames_host, flags = flight
            if done is not None:
                done.synchronize()
            ids = ids.numpy()
            if self.ids_bits and not self.device_outputs:
                ids = unpack_ids(ids, self.ids_bits)
            if flags is not None:
                promoted_flags.append(flags.numpy()[:n])
            color = None
            if image is not None:
                color = image.numpy()
            elif need_color:
                # host reconstruction from ids: palette gather / overlay blend
                color = self.palette_np[ids]
                if self.want_overlay:
                    color = self._host_overlay(frames_host, color)
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
            return sum(f[3] for f in flights)

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
            **moved,
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
        """Device throughput (frames/sec) for frames shipped at (H, W) (I420
        with the yuv420 transport; resized on the device when ``target_size``
        differs): ``inner`` batches back to back, timed with CUDA events,
        best of ``reps``.  Each batch's input carries one byte of the
        previous batch's ids, so every iteration depends on the one before
        (bench.py's methodology).  Raises on a CPU segmenter (a device rate
        comes only from the card) and in the adaptive modes, whose rate
        depends on the content (``benchmark_adaptive_device_fps``)."""
        if self.device.type != "cuda":
            raise RuntimeError(
                "benchmark_device_fps times a CUDA device; this segmenter "
                f"runs on {self.device}")
        if self.temporal_thresh is not None:
            raise ValueError("the adaptive modes' device rate depends on the content; use "
                             "benchmark_adaptive_device_fps with real frames")
        h, w = size
        shape = ((self.batch, h * 3 // 2, w) if self.transport == "yuv420"
                 else (self.batch, h, w * 3))
        with torch.inference_mode():
            frames = torch.zeros(shape, dtype=torch.uint8, device=self.device)

            def loop():
                for _ in range(inner):
                    ids, _ = self._program(frames)
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
        """Device rate of the adaptive modes on real frames (their rate
        depends on the content), ``tpuseg``'s method (pipeline.py:
        1120-1187): full batches only (the remainder is dropped, never
        padded), chained through the carry from a fresh one, timed with CUDA
        events, best of ``reps``.  The budgeted mode runs with no host sync;
        the sequential mode reads its one count a batch, as it serves.
        Returns ``device_fps``, ``promotion_rate`` (of these frames),
        ``frames`` and ``frames_dropped``.  Raises on a CPU segmenter and
        outside the adaptive modes."""
        if self.device.type != "cuda":
            raise RuntimeError(
                "benchmark_adaptive_device_fps times a CUDA device; this segmenter "
                f"runs on {self.device}")
        if self.temporal_thresh is None:
            raise ValueError("benchmark_adaptive_device_fps times the adaptive temporal modes")
        arr = np.stack([np.asarray(f) for f in frames])
        b = self.batch
        if len(arr) < b:
            raise ValueError(f"need at least one full batch ({b}) of frames, got {len(arr)}")
        dropped = len(arr) % b
        arr = arr[:len(arr) - dropped]
        if self.transport == "yuv420" and arr.ndim == 4:
            arr = rgb_to_i420(arr)
        step = self._budget_step if self.temporal_budget is not None else self._sequential_step
        with torch.inference_mode():
            xs = torch.from_numpy(arr.reshape(len(arr) // b, b, arr.shape[1], -1)).to(self.device)
            carry0 = self._make_carry(*self._decode_hw(xs[0]))

            def loop():
                carry, promoted = carry0, []
                for fb in xs:
                    _, _, flags, carry = step(fb, carry)
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


def _interval_maps(nb: int, n_keys: int, interval: int, device) -> list[torch.Tensor]:
    """Interval nearest's static index maps (``tpuseg`` pipeline.py:559-565):
    each frame's preceding and next keyframe, and their frame positions."""
    prev_k = np.arange(nb) // interval
    next_k = np.minimum(prev_k + 1, n_keys - 1)
    return [torch.from_numpy(m).to(device) for m in
            (prev_k, next_k, prev_k * interval, np.minimum(next_k * interval, nb - 1))]


def interval_nearest_keys(d: torch.Tensor, interval: int, n_keys: int,
                          maps: list | None = None) -> torch.Tensor:
    """Interval mode's bidirectional reuse (``tpuseg`` pipeline.py:548-571):
    from d (B,) f32 with d[0] = 0 and d[i] the mean |delta| of frames i and
    i - 1, each frame's keyframe among the ``n_keys`` forwarded ones: the next
    one where its drift path there is strictly shorter than back to the
    preceding one, else the preceding one.  cumsum(d) is ``tpuseg``'s [0,
    cumsum(d[1:])]."""
    prev_k, next_k, prev_pos, next_pos = (maps if maps is not None else
                                          _interval_maps(d.shape[0], n_keys, interval, d.device))
    cum = torch.cumsum(d, 0)
    drift_prev = cum - cum.index_select(0, prev_pos)
    drift_next = cum.index_select(0, next_pos) - cum
    return torch.where((next_k > prev_k) & (drift_next < drift_prev), next_k, prev_k)


def budget_nearest_slots(d: torch.Tensor, fwd_idx: torch.Tensor, keyslot: torch.Tensor,
                         acc0: torch.Tensor, budget: int) -> torch.Tensor:
    """Budgeted mode's bidirectional reuse (``tpuseg`` pipeline.py:708-731):
    from K3's deltas d (B,), K4's ``fwd_idx`` and ``keyslot`` and the carried
    drift ``acc0`` (1,) (the drift from the live keyframe to the batch's
    start), each frame's promotion slot: the next promotion where its drift
    path there is strictly shorter than back to its keyframe, else its own
    (-1: the carried keyframe)."""
    cum = torch.cumsum(d, 0)
    next_slot = keyslot + 1
    pos_prev = fwd_idx.index_select(0, keyslot.clamp(0, budget - 1))
    pos_next = fwd_idx.index_select(0, next_slot.clamp(0, budget - 1))
    drift_prev = torch.where(keyslot >= 0, cum - cum.index_select(0, pos_prev), acc0 + cum)
    drift_next = cum.index_select(0, pos_next) - cum
    use_next = (next_slot < keyslot[-1] + 1) & (drift_next < drift_prev)
    return torch.where(use_next, next_slot, keyslot)


def resize_frames(frames: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Flat (B, h, w*3) uint8 frames -> flat (B, H, W*3) uint8 at ``size``:
    ``tpuseg``'s device resize (pipeline.py:434-455), bilinear with
    half-pixel centres and no antialias on f32, rounded half to even and
    clipped.  Frames already at ``size`` come back as they are."""
    b, h, w = frames.shape[0], frames.shape[1], frames.shape[2] // 3
    th, tw = size
    if (h, w) == (th, tw):
        return frames
    x = frames.reshape(b, h, w, 3).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(th, tw), mode="bilinear", align_corners=False, antialias=False)
    x = x.round_().clamp_(0, 255).to(torch.uint8)
    return x.permute(0, 2, 3, 1).reshape(b, th, tw * 3)


def _check_temporal(batch, interval, thresh, budget, nearest, warp) -> None:
    """``tpuseg``'s argument checks of the temporal modes (pipeline.py:
    404-432, 825-835), as ``ValueError``s."""
    batched = interval > 1 or (thresh is not None and budget is not None)
    if interval < 1:
        raise ValueError(f"temporal_interval must be >= 1, got {interval}")
    if interval > 1 and thresh is not None:
        raise ValueError("temporal_interval and temporal_thresh are mutually exclusive")
    if warp and not batched:
        raise ValueError("temporal_warp requires interval mode (temporal_interval > 1) or "
                         "budgeted adaptive mode (temporal_thresh + temporal_budget)")
    if budget is not None and thresh is None:
        raise ValueError("temporal_budget requires temporal_thresh")
    if nearest and not batched:
        raise ValueError("temporal_nearest requires a BATCHED reuse mode (temporal_interval "
                         "> 1, or temporal_thresh + temporal_budget); the sequential adaptive "
                         "scan cannot look ahead")
    if budget is not None and not 0 < budget <= batch:
        raise ValueError(f"temporal_budget {budget} must be in 1..batch ({batch})")
