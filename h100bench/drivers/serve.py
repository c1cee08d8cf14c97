"""Serving traffic (``"kind": "serve"``): one client in a closed loop, one
``VideoSegmenter.run(frames, need_color=...)`` call a request, the next sent
when the call returns.

A request is ``frames_per_call`` frames of one clip of a pool made from the
seed at set-up (``pool_clips`` scenes of ``pool_frames`` frames; a request
longer than its clip plays the clip again from its start).  Requests cycle
through the pool in an order drawn from the seed.  The program is built as
``seg_video`` builds it: the configuration's masks through the port's
masker, its plans under the CLI's default sparse lowering, int8 plans
calibrated on the first ``quantize.calibrate_frames`` frames of the first
request.

Metrics: ``fps``, every frame returned over the window's wall time (from
the first call to the return of the last, which is sent while the window
is open), and ``clip_ms_p95`` over every call of the window.  ``correct``:
the widest gap, over a sample of ``check_frames`` returned frames drawn
from the seed (reservoir sampling over every frame returned), by which a
served id's reference logit lies below the reference's best at its pixel,
as a share of the reference logits' scale (``reference.drn.gap_of``).
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from h100bench import scene, stats, work
from h100bench.reference import drn

NO_ANSWER = 1e9  # the gap of an answer that is missing or not an id


def lane_rate(device) -> float:
    """f32 lane instructions a second: SMs x 128 x the max SM clock that
    ``nvidia-smi`` reports (B1's bound)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits",
         "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    return torch.cuda.get_device_properties(device).multi_processor_count * 128 * mhz * 1e6


def config_precision(cfg: dict, folded: dict, calib: torch.Tensor, mode: str | None = None):
    """The reference's precision for ``cfg`` (``mode`` None), or a control's:
    ``"fp8"``, or ``"int4"`` in place of the configuration's int8."""
    if mode == "fp8":
        return drn.Precision("fp8")
    if cfg.get("quantize") or mode == "int4":
        qmax = 7 if mode == "int4" else 127
        return drn.Precision("int", drn.int8_convs(cfg), qmax,
                             drn.calibrate(folded, cfg, calib, qmax))
    return drn.Precision("float32")


class ServeRunner:
    def __init__(self, cell, program: bool = True):
        self.cell = cell
        cfg, tr = cell.cfg, cell.traffic
        dev = cell.device
        self.size = tuple(cfg["frame"])
        self.batch = tr["batch"]
        s_weights, s_scene, s_order, s_sample = cell.seeds(4)
        self.params, self.state = scene.make_weights(cfg, s_weights, dev)
        clip_seeds = np.random.SeedSequence(s_scene).generate_state(tr["pool_clips"], np.uint64)
        self.pool = np.stack([scene.video(int(s % 2 ** 63), dev, self.size, tr["pool_frames"],
                                          cfg["num_classes"]) for s in clip_seeds])
        self.order_rng = np.random.default_rng(s_order)
        self.sample_rng = np.random.default_rng(s_sample)
        self.order: list[int] = []
        self.calls = 0
        self.reservoir: list = []  # ((clip, frame), ids)
        self.seen = 0
        shapes = {f"{c.name}.weight": (c.cout, c.cin, c.k, c.k) for c in drn.all_convs(cfg)}
        self.masks = drn.block_regular_masks(cfg["prune"], shapes) if cfg.get("prune") else None
        self.calib_keys = [(self._clip(0), j) for j in range(
            (cfg.get("quantize") or {}).get("calibrate_frames", 0))]
        if program:
            self.seg = self._program()
            self._call(sample=False, frames=tr["warm_frames"])

    # -- the program ------------------------------------------------------
    def _program(self):
        from tpuseg_torch.cli.seg_video import parse_args
        from tpuseg_torch.models.drnseg import build_drnseg_spec
        from tpuseg_torch.video.pipeline import VideoSegmenter

        cfg, tr = self.cell.cfg, self.cell.traffic
        spec = build_drnseg_spec(cfg["arch"], cfg["num_classes"])
        params, exec_plans = dict(self.params), None
        if cfg.get("prune"):
            from tpuseg_torch.models.sparse_exec import build_sparse_plans
            from tpuseg_torch.ops.fold_bn import fold_bn
            from tpuseg_torch.sparsity import apply_masks, create_masker

            cli = parse_args(["--video", "synthetic"])  # the CLI's default lowering
            prune = cfg["prune"]
            masks = create_masker(prune["masker"], seed=prune["seed"]).generate_masks(
                params, is_static=prune["is_static"])
            params = apply_masks(params, masks)
            exec_plans, _report = build_sparse_plans(
                fold_bn(params, self.state, spec), masks, spec,
                lowering=cli.sparse_lowering, gathered_mode=cli.gathered_mode)
        calib = [self.pool[c, f] for c, f in self.calib_keys] or None
        return VideoSegmenter(
            params, self.state, spec, cfg["mean"], cfg["std"], device=self.cell.device,
            compute_dtype=getattr(torch, cfg["compute_dtype"]), batch=self.batch,
            exec_plans=exec_plans, quantize=bool(cfg.get("quantize")), calib_frames=calib,
            target_size=self.size, transport=tr["transport"], ids_bits=tr.get("ids_bits"))

    # -- requests ---------------------------------------------------------
    def _clip(self, i: int) -> int:
        while len(self.order) <= i:
            self.order.extend(self.order_rng.permutation(len(self.pool)).tolist())
        return self.order[i]

    def _call(self, sample: bool = True, frames: int | None = None):
        n, nf = frames or self.cell.traffic["frames_per_call"], self.pool.shape[1]
        clip = self._clip(self.calls)
        self.calls += 1
        t0 = time.perf_counter()
        res = self.seg.run((self.pool[clip, j % nf] for j in range(n)), need_color=self.cell.traffic["need_color"])
        t1 = time.perf_counter()
        ids = res["ids"]
        ok = (res["frames"] == n and ids.shape == (n, *self.size) and ids.dtype == np.uint8)
        if sample and ok:
            self._sample(clip, ids)
        return t1 - t0, n, ok

    def _sample(self, clip: int, ids: np.ndarray) -> None:
        """Reservoir sampling (Algorithm R) over every frame returned."""
        r, nf = self.cell.traffic["check_frames"], self.pool.shape[1]
        for j in range(len(ids)):
            if len(self.reservoir) < r:
                self.reservoir.append(((clip, j % nf), ids[j].copy()))
            else:
                k = int(self.sample_rng.integers(0, self.seen + 1))
                if k < r:
                    self.reservoir[k] = ((clip, j % nf), ids[j].copy())
            self.seen += 1

    # -- runner API -------------------------------------------------------
    def window(self, seconds: float) -> dict:
        lat, frames, attempted, failed = [], 0, 0, 0
        t0 = time.perf_counter()
        while not attempted or time.perf_counter() - t0 < seconds:
            dt, n, ok = self._call()
            attempted += 1
            failed += not ok
            frames += n if ok else 0
            lat.append(dt)
        wall = time.perf_counter() - t0
        return {"metrics": {"fps": stats.rate(frames, wall),
                            "clip_ms_p95": stats.p95(lat) * 1e3},
                "attempted": attempted, "failed": failed}

    def lead(self) -> None:
        self._call(sample=False)

    def burst(self) -> dict:
        out = {"frames": 0, "attempted": 0, "failed": 0}
        for _ in range(self.cell.traffic["trace_calls"]):
            _dt, n, ok = self._call()
            out["attempted"] += 1
            out["failed"] += not ok
            out["frames"] += n if ok else 0
        return out

    def work(self) -> dict:
        cfg = self.cell.cfg
        h8, w8 = -(-self.size[0] // 8), -(-self.size[1] // 8)
        dev = self.cell.device
        return {
            "frame_peak_s": work.frame_peak_s(cfg, self.masks, self.size),
            "b1_bound_ms": work.b1_bound_ms((self.batch, h8, w8, cfg["num_classes"]), 2,
                                            lane_rate(dev)) if dev.type == "cuda" else None,
            "int8_bound_ms": work.int8_forward_bound_ms(cfg, self.masks, self.batch, self.size),
        }

    def free(self) -> None:
        del self.seg

    def reference_logits(self, keys, mode: str | None = None):
        """Yields ``(key, logits)`` of the reference in the configuration's
        precision (``mode`` None) or a control's (``mode``) for each (clip,
        frame) key."""
        cfg, dev = self.cell.cfg, self.cell.device
        with drn.exact_float32(), torch.no_grad():
            params = {k: v.to(dev) for k, v in self.params.items()}
            state = {k: v.to(dev) for k, v in self.state.items()}
            folded = drn.fold(params, state, cfg, self.masks)
            calib = (torch.from_numpy(np.stack([self.pool[c, f] for c, f in self.calib_keys]))
                     .to(dev) if self.calib_keys else None)
            prec = config_precision(cfg, folded, calib, mode)
            for key in keys:
                frame = torch.from_numpy(self.pool[key]).to(dev)[None]
                yield key, drn.serve_logits(folded, cfg, frame, prec)

    def check(self) -> dict:
        worst = NO_ANSWER if not self.reservoir else 0.0
        ids_by_key = {}
        for key, ids in self.reservoir:
            ids_by_key.setdefault(key, []).append(ids)
        for key, logits in self.reference_logits(list(ids_by_key)):
            for ids in ids_by_key[key]:
                if int(ids.max()) >= logits.shape[1]:
                    worst = NO_ANSWER
                    continue
                g, s = drn.gap_of(logits, torch.from_numpy(ids).to(logits.device)[None])
                worst = max(worst, g / s)
        return {"gap": {"value": worst, "limit": self.cell.limits["gap"]}}


def setup(cell, program: bool = True) -> ServeRunner:
    return ServeRunner(cell, program)
