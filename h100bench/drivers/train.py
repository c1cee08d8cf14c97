"""Training traffic (``"kind": "train"``): ``make_seg_train_step`` steps
dispatched back to back on a ring of ``ring`` device-resident batches of
``batch`` crops made from the seed (moving-shapes scenes, normalized as the
training CLI normalizes, labels over the classes and the ignore label 255),
the optimizer the training CLI builds (SGD with momentum and weight decay
under its step schedule).

Set-up builds one train state and drives it from the seed through its first
``check_steps`` steps on the ring's first batches (every kernel warms up on
them); the window continues with that same state.  The harness
synchronises only when the window closes.

Metric: ``train_step_ms``, the window's wall time over the steps dispatched
in it.  ``correct``: the plain reference follows the checked steps in
float32 from the same weights and batches.  Read are the first step's loss,
the first gradient as the optimizer got it (its momentum buffer after one
step less the weight decay term), the parameters' change over the checked
steps and the first step's BatchNorm batch variances, the last three per
leaf as ``|norm(program) - norm(reference)|`` over the larger of the leaf's
reference norm and the median leaf's, and the median over the leaves
taken; leaves whose reference gradient is under a thousandth of the median
leaf's are left out.  Compared are those the cell's limits file names.
The later steps' losses and the worst leaf are not compared: from random
initial weights the loss starts near 7-9 nats and rounding alone moves
them by a tenth or more, as far in the reference's own bf16 steps as in the
program's (``control.py --look``; PERF.md).  The window's steps, which
follow the checked ones on the same state, are checked for finite losses
only.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import scene, work
from h100bench.reference import drn

FROZEN = ("up.weight",)


def leaf_gaps(prog: dict, ref: dict, keep) -> dict[str, float]:
    """Each leaf's ``|norm(prog) - norm(ref)| / max(norm(ref), median
    norm(ref))`` over the leaves in ``keep``."""
    norms = {k: float(ref[k].float().norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(prog[k].float().norm()) - norms[k]) / max(norms[k], med) for k in keep}


def kept_leaves(grads: dict) -> list[str]:
    """Leaves whose gradient is above a thousandth of the median leaf's."""
    norms = {k: float(g.norm()) for k, g in grads.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def leaf_readings(p0: dict, prog: tuple, ref: tuple) -> dict:
    """``prog`` and ``ref`` are each ``(losses, first gradients, params
    after the checked steps, the first step's BatchNorm batch variances)``,
    ``p0`` the starting parameters (host).  ``loss``: the first step's
    loss, as a share of the reference's; ``grad``, ``step`` and ``var``:
    the ``leaf_gaps`` of the first gradient, of the change and of the batch
    variances, by leaf."""
    (p_losses, p_g1, p_p, p_v), (r_losses, r_g1, r_p, r_v) = prog, ref
    keep = kept_leaves(r_g1)
    host = lambda d, ks=keep: {k: d[k].float().cpu() for k in ks}  # noqa: E731
    dp = {k: v - p0[k].float() for k, v in host(p_p).items()}
    rdp = {k: v - p0[k].float() for k, v in host(r_p).items()}
    return {"loss": abs(p_losses[0] - r_losses[0]) / abs(r_losses[0]),
            "grad": leaf_gaps(host(p_g1), host(r_g1), keep),
            "step": leaf_gaps(dp, rdp, keep),
            "var": leaf_gaps(host(p_v, list(r_v)), host(r_v, list(r_v)), list(r_v))}


def compare(p0: dict, prog: tuple, ref: tuple) -> dict:
    """The numbers of ``correct`` (``leaf_readings``): the first step's
    loss, and the median over the leaves of each other reading."""
    got = leaf_readings(p0, prog, ref)
    return {k: v if k == "loss" else float(np.median(list(v.values()))) for k, v in got.items()}


class TrainRunner:
    def __init__(self, cell, program: bool = True):
        self.cell = cell
        s_weights, s_data = cell.seeds(2)
        self.p0, self.s0 = scene.make_weights(cell.cfg, s_weights, cell.device)
        self.images, self.labels = self._ring(s_data)
        if program:
            self._program()

    def _program(self):
        """The train state, driven through the checked steps by the
        window's own call; keeps the program's (losses, first gradients,
        params after)."""
        from tpuseg_torch.models.drnseg import build_drnseg_spec
        from tpuseg_torch.train import create_train_state, make_seg_train_step, make_sgd
        from tpuseg_torch.train.optim import milestones_for_epochs, multistep_schedule

        cfg, tr, dev = self.cell.cfg, self.cell.traffic, self.cell.device
        spec = build_drnseg_spec(cfg["arch"], cfg["num_classes"])
        sched = multistep_schedule(tr["lr"], milestones_for_epochs(tr["epochs"]), 0.1,
                                   tr["steps_per_epoch"])
        self.tx = make_sgd(sched, tr["momentum"], tr["weight_decay"])
        self.step_fn = make_seg_train_step(spec, self.tx,
                                           compute_dtype=getattr(torch, cfg["compute_dtype"]))
        self.ts = create_train_state({k: v.to(dev) for k, v in self.p0.items()},
                                     {k: v.to(dev) for k, v in self.s0.items()}, self.tx)
        self.steps = 0
        losses = []
        for i in range(tr["check_steps"]):
            losses.append(self._step())
            if i == 0:
                # the momentum buffer after one step: the gradient plus wd * p0
                trace = self.ts.opt_state[self.tx.links.index("trace")]["trace"]
                g1 = {k: v.detach().cpu() - tr["weight_decay"] * self.p0[k]
                      for k, v in trace.items()}
                # the batch variance each running variance took in
                var1 = {k[: -len(".running_var")]: (v.detach().cpu() - (1 - drn.BN_MOMENTUM)
                                                    * self.s0[k]) / drn.BN_MOMENTUM
                        for k, v in self.ts.bn_state.items() if k.endswith(".running_var")}
        self.prog = ([float(v) for v in losses], g1,
                     {k: v.detach().cpu() for k, v in self.ts.params.items()}, var1)

    def _ring(self, seed: int):
        """``ring`` batches: NHWC float32 images normalized with the
        configuration's mean and std, int64 labels; each crop its own
        scene at a time drawn from the seed."""
        cfg, tr, dev = self.cell.cfg, self.cell.traffic, self.cell.device
        h, w = tr["crop"]
        n = tr["ring"] * tr["batch"]
        g = scene.generator(seed, dev)
        images = torch.empty((n, h, w, 3), dtype=torch.float32, device=dev)
        labels = torch.empty((n, h, w), dtype=torch.int64, device=dev)
        mean = torch.tensor(cfg["mean"], device=dev)
        std = torch.tensor(cfg["std"], device=dev)
        ts = (torch.rand(n, generator=g, device=dev) * 30.0).tolist()
        for i in range(n):
            img, lab = scene.Scene(g, (h, w), cfg["num_classes"], void=True).frame(ts[i])
            images[i] = (img.float() / 255.0 - mean) / std
            labels[i] = lab.long()
        shape = (tr["ring"], tr["batch"])
        return images.view(*shape, h, w, 3), labels.view(*shape, h, w)

    def _step(self):
        k = self.steps % self.images.shape[0]
        self.ts, m = self.step_fn(self.ts, self.images[k], self.labels[k])
        self.steps += 1
        return m["loss"]

    def _sync(self):
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def window(self, seconds: float) -> dict:
        losses, n = [], 0
        t0 = time.perf_counter()
        while not n or time.perf_counter() - t0 < seconds:
            losses.append(self._step())
            n += 1
        self._sync()
        wall = time.perf_counter() - t0
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"metrics": {"train_step_ms": wall / n * 1e3}, "attempted": n, "failed": bad}

    def lead(self) -> None:
        self._step()
        self._sync()

    def burst(self) -> dict:
        n = self.cell.traffic["trace_steps"]
        losses = [self._step() for _ in range(n)]
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"steps": n, "attempted": n, "failed": bad}

    def work(self) -> dict:
        tr = self.cell.traffic
        return {"step_peak_s": work.train_step_ops(self.cell.cfg, tr["crop"], tr["batch"])
                / work.PEAK_OPS_S["bf16"]}

    def free(self) -> None:
        del self.ts, self.step_fn

    def reference(self, prec: drn.Precision, batch_slice=slice(None)) -> tuple:
        """The reference's (losses, first gradients, params after) over the
        checked steps, each batch cut to ``batch_slice``."""
        dev, tr = self.cell.device, self.cell.traffic
        batches = [(self.images[i][batch_slice], self.labels[i][batch_slice])
                   for i in range(tr["check_steps"])]
        with drn.exact_float32():
            return drn.sgd_steps({k: v.to(dev) for k, v in self.p0.items()}, self.cell.cfg,
                                 batches, tr, prec, FROZEN)

    def check(self) -> dict:
        self.images = self.images[: self.cell.traffic["check_steps"]]
        self.labels = self.labels[: self.cell.traffic["check_steps"]]
        got = compare(self.p0, self.prog, self.reference(drn.Precision("float32")))
        return {k: {"value": v, "limit": self.cell.limits[k]} for k, v in got.items()
                if k in self.cell.limits}


def setup(cell, program: bool = True) -> TrainRunner:
    return TrainRunner(cell, program)
