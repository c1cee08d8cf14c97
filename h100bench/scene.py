"""Inputs made from the seed on the device: the weights handed to both the
program and the reference, and moving-shapes video.

The scene model is the port's ``data/shapes.py`` world (objects of three
kinds with constant velocities bouncing off the borders, a scene-static
texture of sigma 18 and sensor noise of sigma 2 a frame) drawn with one
``torch.Generator`` and painted with tensor ops, so a pool of full-size
frames takes a fraction of a second where the numpy renderer takes half a
second a frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100bench.reference import drn

SHAPE_KINDS = 3  # circle, rect, triangle
TEXTURE_SIGMA, SENSOR_SIGMA = 18.0, 2.0


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def make_weights(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(params, bn_state) of DRN-D DRNSeg as float32 CPU tensors in the
    reference's naming, drawn on ``device`` in two calls: fyu/drn's He
    init for every conv (std sqrt(2 / (k * k * cout))) and the head, and a
    BatchNorm of a trained network (gamma, running var in [0.75, 1.25],
    beta, running mean in [-0.1, 0.1]), the head's bias in [-0.1, 0.1]; the
    upsampler's fixed bilinear kernel (16, 16)."""
    g = generator(seed, device)
    convs = drn.all_convs(cfg)
    nc, fc = cfg["num_classes"], drn.feature_channels(cfg)
    shapes = [(c.cout, c.cin, c.k, c.k) for c in convs] + [(nc, fc, 1, 1)]
    stds = [math.sqrt(2.0 / (c.k * c.k * c.cout)) for c in convs] + [math.sqrt(2.0 / nc)]
    sizes = [int(np.prod(s)) for s in shapes]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    scale = torch.repeat_interleave(torch.tensor(stds, device=device),
                                    torch.tensor(sizes, device=device))
    normal = (normal * scale).cpu()
    n_bn = sum(c.cout for c in convs)
    uniform = torch.rand(4 * n_bn + nc, generator=g, device=device).cpu()
    params, state = {}, {}
    off = 0
    for c, shape, n in zip(convs, shapes, sizes):
        params[f"{c.name}.weight"] = normal[off:off + n].view(shape).clone()
        off += n
    params["seg.weight"] = normal[off:].view(shapes[-1]).clone()
    u = uniform[:4 * n_bn].view(4, n_bn)
    off = 0
    for c in convs:
        sl = slice(off, off + c.cout)
        params[f"{c.bn}.weight"] = 0.75 + 0.5 * u[0, sl]
        params[f"{c.bn}.bias"] = 0.2 * u[1, sl] - 0.1
        state[f"{c.bn}.running_mean"] = 0.2 * u[2, sl] - 0.1
        state[f"{c.bn}.running_var"] = 0.75 + 0.5 * u[3, sl]
        off += c.cout
    params["seg.bias"] = 0.2 * uniform[4 * n_bn:] - 0.1
    params["up.weight"] = torch.from_numpy(drn.bilinear_kernel())
    return params, state


class Scene:
    """One moving-shapes scene: ``n_objects`` objects over a background of
    class 0, class colors drawn per scene; the first object is void
    (label 255) when ``void`` is set."""

    def __init__(self, g: torch.Generator, size, classes: int, speed: float = 4.0,
                 n_objects=(5, 9), void: bool = False):
        dev = g.device
        h, w = size
        self.size = size
        u = lambda *s: torch.rand(*s, generator=g, device=dev)  # noqa: E731
        n = int(n_objects[0] + (u(1) * (n_objects[1] - n_objects[0] + 1)).floor().item())
        p = u(n, 8).cpu().tolist()
        self.objs = []
        for i, r in enumerate(p):
            vx, vy = (2 * r[6] - 1) * speed, (2 * r[7] - 1) * speed
            self.objs.append(dict(
                kind=int(r[0] * SHAPE_KINDS), cls=255 if void and i == 0 else
                1 + int(r[1] * (classes - 1)), cx=(0.1 + 0.8 * r[2]) * w, cy=(0.1 + 0.8 * r[3]) * h,
                size=(0.08 + 0.14 * r[4]) * min(h, w), aspect=0.6 + 1.1 * r[5], vx=vx, vy=vy))
        self.colors = 40.0 + 180.0 * u(256, 3)
        self.texture = torch.randn((h, w, 3), generator=g, device=dev) * TEXTURE_SIGMA
        self.yy = torch.arange(h, device=dev, dtype=torch.float32).view(h, 1)
        self.xx = torch.arange(w, device=dev, dtype=torch.float32).view(1, w)
        self.g = g

    @staticmethod
    def _bounce(x: float, extent: int, margin: float) -> float:
        lo, hi = margin, extent - margin
        if hi <= lo:
            return 0.5 * extent
        period = 2 * (hi - lo)
        x = (x - lo) % period
        return lo + (period - x if x > hi - lo else x)

    def label(self, t: float) -> torch.Tensor:
        h, w = self.size
        lab = torch.zeros((h, w), dtype=torch.uint8, device=self.yy.device)
        for o in self.objs:
            cx = self._bounce(o["cx"] + t * o["vx"], w, o["size"])
            cy = self._bounce(o["cy"] + t * o["vy"], h, o["size"])
            dx, dy, s = self.xx - cx, self.yy - cy, o["size"]
            if o["kind"] == 0:
                m = dx * dx + dy * dy < s * s
            elif o["kind"] == 1:
                m = (dx.abs() < s * o["aspect"]) & (dy.abs() < s)
            else:
                m = (dy.abs() < s) & (dx.abs() < s * o["aspect"] * (dy + s) / (2 * s))
            lab[m] = o["cls"]
        return lab

    def frame(self, t: float) -> tuple[torch.Tensor, torch.Tensor]:
        """(uint8 (H, W, 3) frame, uint8 (H, W) labels) at time ``t``."""
        lab = self.label(t)
        img = self.colors[lab.long()] + self.texture
        img += torch.randn(img.shape, generator=self.g, device=img.device) * SENSOR_SIGMA
        return img.clamp_(0, 255).to(torch.uint8), lab


def video(seed: int, device, size, n_frames: int, classes: int, **kw) -> np.ndarray:
    """(n_frames, H, W, 3) uint8 host frames of one scene."""
    sc = Scene(generator(seed, device), size, classes, **kw)
    out = torch.empty((n_frames, *size, 3), dtype=torch.uint8, device=device)
    for t in range(n_frames):
        out[t] = sc.frame(float(t))[0]
    return out.cpu().numpy()
