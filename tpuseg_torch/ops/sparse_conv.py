"""Fused block-sparse convolution (counterpart of ``tpuseg/ops/sparse_conv.py``
``FusedSparseConv`` / ``plan_fused_sparse_conv`` / ``fused_sparse_conv_apply``).

A masked stride-1 'same' k x k conv with dilation d is packed per
128-channel output block ``jb``: the union over the T = k*k taps of the
input 128-channel blocks with any nonzero weight is the block's support,
padded to the layer's largest support S by repeating ``rows[jb, 0]`` with
zero weights.  The packing is ``tpuseg``'s, value for value:

    rows (nmb, S) int32        support block ids per out-block
    vals (nmb, T*S*128, 128)   weights, row (t*S + s)*128 + c, column m

and the conv is

    y[n, i, j, jb*128 + m] = sum_t sum_s sum_c
        x[n, i + dy_t - pad, j + dx_t - pad, rows[jb, s]*128 + c]
        * vals[jb, (t*S + s)*128 + c, m]

with pad = d*(k-1)/2, taps (dy_t, dx_t) = (p*d, q*d) for t = p*k + q, x
zero outside the image, x cast to the vals dtype, f32 accumulation and an
f32 (N, H, W, Cout) result.  Beside ``tpuseg``'s arrays each packing
carries its live steps, built from the same nonzero mask: ``steps`` (nmb,
T*S) int32, each out-block's step ids t*S + s of nonzero tiles, and
``nsteps`` (nmb,) their count.  The kernel walks only those.

- ``fused_sparse_conv_reference``: the plain version (per out-block channel
  gather + dense ``F.conv2d`` in f32 on the upcast operands).
- ``fused_sparse_conv_apply``: the serving entry point.  On a CUDA tensor
  it launches the hand-written kernel ``tpuseg_torch/csrc/sparse_conv.cu``
  (the port of ``tpuseg.ops.sparse_conv.fused_sparse_conv_apply``); on a
  CPU tensor it runs the plain version.
- ``b2_tile_rows``: the image rows R of one tile of the kernel's bf16 path,
  min(floor(256 / W), H) on maps narrower than 256 pixels, else 1 (a
  256-pixel row segment); the wrapper passes it and the kernel checks it.
- ``fused_sparse_conv_bias_bf16``: the route bf16 serving takes
  (``models/drn.py``): one launch of the same kernel writes
  ``bf16(float(bf16(y)) + float(bias))``, the bits of ``tpuseg``'s
  cast-then-bias passes; ``fused_sparse_conv_bias_bf16_reference`` is those
  two passes.

The same kernel serves ``tpuseg``'s other Pallas kernels of this function:

- ``XwBsr`` / ``pack_xw_bsr`` / ``bsr_matmul_xw`` (kernel B4, y (P, M) =
  x (P, K) @ W with W column-block sparse): ``XwBsr`` is B2's packing at
  k = 1, so x is launched as one image row of P pixels;
  ``bsr_matmul_xw_reference`` is its plain version.  ``SparseConvPlan`` /
  ``plan_sparse_conv`` / ``sparse_conv_apply`` lower a conv tap by tap onto
  it; ``sparse_conv_reference`` is the plain version.
- ``SharedFusedSparseConv`` / ``plan_shared_sparse_conv`` (one K-support
  for the whole layer, a ``FusedSparseConv`` whose rows all repeat it) and
  the six round-3 entry points (kernels B7a-f): B2's kernel on the packing
  each takes, each with its own launch count.

The int8 half (``tpuseg``'s ``FusedSparseConvQ``, ``quantize_fused_plan``,
``fused_sparse_conv_apply_q``): per-output-channel symmetric int8 weights,
x quantized per frame (dynamic absmax) or with a static scale, an exact
integer conv and the epilogue ``float(acc) * (x_scale[n] * w_scale[o])``.
``FusedSparseConvQ`` carries the live steps of its nonzero int8 tiles, as
``FusedSparseConv`` does.

- ``quantize_activation``: ``tpuseg``'s x quantization (the step it runs in
  XLA before its Pallas kernel): on a CUDA tensor the hand-written kernels
  of ``tpuseg_torch/csrc/quantize.cu``, optionally through a channel map;
  ``quantize_activation_reference`` is its plain version.
- ``int_conv_exact``: the integer conv in float64, exact below 2**53.
- ``fused_sparse_conv_q_reference``: the plain version (quantize, exact
  integer conv on the dense weight rebuilt from the packing, epilogue).
- ``fused_sparse_conv_apply_q``: the entry point.  On a CUDA tensor it
  quantizes x and launches ``tpuseg_torch/csrc/sparse_conv_q.cu`` (kernel
  B3, the port of ``fused_sparse_conv_apply_q``); on a CPU tensor it runs
  the plain version.
- ``fused_sparse_conv_q_bias_bf16``: the route bf16 serving takes for every
  int8 plan: the same launches write ``bf16(float(bf16(y)) +
  float(bias))``; ``fused_sparse_conv_q_bias_bf16_reference`` is the cast
  and bias passes it replaces (``cast_bias_bf16``).
- ``fused_sparse_conv_q_bias_relu``: the int8 stem's route
  (``tpuseg/ops/polyphase.py:349-359``): the same launches write
  ``relu(y + bias)`` in f32, as f32 or rounded once to bf16, with
  ``tpuseg``'s relu (``relu_tpuseg``); its plain version is
  ``fused_sparse_conv_q_bias_relu_reference``.  A negative entry of a
  channel map reads 0 (``select_channels``), so the quantize pass pads
  conv0's 48 channels to the 128 B3 takes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models.weights import oihw_to_hwio_np

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BK = BM = 128  # channel block sizes (in, out), the kernel's


def _raise_on(lib, kernel: str, err: int) -> None:
    """Raise if a launch through the kernel library returned an error."""
    if err != 0:
        msg = lib.tpuseg_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")


@dataclasses.dataclass
class FusedSparseConv:
    """Packed operand of the fused block-sparse conv."""

    vals: torch.Tensor  # (nmb, T*S*bk, bm), the plan dtype
    rows: torch.Tensor  # (nmb, S) int32 K-block index per support slot
    taps: np.ndarray    # (T, 2) (dy, dx) offsets into the padded input
    s: int
    bk: int
    bm: int
    kernel: int
    dilation: int
    cin: int
    cout: int
    block_density: float
    # the live steps, built with the packing from its nonzero mask: per
    # out-block the step ids t*S + s of its nonzero tiles, in order, padded
    # with 0 (``steps``), and their count (``nsteps``); the kernel walks
    # only these
    steps: torch.Tensor = dataclasses.field(kw_only=True)   # (nmb, T*S) int32
    nsteps: torch.Tensor = dataclasses.field(kw_only=True)  # (nmb,) int32

    def to(self, device) -> "FusedSparseConv":
        """The plan with its tensors on ``device`` (dtypes unchanged)."""
        return dataclasses.replace(self, vals=self.vals.to(device), rows=self.rows.to(device),
                                   steps=self.steps.to(device), nsteps=self.nsteps.to(device))


def _step_list(live: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """``(steps, nsteps)`` of a (nmb, T*S) bool mask of live tiles: each
    out-block's live step ids t*S + s in order, padded with 0, and their
    count."""
    steps = np.zeros(live.shape, np.int32)
    for j, row in enumerate(live):
        ids = np.flatnonzero(row)
        steps[j, :len(ids)] = ids
    return torch.from_numpy(steps), torch.from_numpy(live.sum(axis=1).astype(np.int32))


def plan_fused_sparse_conv(
    w_oihw,
    mask_oihw,
    dilation: int = 1,
    dtype: torch.dtype = torch.bfloat16,
) -> FusedSparseConv:
    """Pack a masked stride-1 conv (OIHW weight and mask, tensors or numpy)
    for the fused kernel: ``tpuseg``'s numpy packing on the HWIO view, so
    ``rows``/``vals`` equal ``tpuseg``'s bit for bit."""
    wm = oihw_to_hwio_np(w_oihw) * oihw_to_hwio_np(mask_oihw)
    kh, kw, cin, cout = wm.shape
    bk, bm = BK, BM
    assert cin % bk == 0 and cout % bm == 0
    nkb, nmb = cin // bk, cout // bm
    T = kh * kw
    nz = np.zeros((nmb, T, nkb), bool)
    for t in range(T):
        p, q = divmod(t, kw)
        blocks = wm[p, q].reshape(nkb, bk, nmb, bm)
        nz[:, t, :] = (np.abs(blocks).sum(axis=(1, 3)) > 0).T
    union = nz.any(axis=1)  # (nmb, nkb)
    S = max(int(union.sum(axis=1).max()), 1)
    vals = np.zeros((nmb, T, S, bk, bm), np.float32)
    rows = np.zeros((nmb, S), np.int32)
    live = np.zeros((nmb, T, S), bool)
    for j in range(nmb):
        for s_i, k in enumerate(np.flatnonzero(union[j])):
            rows[j, s_i] = k
            for t in range(T):
                p, q = divmod(t, kw)
                if nz[j, t, k]:
                    vals[j, t, s_i] = wm[p, q][k * bk:(k + 1) * bk, j * bm:(j + 1) * bm]
                    live[j, t, s_i] = True
    taps = np.array([(p * dilation, q * dilation) for p in range(kh) for q in range(kw)],
                    np.int32)
    steps, nsteps = _step_list(live.reshape(nmb, T * S))
    return FusedSparseConv(
        vals=torch.from_numpy(vals.reshape(nmb, T * S * bk, bm)).to(dtype),
        rows=torch.from_numpy(rows),
        taps=taps,
        s=S,
        bk=bk,
        bm=bm,
        kernel=kh,
        dilation=dilation,
        cin=cin,
        cout=cout,
        block_density=float(union.mean()),
        steps=steps,
        nsteps=nsteps,
    )


def fused_sparse_conv_reference(x: torch.Tensor, plan: FusedSparseConv) -> torch.Tensor:
    """Plain version: for each out-block, gather its support channels,
    rebuild the dense (bm, S*bk, k, k) weight from ``vals`` and run
    ``F.conv2d`` in f32 on the upcast operands (x first cast to the vals
    dtype, as the kernel does).  NHWC in, f32 NHWC out."""
    k, S, bk, bm = plan.kernel, plan.s, plan.bk, plan.bm
    pad = plan.dilation * (k - 1) // 2
    xin = x.to(plan.vals.dtype).float()
    rows = plan.rows.to(device=x.device, dtype=torch.int64)
    chan = (rows[:, :, None] * bk + torch.arange(bk, device=x.device)).reshape(rows.shape[0], -1)
    outs = []
    for jb in range(plan.cout // bm):
        xg = xin.index_select(3, chan[jb]).permute(0, 3, 1, 2)
        wj = plan.vals[jb].float().reshape(k, k, S * bk, bm).permute(3, 2, 0, 1)
        outs.append(F.conv2d(xg, wj, None, 1, pad, plan.dilation))
    return torch.cat(outs, dim=1).permute(0, 2, 3, 1).contiguous()


def _check(x: torch.Tensor, plan: FusedSparseConv) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if plan.vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"plan vals must be float32 or bfloat16, got {plan.vals.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous")
    if x.shape[3] != plan.cin:
        raise ValueError(f"x has {x.shape[3]} channels, the plan {plan.cin}")
    nmb, T = plan.cout // plan.bm, plan.kernel * plan.kernel
    _check_packing(plan, nmb, T, x.device)
    if plan.kernel % 2 == 0:
        raise ValueError(f"'same' padding needs an odd kernel, got {plan.kernel}")
    if max(x.shape) > 2**31 - 1:
        # the kernel takes C ints; it checks its own grid and shared-memory
        # limits and returns an error the wrapper raises
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's int sizes")


def _check_packing(p, nmb: int, T: int, device) -> None:
    """A B2-layout packing (``FusedSparseConv`` or ``XwBsr``) on ``device``
    whose tensors match its geometry."""
    tensors = (p.vals, p.rows, p.steps, p.nsteps)
    if any(t.device != device for t in tensors):
        raise ValueError(f"plan on {p.vals.device}, x on {device}")
    if (tuple(p.vals.shape) != (nmb, T * p.s * p.bk, p.bm)
            or tuple(p.rows.shape) != (nmb, p.s) or tuple(p.steps.shape) != (nmb, T * p.s)
            or tuple(p.nsteps.shape) != (nmb,)
            or any(t.dtype != torch.int32 for t in tensors[1:])
            or not all(t.is_contiguous() for t in tensors)):
        raise ValueError("plan tensors do not match its geometry (contiguous vals "
                         f"{(nmb, T * p.s * p.bk, p.bm)}, int32 rows {(nmb, p.s)}, steps "
                         f"{(nmb, T * p.s)} and nsteps {(nmb,)})")


B2_TILE_PIXELS = 256  # output pixels of one tile of B2's bf16 path (kTileM)


def b2_tile_rows(w: int, h: int) -> int:
    """Image rows R of one tile of B2's bf16 path on a map ``w`` pixels wide
    and ``h`` rows high: 1 when w >= 256 (a tile is a 256-pixel segment of
    one row), else floor(256 / w) whole rows, so a narrow map fills the
    tile, and never more rows than the map has (a classifier's 4x4 map
    takes R = 4, not 64: no x box reaches past the map's last row)."""
    if w < 1 or h < 1:
        raise ValueError(f"map sides must be positive, got w={w}, h={h}")
    return min(max(1, B2_TILE_PIXELS // w), h)


def _launch_b2(x: torch.Tensor, p, kernel: int, dilation: int, cout: int,
               bias: torch.Tensor | None = None, bf16_out: bool = False,
               rows_per_tile: int | None = None) -> torch.Tensor:
    """One launch of kernel B2 (``csrc/sparse_conv.cu``) on NHWC-contiguous
    CUDA ``x`` and the packing ``p`` (``vals``, ``rows``, ``steps``,
    ``nsteps``, ``s``), whose operands the caller has checked: casts x to
    the vals dtype, launches on the current stream and raises if the launch
    fails.  Returns the f32 (N, H, W, cout) output, or with ``bf16_out``
    (bf16 plans) the bf16 ``bf16(float(bf16(y)) + float(bias))``.  The
    tile's rows are ``b2_tile_rows(W, H)`` unless ``rows_per_tile`` names
    them; the kernel rejects R < 1, or R > 1 with R * W > 256, and this
    raises."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    from tpuseg_torch.ops._build import load_library

    x = x.to(p.vals.dtype)
    n, h, w, cin = x.shape
    out = torch.empty((n, h, w, cout), dtype=torch.bfloat16 if bf16_out else torch.float32,
                      device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpuseg_sparse_conv(
            x.data_ptr(), p.vals.data_ptr(), p.rows.data_ptr(), p.steps.data_ptr(),
            p.nsteps.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            n, h, w, cin, cout, p.s, kernel, dilation, _DTYPE_CODE[p.vals.dtype],
            int(bf16_out), b2_tile_rows(w, h) if rows_per_tile is None else rows_per_tile,
            stream,
        )
    _raise_on(lib, "sparse_conv", err)
    return out


def _run_b2(x: torch.Tensor, plan: FusedSparseConv, entry) -> torch.Tensor:
    """B2's function of ``x`` on ``plan`` for the entry point ``entry``: the
    plain version on a CPU tensor; on a CUDA tensor one launch of B2,
    counted in ``entry.launches``."""
    _check(x, plan)
    if x.device.type == "cpu":
        return fused_sparse_conv_reference(x, plan)
    out = _launch_b2(x, plan, plan.kernel, plan.dilation, plan.cout)
    entry.launches += 1
    return out


def fused_sparse_conv_apply(x: torch.Tensor, plan: FusedSparseConv) -> torch.Tensor:
    """Stride-1 'same' block-sparse conv of NHWC-contiguous ``x`` -> f32
    (N, H, W, Cout).

    On a CUDA tensor this casts x to the plan's dtype, launches the CUDA
    kernel on the current stream, counts the launch in
    ``fused_sparse_conv_apply.launches`` and raises if the launch fails; on
    a CPU tensor it runs ``fused_sparse_conv_reference``.  Nothing falls
    back: A/B checks call ``fused_sparse_conv_reference`` by name."""
    return _run_b2(x, plan, fused_sparse_conv_apply)


fused_sparse_conv_apply.launches = 0


def fused_sparse_conv_bias_bf16_reference(x: torch.Tensor, plan: FusedSparseConv,
                                          bias: torch.Tensor | None) -> torch.Tensor:
    """Plain version of the served bf16 route: the two passes it replaces
    (``models/drn.py``, ``tpuseg``'s cast-then-bias order), B2's f32 output
    cast to bf16, then the bf16 bias added in bf16."""
    return cast_bias_bf16(fused_sparse_conv_reference(x, plan), bias)


def fused_sparse_conv_bias_bf16(x: torch.Tensor, plan: FusedSparseConv,
                                bias: torch.Tensor | None) -> torch.Tensor:
    """The served bf16 route of a bf16 plan: ``bf16(float(bf16(y)) +
    float(bias_bf16))`` (N, H, W, Cout) bf16, y = B2's f32 function of
    ``x``, each step rounded to nearest even; no add without a bias.

    On a CUDA tensor one launch of B2 writes it (half the bytes of the f32
    y, and no cast-and-bias pass), counted in
    ``fused_sparse_conv_apply.launches``; on a CPU tensor it runs
    ``fused_sparse_conv_bias_bf16_reference``.  ``models/drn.py`` takes
    this route for bf16 serving; every public entry point returns f32."""
    _check(x, plan)
    if plan.vals.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 route needs a bf16 plan, got {plan.vals.dtype}")
    if bias is not None and (bias.dim() != 1 or bias.shape[0] != plan.cout):
        raise ValueError(f"bias must be ({plan.cout},), got {tuple(bias.shape)}")
    if x.device.type == "cpu":
        return fused_sparse_conv_bias_bf16_reference(x, plan, bias)
    b = None if bias is None else bias.to(device=x.device, dtype=torch.bfloat16).contiguous()
    out = _launch_b2(x, plan, plan.kernel, plan.dilation, plan.cout, bias=b, bf16_out=True)
    fused_sparse_conv_apply.launches += 1
    return out


# ---------------------------------------------------------------------------
# XwBsr and kernel B4: y (P, M) = x (P, K) @ W, W column-block sparse
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class XwBsr:
    """Column-block-sparse weight for ``y = x @ W`` (W: (K, M)); ``tpuseg``'s
    ``XwBsr``.  Its layout is a ``FusedSparseConv``'s with one tap: for
    out-block j, ``rows[j]`` lists the S in-blocks with a nonzero (padded
    with block 0 and zero tiles) and ``vals[j, s*bk + c, m]`` is
    ``W[rows[j, s]*bk + c, j*bm + m]``."""

    vals: torch.Tensor  # (nmb, S*bk, bm), the plan dtype
    rows: torch.Tensor  # (nmb, S) int32
    shape: tuple[int, int]  # (K, M)
    bk: int
    bm: int
    s: int
    block_density: float
    steps: torch.Tensor  # (nmb, S) int32: the live slots per out-block, in order
    nsteps: torch.Tensor  # (nmb,) int32

    def to(self, device) -> "XwBsr":
        """The packing with its tensors on ``device`` (dtypes unchanged)."""
        return dataclasses.replace(self, vals=self.vals.to(device), rows=self.rows.to(device),
                                   steps=self.steps.to(device), nsteps=self.nsteps.to(device))


def pack_xw_bsr(w_km: np.ndarray, dtype: torch.dtype = torch.bfloat16) -> XwBsr:
    """Pack a masked (K, M) weight: for each 128-column block, the 128-row
    blocks with any nonzero, padded to the densest column block's count
    (S >= 1); ``tpuseg``'s numpy, so ``vals``/``rows`` equal its bytes."""
    w_km = np.asarray(w_km, np.float32)
    K, M = w_km.shape
    bk, bm = BK, BM
    if K % bk or M % bm:
        raise ValueError(f"W {w_km.shape} is not a grid of {bk}x{bm} blocks")
    nkb, nmb = K // bk, M // bm
    blocks = w_km.reshape(nkb, bk, nmb, bm)
    nz = np.abs(blocks).sum(axis=(1, 3)) > 0  # (nkb, nmb)
    S = max(int(nz.sum(axis=0).max()), 1)
    vals = np.zeros((nmb, S, bk, bm), np.float32)
    rows = np.zeros((nmb, S), np.int32)
    live = np.zeros((nmb, S), bool)
    for j in range(nmb):
        for s_i, k in enumerate(np.flatnonzero(nz[:, j])):
            vals[j, s_i] = blocks[k, :, j, :]
            rows[j, s_i] = k
            live[j, s_i] = True
    steps, nsteps = _step_list(live)
    return XwBsr(vals=torch.from_numpy(vals.reshape(nmb, S * bk, bm)).to(dtype),
                 rows=torch.from_numpy(rows), shape=(K, M), bk=bk, bm=bm, s=S,
                 block_density=float(nz.mean()), steps=steps, nsteps=nsteps)


def xw_dense(w: XwBsr) -> torch.Tensor:
    """The dense (K, M) f32 weight a packing holds (padded slots add 0)."""
    K, M = w.shape
    dense = torch.zeros((K, M), dtype=torch.float32, device=w.vals.device)
    vals = w.vals.float().reshape(M // w.bm, w.s, w.bk, w.bm)
    for j, blocks in enumerate(w.rows.tolist()):
        for s_i, kb in enumerate(blocks):
            dense[kb * w.bk:(kb + 1) * w.bk, j * w.bm:(j + 1) * w.bm] += vals[j, s_i]
    return dense


def bsr_matmul_xw_reference(x: torch.Tensor, w: XwBsr) -> torch.Tensor:
    """Plain version of B4: ``x @ W`` with the dense W rebuilt from the
    packing, in f32 on the upcast operands (x first cast to the vals dtype,
    as the kernel does)."""
    return x.to(w.vals.dtype).float() @ xw_dense(w)


def bsr_matmul_xw(x: torch.Tensor, w: XwBsr) -> torch.Tensor:
    """y (P, M) = x (P, K) @ W_sparse (K, M), f32; ``tpuseg``'s
    ``bsr_matmul_xw`` (kernel B4) without its ``bp`` tile: any P.

    ``XwBsr`` is B2's packing at k = 1, so on a CUDA tensor this views x as
    one image row of P pixels, (1, 1, P, K), and launches B2's kernel with
    k = d = 1 (its row segments then run along P), counted in
    ``bsr_matmul_xw.launches``; on a CPU tensor it runs
    ``bsr_matmul_xw_reference``."""
    if x.dim() != 2:
        raise ValueError(f"x must be (P, K), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or w.vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"x and vals must be float32 or bfloat16, got {x.dtype}, {w.vals.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (P, K)")
    K, M = w.shape
    nmb = M // w.bm
    if x.shape[1] != K:
        raise ValueError(f"x has K={x.shape[1]}, the packing {K}")
    if (w.bk, w.bm) != (BK, BM):
        raise ValueError(f"packing blocks {(w.bk, w.bm)}, the kernel's {(BK, BM)}")
    _check_packing(w, nmb, 1, x.device)
    if x.shape[0] > 2**31 - 1:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's int sizes")
    if x.device.type == "cpu":
        return bsr_matmul_xw_reference(x, w)
    out = _launch_b2(x.view(1, 1, x.shape[0], K), w, 1, 1, M)
    bsr_matmul_xw.launches += 1
    return out.view(x.shape[0], M)


bsr_matmul_xw.launches = 0


@dataclasses.dataclass
class SparseConvPlan:
    """Per-tap lowering of a stride-1 conv: ``taps`` holds ``(p, q, packed,
    dense)``, where ``packed`` is the tap's ``XwBsr`` and ``dense`` records
    ``tpuseg``'s choice of its dense path for that tap.  Both run B4 on
    ``packed``: a tap that dense has (nearly) every block in its packing,
    and B4's f32 sum is the dense path's ``preferred_element_type=f32``."""

    taps: list
    kernel: int
    dilation: int
    cin: int
    cout: int
    density: float  # mean coarsened block density across taps

    def to(self, device) -> "SparseConvPlan":
        return dataclasses.replace(
            self, taps=[(p, q, w.to(device), d) for p, q, w, d in self.taps])


def plan_sparse_conv(
    w_oihw,
    mask_oihw,
    dense_threshold: float = 0.9,
    dtype: torch.dtype = torch.bfloat16,
) -> SparseConvPlan:
    """Per-tap sparse/dense lowerings of a masked OIHW weight, ``tpuseg``'s
    ``plan_sparse_conv``: a tap whose block density reaches
    ``dense_threshold`` is marked dense.  Channels must be multiples of 128
    (B4's blocks)."""
    wm = oihw_to_hwio_np(w_oihw) * oihw_to_hwio_np(mask_oihw)
    kh, kw, cin, cout = wm.shape
    if cin % BK or cout % BM:
        raise ValueError(f"conv {cin}->{cout}: B4 needs channels divisible by {BK}")
    taps, densities = [], []
    for p in range(kh):
        for q in range(kw):
            packed = pack_xw_bsr(wm[p, q], dtype)
            densities.append(packed.block_density)
            taps.append((p, q, packed, packed.block_density >= dense_threshold))
    return SparseConvPlan(taps=taps, kernel=kh, dilation=1, cin=cin, cout=cout,
                          density=float(np.mean(densities)))


def _per_tap(x: torch.Tensor, plan: SparseConvPlan, dilation: int, matmul) -> torch.Tensor:
    n, h, w_, cin = x.shape
    pad = dilation * (plan.kernel - 1) // 2
    xp = F.pad(x.to(plan.taps[0][2].vals.dtype), (0, 0, pad, pad, pad, pad))
    y = None
    for p, q, wt, _dense in plan.taps:
        dy, dx = p * dilation, q * dilation
        t = matmul(xp[:, dy:dy + h, dx:dx + w_].reshape(n * h * w_, cin), wt)
        y = t if y is None else y.add_(t)
    return y.view(n, h, w_, plan.cout)


def sparse_conv_apply(x: torch.Tensor, plan: SparseConvPlan, dilation: int = 1) -> torch.Tensor:
    """Stride-1 'same' conv of NHWC ``x`` with per-tap block-sparse matmuls,
    ``tpuseg``'s ``sparse_conv_apply`` (padding = dilation*(k-1)/2): one
    ``bsr_matmul_xw`` (B4) per tap on the tap's shifted copy of x, dense
    or sparse, summed in f32 in tap order.  -> f32 (N, H, W, Cout)."""
    return _per_tap(x, plan, dilation, bsr_matmul_xw)


def sparse_conv_reference(x: torch.Tensor, plan: SparseConvPlan, dilation: int = 1) -> torch.Tensor:
    """Plain version of ``sparse_conv_apply``: the same taps through
    ``bsr_matmul_xw_reference``, on any device."""
    return _per_tap(x, plan, dilation, bsr_matmul_xw_reference)


# ---------------------------------------------------------------------------
# The round-3 conv variants (B7a-f): B2's function on two packings
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SharedFusedSparseConv(FusedSparseConv):
    """``tpuseg``'s shared-union packing: ONE K-support for the whole layer
    (the union over taps and out-blocks), ``union_rows`` (``tpuseg``'s tuple
    ``rows``), with ``vals`` in B2's layout on it.  ``rows`` is that support
    broadcast to a contiguous (nmb, S) int32 tensor, so the packing is the
    operand B2's kernel takes."""

    union_rows: tuple  # (S,) python ints: global union K-block ids

    @property
    def union_density(self) -> float:
        return self.block_density


def plan_shared_sparse_conv(
    w_oihw,
    mask_oihw,
    dilation: int = 1,
    dtype: torch.dtype = torch.bfloat16,
) -> SharedFusedSparseConv:
    """Pack a masked stride-1 conv (OIHW weight and mask) on its global
    union support: ``tpuseg``'s numpy on the HWIO view, so ``vals`` and
    ``union_rows`` equal its ``vals``/``rows``."""
    wm = oihw_to_hwio_np(w_oihw) * oihw_to_hwio_np(mask_oihw)
    kh, kw, cin, cout = wm.shape
    bk, bm = BK, BM
    if cin % bk or cout % bm:
        raise ValueError(f"conv {cin}->{cout}: channels must be divisible by {bk}")
    nkb, nmb = cin // bk, cout // bm
    T = kh * kw
    nz = np.zeros((T, nkb, nmb), bool)
    for t in range(T):
        p, q = divmod(t, kw)
        nz[t] = np.abs(wm[p, q].reshape(nkb, bk, nmb, bm)).sum(axis=(1, 3)) > 0
    union = nz.any(axis=(0, 2))  # (nkb,)
    rows = tuple(int(k) for k in np.flatnonzero(union)) or (0,)
    S = len(rows)
    vals = np.zeros((nmb, T, S, bk, bm), np.float32)
    live = np.zeros((nmb, T, S), bool)
    for j in range(nmb):
        for t in range(T):
            p, q = divmod(t, kw)
            for s_i, k in enumerate(rows):
                if nz[t, k, j]:
                    vals[j, t, s_i] = wm[p, q][k * bk:(k + 1) * bk, j * bm:(j + 1) * bm]
                    live[j, t, s_i] = True
    steps, nsteps = _step_list(live.reshape(nmb, T * S))
    taps = np.array([(p * dilation, q * dilation) for p in range(kh) for q in range(kw)],
                    np.int32)
    return SharedFusedSparseConv(
        vals=torch.from_numpy(vals.reshape(nmb, T * S * bk, bm)).to(dtype),
        rows=torch.tensor(rows, dtype=torch.int32).expand(nmb, S).contiguous(),
        taps=taps, s=S, bk=bk, bm=bm, kernel=kh, dilation=dilation, cin=cin, cout=cout,
        block_density=S / nkb, union_rows=rows, steps=steps, nsteps=nsteps)


# tpuseg's six round-3 kernels compute B2's function under six sets of TPU
# VMEM/DMA workarounds (xmat concat, phase pre-shift, im2col DMA, aligned
# concat, out_split); none carries over, so each entry point is B2's kernel
# on the packing it takes, with its own launch count.  Their rows_per_tile,
# out_split and w % 8 constraints go with the workarounds.


def shared_sparse_conv_apply(x: torch.Tensor, plan: SharedFusedSparseConv) -> torch.Tensor:
    """B7a, ``tpuseg``'s ``shared_sparse_conv_apply``
    (``tpuseg/ops/sparse_conv.py:450``): B2 on the shared-union packing."""
    return _run_b2(x, plan, shared_sparse_conv_apply)


shared_sparse_conv_apply.launches = 0


def fused_phase_sparse_conv_apply(x: torch.Tensor, plan: FusedSparseConv) -> torch.Tensor:
    """B7b, ``tpuseg``'s ``fused_phase_sparse_conv_apply``
    (``tpuseg/ops/sparse_conv.py:555``): B2 on B2's packing."""
    return _run_b2(x, plan, fused_phase_sparse_conv_apply)


fused_phase_sparse_conv_apply.launches = 0


def imcol_phase_sparse_conv_apply(x: torch.Tensor, plan: FusedSparseConv) -> torch.Tensor:
    """B7c, ``tpuseg``'s ``imcol_phase_sparse_conv_apply``
    (``tpuseg/ops/sparse_conv.py:684``): B2 on B2's packing."""
    return _run_b2(x, plan, imcol_phase_sparse_conv_apply)


imcol_phase_sparse_conv_apply.launches = 0


def cphase_sparse_conv_apply(x: torch.Tensor, plan: FusedSparseConv) -> torch.Tensor:
    """B7d, ``tpuseg``'s ``cphase_sparse_conv_apply``
    (``tpuseg/ops/sparse_conv.py:826``): B2 on B2's packing."""
    return _run_b2(x, plan, cphase_sparse_conv_apply)


cphase_sparse_conv_apply.launches = 0


def phase_sparse_conv_apply(x: torch.Tensor, plan: SharedFusedSparseConv) -> torch.Tensor:
    """B7e, ``tpuseg``'s ``phase_sparse_conv_apply``
    (``tpuseg/ops/sparse_conv.py:952``): B2 on the shared-union packing."""
    return _run_b2(x, plan, phase_sparse_conv_apply)


phase_sparse_conv_apply.launches = 0


def shared_concat_sparse_conv_apply(x: torch.Tensor,
                                    plan: SharedFusedSparseConv) -> torch.Tensor:
    """B7f, ``tpuseg``'s ``shared_concat_sparse_conv_apply``
    (``tpuseg/ops/sparse_conv.py:1091``): B2 on the shared-union packing."""
    return _run_b2(x, plan, shared_concat_sparse_conv_apply)


shared_concat_sparse_conv_apply.launches = 0


# ---------------------------------------------------------------------------
# Int8: FusedSparseConvQ and kernel B3
# ---------------------------------------------------------------------------

QMAX = 127  # symmetric int8 range [-127, 127]


@dataclasses.dataclass
class FusedSparseConvQ:
    """Int8 packing of a ``FusedSparseConv``: ``vals``/``w_scale``/``rows``
    are ``tpuseg``'s arrays value for value.  Derived from ``vals`` when the
    plan is made: ``vals_k``, the kernel's K-major copy (int8 tensor-core
    MMA takes both operands K-major), and ``steps``/``nsteps``, the live
    steps of the nonzero int8 tiles (``FusedSparseConv``'s layout; a tile
    whose weights all quantize to 0 is not live)."""

    vals: torch.Tensor     # (nmb, T*S*bk, bm) int8
    w_scale: torch.Tensor  # (nmb, 1, bm) f32 per-output-channel
    rows: torch.Tensor     # (nmb, S) int32
    taps: np.ndarray
    s: int
    bk: int
    bm: int
    kernel: int
    dilation: int
    cin: int
    cout: int
    block_density: float
    x_scale: float | None = None  # static activation scale; None = per frame
    vals_k: torch.Tensor | None = None  # (nmb, T*S, bm, bk) int8: vals per tile, transposed
    steps: torch.Tensor | None = None   # (nmb, T*S) int32
    nsteps: torch.Tensor | None = None  # (nmb,) int32

    def __post_init__(self):
        nmb, tsk, bm = self.vals.shape
        tiles = self.vals.reshape(nmb, tsk // self.bk, self.bk, bm)
        if self.vals_k is None:
            self.vals_k = tiles.transpose(2, 3).contiguous()
        if self.steps is None:
            live = (tiles != 0).any(3).any(2).cpu().numpy()
            self.steps, self.nsteps = _step_list(live)

    def to(self, device) -> "FusedSparseConvQ":
        """The plan with its tensors on ``device`` (dtypes unchanged)."""
        return dataclasses.replace(
            self, vals=self.vals.to(device), w_scale=self.w_scale.to(device),
            rows=self.rows.to(device), vals_k=self.vals_k.to(device),
            steps=self.steps.to(device), nsteps=self.nsteps.to(device))


def quantize_fused_plan(plan: FusedSparseConv, x_scale: float | None = None) -> FusedSparseConvQ:
    """Quantize a packed plan to int8 with per-output-channel scales over
    the packed values: ``tpuseg``'s numpy on the plan's values as f32, so
    ``vals``/``w_scale`` equal ``tpuseg``'s bit for bit."""
    vals = plan.vals.detach().cpu().float().numpy()  # (nmb, TSbk, bm)
    absmax = np.abs(vals).max(axis=1, keepdims=True)  # (nmb, 1, bm)
    scale = np.maximum(absmax, 1e-8) / 127.0
    vq = np.clip(np.round(vals / scale), -QMAX, QMAX).astype(np.int8)
    return FusedSparseConvQ(
        vals=torch.from_numpy(vq),
        w_scale=torch.from_numpy(scale.astype(np.float32)),
        rows=plan.rows.detach().cpu(),
        taps=plan.taps,
        s=plan.s,
        bk=plan.bk,
        bm=plan.bm,
        kernel=plan.kernel,
        dilation=plan.dilation,
        cin=plan.cin,
        cout=plan.cout,
        block_density=plan.block_density,
        x_scale=x_scale,
    )


def select_channels(x: torch.Tensor, chan: torch.Tensor | None) -> torch.Tensor:
    """``x.index_select(-1, chan)`` where a negative entry of ``chan``
    gives a channel of zeros: the plain version of the quantize kernels'
    channel map (``chan=None``: x itself)."""
    if chan is None:
        return x
    chan = chan.to(device=x.device, dtype=torch.int64)
    return x.index_select(x.dim() - 1, chan.clamp_min(0)).masked_fill_(chan < 0, 0)


def quantize_activation_reference(x: torch.Tensor,
                                  x_scale: float | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``quantize_activation``: ``tpuseg``'s ops in its
    order.  Dynamic (``x_scale`` None): ``xs = max(max|x| over all but the
    batch axis, 1e-8) / 127``; static: ``x_scale`` rounded to f32 for every
    frame.  Then ``xq = clip(round(x / xs), -127, 127)`` with round half to
    even.  Both divisions are true divisions by a tensor: PyTorch multiplies
    by the reciprocal when the divisor is a Python scalar, which can differ
    in the last bit.  The absmax is the inf-norm (exact in any float dtype;
    a NaN gives a NaN scale) and the division promotes a bf16 x to f32 as it
    reads it (exact)."""
    n = x.shape[0]
    if x_scale is None:
        absmax = torch.linalg.vector_norm(x.reshape(n, -1), ord=float("inf"), dim=1).float()
        xs = absmax.clamp_min(1e-8) / torch.full_like(absmax, 127.0)
    else:
        xs = torch.full((n,), x_scale, dtype=torch.float32, device=x.device)
    q = torch.div(x, xs.view((n,) + (1,) * (x.dim() - 1)))  # f32: xs is f32
    return q.round_().clamp_(-QMAX, QMAX).to(torch.int8), xs


def quantize_activation(x: torch.Tensor, x_scale: float | None,
                        chan: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(xq, xs)``: int8 ``xq`` of x's shape and the (N,) f32 per-frame
    scales, ``tpuseg``'s x quantization (``quantize_activation_reference``).
    With ``chan`` (an int32 index of x's last axis) it quantizes
    ``x.index_select(-1, chan)``, the scale taken over those channels, as
    ``tpuseg``'s ``CompactSparseQ`` does after its gather; a negative entry
    of ``chan`` reads as 0 (``select_channels``), which pads x's channels
    in the same pass (the int8 stem's conv0).

    On a CPU tensor this runs the plain version.  On a CUDA tensor (bf16 or
    f32, contiguous, channels last) it launches the hand-written kernels of
    ``tpuseg_torch/csrc/quantize.cu`` on the current stream: per-frame
    absmax (dynamic scale only, counted in ``quantize_activation.
    absmax_launches``), then one pass that reads x (through ``chan``: the
    gathered copy is never made) and writes xq and xs (counted in
    ``quantize_activation.launches``); it raises if a launch fails."""
    if x.device.type == "cpu":
        return quantize_activation_reference(select_channels(x, chan), x_scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (N, ..., C), got {tuple(x.shape)}")
    n, cx = x.shape[0], x.shape[-1]
    cq = cx if chan is None else chan.numel()
    if chan is not None and (chan.dtype != torch.int32 or chan.dim() != 1
                             or not chan.is_contiguous() or chan.device != x.device):
        raise ValueError("chan must be a contiguous 1-D int32 tensor on x's device")
    if cq % 8 or (chan is None and cx % 8):
        raise ValueError(f"the quantize kernels take channel counts divisible by 8, got {cq}")
    from tpuseg_torch.ops._build import load_library

    pixels = x[0, ..., 0].numel()
    xq = torch.empty(x.shape[:-1] + (cq,), dtype=torch.int8, device=x.device)
    xs = torch.empty((n,), dtype=torch.float32, device=x.device)
    absmax = None if x_scale is not None else torch.zeros((n,), dtype=torch.int32,
                                                          device=x.device)
    lib = load_library()
    cptr = None if chan is None else chan.data_ptr()
    shape = (n, pixels, cx, cq, _DTYPE_CODE[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if absmax is not None:
            _raise_on(lib, "absmax", lib.tpuseg_absmax(x.data_ptr(), cptr, absmax.data_ptr(),
                                                      *shape, stream))
            quantize_activation.absmax_launches += 1
        _raise_on(lib, "quantize", lib.tpuseg_quantize(
            x.data_ptr(), cptr, None if absmax is None else absmax.data_ptr(),
            0.0 if x_scale is None else float(x_scale), xq.data_ptr(), xs.data_ptr(), *shape,
            stream))
    quantize_activation.launches += 1
    return xq, xs


quantize_activation.launches = 0
quantize_activation.absmax_launches = 0


def int_conv_exact(xq: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """Stride-1 'same' conv of int8 NHWC ``xq`` with an integer-valued HWIO
    weight, in float64: one matmul per tap over the padded input.  Every
    partial sum is an integer below 2**53, so the result is exact whatever
    the summation order.  Returns f64 (N, H, W, O)."""
    kh, kw = w.shape[:2]
    pad = dilation * (kh - 1) // 2
    n, h, wd, _ = xq.shape
    xp = F.pad(xq.to(torch.float64), (0, 0, pad, pad, pad, pad))
    w = w.to(device=xq.device, dtype=torch.float64)
    acc = None
    for p in range(kh):
        for q in range(kw):
            tap = xp[:, p * dilation:p * dilation + h, q * dilation:q * dilation + wd] @ w[p, q]
            acc = tap if acc is None else acc.add_(tap)
    return acc


def dequantize(acc: torch.Tensor, xs: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """``tpuseg``'s epilogue: ``float32(acc) * (xs[n] * w_scale[o])``, the
    scale product rounded to f32 first.  ``acc`` is an exact integer, so its
    f32 rounding equals the kernel's int32 -> f32 conversion."""
    n = xs.shape[0]
    return acc.to(torch.float32) * (xs.view(n, 1, 1, 1) * w_scale.reshape(1, 1, 1, -1))


def fused_sparse_conv_q_reference(x: torch.Tensor, plan: FusedSparseConvQ) -> torch.Tensor:
    """Plain version of B3: quantize x (``quantize_activation_reference``),
    rebuild the dense HWIO int8 weight from ``vals``/``rows`` (padded slots
    add zeros), compute the integer conv exactly (``int_conv_exact``), apply
    the epilogue.  NHWC in, f32 out."""
    xq, xs = quantize_activation_reference(x, plan.x_scale)
    k, S, bk, bm = plan.kernel, plan.s, plan.bk, plan.bm
    nmb = plan.cout // bm
    vals = plan.vals.to(torch.float64).reshape(nmb, k, k, S, bk, bm)
    w = torch.zeros((k, k, plan.cin, plan.cout), dtype=torch.float64, device=vals.device)
    for jb, blocks in enumerate(plan.rows.tolist()):
        for s_i, kb in enumerate(blocks):
            w[:, :, kb * bk:(kb + 1) * bk, jb * bm:(jb + 1) * bm] += vals[jb, :, :, s_i]
    return dequantize(int_conv_exact(xq, w, plan.dilation), xs, plan.w_scale)


def cast_bias_bf16(y: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """``tpuseg``'s served order after a sparse or int8 conv: its f32 output
    cast to bf16, then the bias added in bf16 (no add without a bias).  The
    plain version of every bf16+bias route."""
    y = y.to(torch.bfloat16)
    return y if bias is None else y + bias.to(device=y.device, dtype=torch.bfloat16)


def _check_q(x: torch.Tensor, plan: FusedSparseConvQ, chan: torch.Tensor | None) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous")
    cin = x.shape[3] if chan is None else chan.numel()
    if cin != plan.cin:
        raise ValueError(f"x has {cin} channels, the plan {plan.cin}")
    tensors = (plan.vals, plan.vals_k, plan.rows, plan.w_scale, plan.steps, plan.nsteps)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"plan on {plan.vals.device}, x on {x.device}")
    nmb, T, S = plan.cout // plan.bm, plan.kernel * plan.kernel, plan.s
    if (plan.vals.dtype != torch.int8 or plan.vals_k.dtype != torch.int8
            or plan.rows.dtype != torch.int32 or plan.w_scale.dtype != torch.float32
            or plan.steps.dtype != torch.int32 or plan.nsteps.dtype != torch.int32
            or tuple(plan.vals.shape) != (nmb, T * S * plan.bk, plan.bm)
            or tuple(plan.vals_k.shape) != (nmb, T * S, plan.bm, plan.bk)
            or tuple(plan.rows.shape) != (nmb, S)
            or tuple(plan.w_scale.shape) != (nmb, 1, plan.bm)
            or tuple(plan.steps.shape) != (nmb, T * S) or tuple(plan.nsteps.shape) != (nmb,)
            or not all(t.is_contiguous() for t in tensors)):
        raise ValueError("int8 plan does not match its geometry (contiguous int8 vals "
                         f"{(nmb, T * S * plan.bk, plan.bm)}, vals_k "
                         f"{(nmb, T * S, plan.bm, plan.bk)}, int32 rows {(nmb, S)}, steps "
                         f"{(nmb, T * S)} and nsteps {(nmb,)}, f32 w_scale {(nmb, 1, plan.bm)})")
    if plan.kernel % 2 == 0:
        raise ValueError(f"'same' padding needs an odd kernel, got {plan.kernel}")
    if QMAX * QMAX * T * S * plan.bk >= 2**31:
        raise ValueError(f"k={plan.kernel}, S={S}: the int32 sum could overflow")
    if max(x.shape) > 2**31 - 1:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's int sizes")


def _launch_b3(xq: torch.Tensor, xs: torch.Tensor, plan: FusedSparseConvQ,
               bias: torch.Tensor | None, bf16_out: bool, relu: bool = False) -> torch.Tensor:
    """One launch of kernel B3 (``csrc/sparse_conv_q.cu``) on int8 NHWC
    ``xq`` and its (N,) scales ``xs``, checked by the caller: the f32 y, or
    with ``bf16_out`` the bf16 ``bf16(float(bf16(y)) + float(bias))`` (bias
    bf16); with ``relu`` ``relu(y + bias)`` (bias f32) as f32, or rounded
    to bf16 with ``bf16_out``."""
    from tpuseg_torch.ops._build import load_library

    n, h, w, cin = xq.shape
    out = torch.empty((n, h, w, plan.cout), dtype=torch.bfloat16 if bf16_out else torch.float32,
                      device=xq.device)
    lib = load_library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.tpuseg_sparse_conv_q(
            xq.data_ptr(), plan.vals_k.data_ptr(), plan.rows.data_ptr(), plan.steps.data_ptr(),
            plan.nsteps.data_ptr(), plan.w_scale.data_ptr(), xs.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            n, h, w, cin, plan.cout, plan.s, plan.kernel, plan.dilation,
            2 * int(relu) + int(bf16_out), stream,
        )
    _raise_on(lib, "sparse_conv_q", err)
    return out


def _b3_cuda(x: torch.Tensor, plan: FusedSparseConvQ, chan: torch.Tensor | None,
             bias: torch.Tensor | None, bf16_out: bool) -> torch.Tensor:
    """The CUDA half of every B3 entry point: quantize x through ``chan``
    (``quantize_activation``'s kernels), then one B3 launch."""
    xq, xs = quantize_activation(x, plan.x_scale, chan)
    return _launch_b3(xq, xs, plan, bias, bf16_out)


def fused_sparse_conv_apply_q(x: torch.Tensor, plan: FusedSparseConvQ,
                              chan: torch.Tensor | None = None) -> torch.Tensor:
    """Int8 stride-1 'same' block-sparse conv of NHWC-contiguous float ``x``
    -> f32 (N, H, W, Cout); with ``chan`` (int32) the conv of
    ``select_channels(x, chan)`` (a -1 entry reads zeros), quantized over
    those channels.

    On a CUDA tensor this quantizes x (``quantize_activation``'s kernels),
    launches B3 on the current stream, counts the launch in
    ``fused_sparse_conv_apply_q.launches`` and raises if a launch fails; on
    a CPU tensor it runs ``fused_sparse_conv_q_reference``.  Nothing falls
    back: A/B checks call the plain version by name."""
    _check_q(x, plan, chan)
    if x.device.type == "cpu":
        return fused_sparse_conv_q_reference(select_channels(x, chan), plan)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _b3_cuda(x, plan, chan, None, False)
    fused_sparse_conv_apply_q.launches += 1
    return out


fused_sparse_conv_apply_q.launches = 0


def fused_sparse_conv_q_bias_bf16_reference(x: torch.Tensor, plan: FusedSparseConvQ,
                                            bias: torch.Tensor | None) -> torch.Tensor:
    """Plain version of the served int8 bf16 route: B3's f32 output cast to
    bf16, then the bf16 bias added (``cast_bias_bf16``)."""
    return cast_bias_bf16(fused_sparse_conv_q_reference(x, plan), bias)


def fused_sparse_conv_q_bias_bf16(x: torch.Tensor, plan: FusedSparseConvQ,
                                  bias: torch.Tensor | None,
                                  chan: torch.Tensor | None = None) -> torch.Tensor:
    """The served bf16 route of an int8 plan: ``bf16(float(bf16(y)) +
    float(bias_bf16))`` (N, H, W, Cout) bf16, y = B3's f32 function of
    ``x`` (through ``chan``, as ``fused_sparse_conv_apply_q``), each step
    rounded to nearest even; no add without a bias.

    On a CUDA tensor the quantize kernels and one B3 launch write it (half
    the bytes of the f32 y, and no cast-and-bias pass), counted in
    ``fused_sparse_conv_apply_q.launches``; on a CPU tensor it runs
    ``fused_sparse_conv_q_bias_bf16_reference``.  ``models/drn.py`` takes
    this route for every int8 plan in bf16 serving."""
    _check_q(x, plan, chan)
    if bias is not None and (bias.dim() != 1 or bias.shape[0] != plan.cout):
        raise ValueError(f"bias must be ({plan.cout},), got {tuple(bias.shape)}")
    if x.device.type == "cpu":
        return fused_sparse_conv_q_bias_bf16_reference(select_channels(x, chan), plan, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b = None if bias is None else bias.to(device=x.device, dtype=torch.bfloat16).contiguous()
    out = _b3_cuda(x, plan, chan, b, True)
    fused_sparse_conv_apply_q.launches += 1
    return out


def relu_tpuseg(v: torch.Tensor) -> torch.Tensor:
    """``tpuseg``'s ``jax.nn.relu`` = ``jnp.maximum(v, 0)``: -0.0 becomes
    +0.0 and a NaN stays a NaN (``torch.relu`` keeps -0.0)."""
    return torch.where(v <= 0, 0.0, v)


def fused_sparse_conv_q_bias_relu_reference(x: torch.Tensor, plan: FusedSparseConvQ,
                                            bias: torch.Tensor, out_dtype: torch.dtype,
                                            chan: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the int8 stem's route: B3's f32 y
    (``fused_sparse_conv_q_reference`` on ``select_channels(x, chan)``),
    then the f32 bias added and ``relu_tpuseg`` in f32, then one cast to
    ``out_dtype``."""
    y = fused_sparse_conv_q_reference(select_channels(x, chan), plan)
    return relu_tpuseg(y + bias.to(device=y.device, dtype=torch.float32)).to(out_dtype)


def fused_sparse_conv_q_bias_relu(x: torch.Tensor, plan: FusedSparseConvQ, bias: torch.Tensor,
                                  out_dtype: torch.dtype,
                                  chan: torch.Tensor | None = None) -> torch.Tensor:
    """The int8 stem's conv (``tpuseg/ops/polyphase.py:349-359``):
    ``relu(float(acc) * (x_scale * w_scale) + bias)`` in f32, each step
    rounded on its own, cast to ``out_dtype`` (f32 or bf16): (N, H, W, Cout).
    ``bias`` is taken as f32 (a bf16 bias converts exactly); ``chan`` is
    the quantize pass's channel map (-1 pads with zeros).

    On a CUDA tensor the quantize kernels and one B3 launch write it (B3's
    epilogue modes 2 and 3), counted in ``fused_sparse_conv_apply_q.
    launches`` with B3's other routes and in ``fused_sparse_conv_q_bias_relu.
    launches``; on a CPU tensor it runs
    ``fused_sparse_conv_q_bias_relu_reference``."""
    _check_q(x, plan, chan)
    if bias.dim() != 1 or bias.shape[0] != plan.cout:
        raise ValueError(f"bias must be ({plan.cout},), got {tuple(bias.shape)}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if x.device.type == "cpu":
        return fused_sparse_conv_q_bias_relu_reference(x, plan, bias, out_dtype, chan)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b = bias.to(device=x.device, dtype=torch.float32).contiguous()
    xq, xs = quantize_activation(x, plan.x_scale, chan)
    out = _launch_b3(xq, xs, plan, b, out_dtype == torch.bfloat16, relu=True)
    fused_sparse_conv_apply_q.launches += 1
    fused_sparse_conv_q_bias_relu.launches += 1
    return out


fused_sparse_conv_q_bias_relu.launches = 0
