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
  (``tpuseg/ops/polyphase.py:349-359``) on B3's narrow kernel: the same
  launches write ``relu(y + bias)`` in f32, as f32 or rounded once to bf16,
  with ``tpuseg``'s relu (``relu_tpuseg``); its plain version is
  ``fused_sparse_conv_q_bias_relu_reference``.  Under a static scale of the
  next stem conv it hands that conv its int8 x instead (``next_scale``:
  the next conv's quantization of the rounded output, in the epilogue;
  plain version ``fused_sparse_conv_q_bias_relu_int8_out_reference``), and
  it takes such an int8 x with its scales (``xs``; plain version
  ``fused_sparse_conv_q_bias_relu_int8_in_reference``), so no quantize
  pass runs between the stem's convs.
- B3's narrow route (``csrc/sparse_conv_q_narrow.cu``): a ``narrow``
  packing (``ops/quant.py::int8_packing`` of a conv whose channels do not
  divide by 128: the zoo's, the frontend's stage-3 convs; and every int8
  stem conv, which ``stem_packing`` sends there by ``narrow_route``) runs K
  of 32, 64 or 128 channels a step (x padded to whole steps through the
  packing's map) and N of 16-128 a block; ``b3_narrow_tile`` is its tile,
  and ``b3_narrow_instance`` raises on an epilogue it has no instance for.
- ``channel_map_vectors``: a channel map's vector descriptor (contiguous,
  zero or gathered 8-channel vectors), built once with the map, through
  which the quantize kernels read it; ``select_channels_by_vectors`` is its
  plain reader and equals ``select_channels``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models.weights import oihw_to_hwio_np

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BK = BM = 128  # channel block sizes (in, out), the kernel's


def _raw_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as the int a ctypes launch
    takes: the lookup PyTorch's generated kernels launch with
    (``torch.cuda.current_stream(device).cuda_stream`` builds a Stream
    object, microseconds a call, which the small narrow convs feel)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device: a no-op
    where it already is (the usual case, and the cheap one),
    ``torch.cuda.device`` otherwise."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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
    whose weights all quantize to 0 is not live).

    A dense conv's packing (``ops/quant.py::int8_packing``) whose channels
    do not divide by 128 is ``narrow``: full support (``rows`` = 0..S-1),
    ``bk`` in {32, 64, 128} input channels a slot (S = ceil(cin / bk)) and
    ``bm`` in {16, 32, 64, 128} output channels a block (nmb = ceil(cout /
    bm)), zero rows and columns past cin and cout; B3 runs it on its narrow
    route (``csrc/sparse_conv_q_narrow.cu``).  Where cin < S * bk the
    packing carries ``in_chan``, the quantize pass's map of x's channels
    then -1s up to S * bk, and its ``channel_map_vectors`` ``in_vecs``
    (built here, moved by ``to``): on the card x is quantized through it
    into the padded int8 operand (the -1s are zero vectors: nothing is
    read), which B3 reads in whole K-wide steps; the plain version reads
    the unpadded x.  A TMA box wider than x's channels would zero-fill them
    instead, which the H100 runs slower (``PERF.md``).

    ``narrow_route`` sends a packing to the narrow route whatever its
    widths: ``ops/quant.py::stem_packing`` sets it on the int8 stem's
    convs, whose epilogues (relu, the int8 hand-off) only the narrow kernel
    has; B3's served packings keep the 128-wide kernel."""

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
    in_chan: torch.Tensor | None = None  # (S*bk,) int32 padding map of a narrow packing
    in_vecs: torch.Tensor | None = None  # (S*bk/8,) int32: its channel_map_vectors
    narrow_route: bool = False  # the narrow route whatever the widths (the int8 stem)

    def __post_init__(self):
        nmb, tsk, bm = self.vals.shape
        tiles = self.vals.reshape(nmb, tsk // self.bk, self.bk, bm)
        if self.vals_k is None:
            self.vals_k = tiles.transpose(2, 3).contiguous()
        if self.steps is None:
            live = (tiles != 0).any(3).any(2).cpu().numpy()
            self.steps, self.nsteps = _step_list(live)
        if self.in_chan is not None and self.in_vecs is None:
            self.in_vecs = channel_map_vectors(self.in_chan)

    @property
    def narrow(self) -> bool:
        """Whether B3 runs this packing on its narrow route: a packing
        with ``narrow_route``, and anything but 128-wide blocks over
        channels that divide by 128."""
        return (self.narrow_route or (self.bk, self.bm) != (BK, BM) or self.cin % BK != 0
                or self.cout % BM != 0)

    def to(self, device) -> "FusedSparseConvQ":
        """The plan with its tensors on ``device`` (dtypes unchanged)."""
        return dataclasses.replace(
            self, vals=self.vals.to(device), w_scale=self.w_scale.to(device),
            rows=self.rows.to(device), vals_k=self.vals_k.to(device),
            steps=self.steps.to(device), nsteps=self.nsteps.to(device),
            in_chan=None if self.in_chan is None else self.in_chan.to(device),
            in_vecs=None if self.in_vecs is None else self.in_vecs.to(device))


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


ZERO_VEC, GATHER_VEC = -1, -2  # channel_map_vectors' kinds below 0


def channel_map_vectors(chan: torch.Tensor) -> torch.Tensor:
    """The vector descriptor of a channel map (``chan``, int, its length a
    multiple of 8), which the quantize kernels read the map through: one
    int32 per 8 output channels, on ``chan``'s device.  Entry v is

    - ``s >= 0`` (contiguous): ``chan[8v:8v+8]`` is ``s .. s+7`` with s a
      multiple of 8, one 16-byte load of bf16;
    - ``ZERO_VEC``: all 8 entries are negative (zeros; nothing is loaded);
    - ``GATHER_VEC``: anything else, read element by element.

    Build it once where the map is made (a host copy of ``chan``).
    ``select_channels_by_vectors`` is its plain reader."""
    c = chan.detach().cpu().numpy().astype(np.int64)
    if c.ndim != 1 or c.size % 8:
        raise ValueError(f"a channel map of a multiple of 8 entries, got shape {c.shape}")
    v = c.reshape(-1, 8)
    first = v[:, 0]
    contiguous = (first >= 0) & (first % 8 == 0) & (v == first[:, None] + np.arange(8)).all(1)
    out = np.where(contiguous, first, np.where((v < 0).all(1), ZERO_VEC, GATHER_VEC))
    return torch.from_numpy(out.astype(np.int32)).to(chan.device)


def select_channels_by_vectors(x: torch.Tensor, chan: torch.Tensor,
                               vecs: torch.Tensor) -> torch.Tensor:
    """Plain reader of ``channel_map_vectors``: ``select_channels(x,
    chan)`` built vector by vector as the kernels read it (a contiguous
    vector as one slice of x, a zero vector as zeros, a gathered one
    through ``chan``)."""
    parts = []
    for v, d in enumerate(vecs.tolist()):
        if d >= 0:
            parts.append(x[..., d:d + 8])
        elif d == ZERO_VEC:
            parts.append(x.new_zeros(x.shape[:-1] + (8,)))
        else:
            parts.append(select_channels(x, chan[8 * v:8 * v + 8]))
    return torch.cat(parts, dim=-1)


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
                        chan: torch.Tensor | None = None, *,
                        vecs: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(xq, xs)``: int8 ``xq`` of x's shape and the (N,) f32 per-frame
    scales, ``tpuseg``'s x quantization (``quantize_activation_reference``).
    With ``chan`` (an int32 index of x's last axis) it quantizes
    ``x.index_select(-1, chan)``, the scale taken over those channels, as
    ``tpuseg``'s ``CompactSparseQ`` does after its gather; a negative entry
    of ``chan`` reads as 0 (``select_channels``).  ``vecs`` is the map's
    ``channel_map_vectors``, built once with the map (a CUDA call with
    ``chan`` raises without it: building it reads ``chan`` on the host).

    On a CPU tensor this runs the plain version.  On a CUDA tensor (bf16 or
    f32, contiguous, channels last) it launches the hand-written kernels of
    ``tpuseg_torch/csrc/quantize.cu`` on the current stream: per-frame
    absmax (dynamic scale only, counted in ``quantize_activation.
    absmax_launches``), then one pass that reads x (through the map's
    vectors: the gathered copy is never made) and writes xq and xs
    (counted in ``quantize_activation.launches``, and those through a map
    in ``quantize_activation.map_launches`` too); it raises if a launch
    fails."""
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
    if chan is not None and vecs is None:
        raise ValueError("a channel map on the card needs its channel_map_vectors (vecs=)")
    if chan is not None and (vecs.dtype != torch.int32 or tuple(vecs.shape) != (cq // 8,)
                             or not vecs.is_contiguous() or vecs.device != x.device):
        raise ValueError(f"vecs must be chan's contiguous int32 descriptor ({cq // 8},) "
                         "on x's device")
    from tpuseg_torch.ops._build import load_library

    dev = x.device
    pixels = x.numel() // (n * cx)
    xq = torch.empty(x.shape[:-1] + (cq,), dtype=torch.int8, device=dev)
    # xs, and the absmax kernel's (N,) scratch (its C entry zeroes it)
    scales = torch.empty((1 if x_scale is not None else 2, n), dtype=torch.int32, device=dev)
    xs = scales[0].view(torch.float32)
    absmax = None if x_scale is not None else scales[1]
    lib = load_library()
    cptr = None if chan is None else chan.data_ptr()
    vptr = None if chan is None else vecs.data_ptr()
    shape = (n, pixels, cx, cq, _DTYPE_CODE[x.dtype])
    with _on_device(dev):
        _raise_on(lib, "quantize", lib.tpuseg_quantize(
            x.data_ptr(), cptr, vptr, None if absmax is None else absmax.data_ptr(),
            0.0 if x_scale is None else float(x_scale), xq.data_ptr(), xs.data_ptr(), *shape,
            _raw_stream(dev)))
    quantize_activation.absmax_launches += absmax is not None
    quantize_activation.launches += 1
    quantize_activation.map_launches += chan is not None
    return xq, xs


quantize_activation.launches = 0
quantize_activation.absmax_launches = 0
quantize_activation.map_launches = 0


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
    then ``fused_sparse_conv_q_int8_reference``.  NHWC in, f32 out."""
    return fused_sparse_conv_q_int8_reference(*quantize_activation_reference(x, plan.x_scale),
                                              plan)


def fused_sparse_conv_q_int8_reference(xq: torch.Tensor, xs: torch.Tensor,
                                       plan: FusedSparseConvQ) -> torch.Tensor:
    """Plain version of B3 on a quantized x (int8 NHWC ``xq``, its (N,) f32
    scales ``xs``): rebuild the dense HWIO int8 weight from ``vals``/``rows``
    (padded slots add zeros; a narrow packing's rows and columns past cin
    and cout are cut off), compute the integer conv exactly
    (``int_conv_exact``), apply the epilogue.  f32 out."""
    k, S, bk, bm = plan.kernel, plan.s, plan.bk, plan.bm
    nmb = -(-plan.cout // bm)
    vals = plan.vals.to(torch.float64).reshape(nmb, k, k, S, bk, bm)
    w = torch.zeros((k, k, -(-plan.cin // bk) * bk, nmb * bm), dtype=torch.float64,
                    device=vals.device)
    for jb, blocks in enumerate(plan.rows.tolist()):
        for s_i, kb in enumerate(blocks):
            w[:, :, kb * bk:(kb + 1) * bk, jb * bm:(jb + 1) * bm] += vals[jb, :, :, s_i]
    w = w[:, :, :plan.cin, :plan.cout]
    return dequantize(int_conv_exact(xq, w, plan.dilation), xs,
                      plan.w_scale.reshape(-1)[:plan.cout])


def cast_bias_bf16(y: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """``tpuseg``'s served order after a sparse or int8 conv: its f32 output
    cast to bf16, then the bias added in bf16 (no add without a bias).  The
    plain version of every bf16+bias route."""
    y = y.to(torch.bfloat16)
    return y if bias is None else y + bias.to(device=y.device, dtype=torch.bfloat16)


def _check_q(x: torch.Tensor, plan: FusedSparseConvQ, chan: torch.Tensor | None,
             quantized: bool = False) -> None:
    """Raise unless float (``quantized``: int8) NHWC ``x``, read through
    ``chan``, fits ``plan``."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got shape {tuple(x.shape)}")
    if quantized and x.dtype != torch.int8:
        raise TypeError(f"a quantized x must be int8, got {x.dtype}")
    if not quantized and x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous")
    cin = x.shape[3] if chan is None else chan.numel()
    if cin != plan.cin:
        raise ValueError(f"x has {cin} channels, the plan {plan.cin}")
    # get_device and torch.Size == tuple: the checks run on every launch,
    # and the small narrow convs feel their host time
    tensors = (plan.vals, plan.vals_k, plan.rows, plan.w_scale, plan.steps, plan.nsteps)
    dev = x.get_device()
    if any(t.get_device() != dev for t in tensors):
        raise ValueError(f"plan on {plan.vals.device}, x on {x.device}")
    nmb, T, S = -(-plan.cout // plan.bm), plan.kernel * plan.kernel, plan.s
    if (plan.vals.dtype != torch.int8 or plan.vals_k.dtype != torch.int8
            or plan.rows.dtype != torch.int32 or plan.w_scale.dtype != torch.float32
            or plan.steps.dtype != torch.int32 or plan.nsteps.dtype != torch.int32
            or plan.vals.shape != (nmb, T * S * plan.bk, plan.bm)
            or plan.vals_k.shape != (nmb, T * S, plan.bm, plan.bk)
            or plan.rows.shape != (nmb, S) or plan.w_scale.shape != (nmb, 1, plan.bm)
            or plan.steps.shape != (nmb, T * S) or plan.nsteps.shape != (nmb,)
            or not all(t.is_contiguous() for t in tensors)):
        raise ValueError("int8 plan does not match its geometry (contiguous int8 vals "
                         f"{(nmb, T * S * plan.bk, plan.bm)}, vals_k "
                         f"{(nmb, T * S, plan.bm, plan.bk)}, int32 rows {(nmb, S)}, steps "
                         f"{(nmb, T * S)} and nsteps {(nmb,)}, f32 w_scale {(nmb, 1, plan.bm)})")
    padded = plan.in_chan is not None
    if plan.narrow and (plan.bk not in (32, 64, BK) or S != -(-plan.cin // plan.bk)
                        or plan.bm not in (16, 32, 64, BM) or plan.cin % 8 or plan.cout % 8
                        or padded != (plan.cin != S * plan.bk)):
        raise ValueError(f"narrow int8 packing bk={plan.bk}, bm={plan.bm}, S={S} for "
                         f"{plan.cin} -> {plan.cout} channels: B3's narrow route takes bk in "
                         "(32, 64, 128) with S = ceil(cin / bk), bm in (16, 32, 64, 128), cin "
                         "and cout divisible by 8, and a padding map to S * bk channels "
                         "exactly where cin is less")
    if padded and (plan.in_chan.dtype != torch.int32 or plan.in_vecs.dtype != torch.int32
                   or plan.in_chan.shape != (S * plan.bk,)
                   or plan.in_vecs.shape != (S * plan.bk // 8,)
                   or plan.in_chan.get_device() != dev or plan.in_vecs.get_device() != dev):
        raise ValueError(f"the padding map must be int32 ({S * plan.bk},) with its int32 "
                         f"vectors ({S * plan.bk // 8},) on x's device")
    if plan.kernel % 2 == 0:
        raise ValueError(f"'same' padding needs an odd kernel, got {plan.kernel}")
    if QMAX * QMAX * T * S * plan.bk >= 2**31:
        raise ValueError(f"k={plan.kernel}, S={S}: the int32 sum could overflow")
    if max(x.shape) > 2**31 - 1:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's int sizes")


B3_TILE_PIXELS = 256  # output pixels a CTA of B3 computes
# (N, epilogue mode) of the narrow route's instances: f32 y at every width
# (the zoo, the frontend's stage-3 convs); at 128 the int8 stem's relu(y +
# bias) as f32 or bf16 (2, 3) and its int8 hand-off from either (4, 5)
B3_NARROW_INSTANCES = frozenset({(16, 0), (32, 0), (64, 0), (128, 0), (128, 2), (128, 3),
                                 (128, 4), (128, 5)})
B3_WIDE_MODES = (0, 1)  # the 128-wide kernel's epilogues: f32 y, bf16 + bias
# the int8 hand-off's scales: where the narrow kernel's division is IEEE's
# (csrc/sparse_conv_q_narrow.cu div_rn); absmax / 127 for any finite absmax
# >= 1e-8 lies inside
HANDOFF_SCALES = (2.0 ** -100, 2.0 ** 100)


def b3_narrow_tile(n: int, h: int, w: int) -> tuple[int, int]:
    """The narrow route's tile on an (n, h, w) map: ``(R, G)``, R image
    rows and G whole images of 256 pixels or fewer.  A 256-pixel row
    segment (1, 1) where w >= 256; else R = min(256 // w, h) rows (B2's
    row bands, ``b2_tile_rows``); where a whole image fits (R = h), G =
    min(256 // (h * w), n) images."""
    if w >= B3_TILE_PIXELS:
        return 1, 1
    rows = min(B3_TILE_PIXELS // w, h)
    if rows < h:
        return rows, 1
    return h, max(1, min(B3_TILE_PIXELS // (h * w), n))


def b3_narrow_instance(kb: int, bn: int, mode: int) -> None:
    """Raise ``ValueError`` unless the narrow route has an instance for K
    = ``kb``, N = ``bn`` and epilogue ``mode`` (0 f32 y, 1 bf16 + bias,
    2/3 relu(y + bias) as f32/bf16, 4/5 its int8 hand-off from f32/bf16):
    the combinations its callers launch, ``B3_NARROW_INSTANCES``, at K in
    (32, 64, 128)."""
    if kb not in (32, 64, BK) or (bn, mode) not in B3_NARROW_INSTANCES:
        raise ValueError(f"B3's narrow route has no instance for K={kb}, N={bn}, epilogue "
                         f"mode {mode}; it has K in (32, 64, 128) with (N, mode) in "
                         f"{sorted(B3_NARROW_INSTANCES)}")


def _launch_b3(xq: torch.Tensor, xs: torch.Tensor, plan: FusedSparseConvQ,
               bias: torch.Tensor | None, bf16_out: bool, relu: bool = False,
               next_scale: float | None = None) -> torch.Tensor:
    """One launch of kernel B3 on int8 NHWC ``xq`` and its (N,) scales
    ``xs``, checked by the caller: ``sparse_conv_q_kernel`` for 128-wide
    packings (epilogues ``B3_WIDE_MODES``), ``sparse_conv_q_narrow_kernel``
    for narrow ones; either raises, before any launch, on an epilogue its
    kernel has no instance for (``b3_narrow_instance``).  Writes the f32 y,
    or with ``bf16_out`` the bf16 ``bf16(float(bf16(y)) + float(bias))``
    (bias bf16); with ``relu`` ``relu(y + bias)`` (bias f32) as f32, or
    rounded to bf16 with ``bf16_out``; with ``relu`` and ``next_scale`` its
    int8 hand-off at that static scale, from the f32 or the bf16 value."""
    mode = 2 * int(relu) + int(bf16_out)
    if next_scale is not None:
        if not relu:
            raise ValueError("B3's int8 hand-off follows the relu epilogue")
        mode += 2
    if plan.narrow:
        b3_narrow_instance(plan.bk, plan.bm, mode)
    elif mode not in B3_WIDE_MODES:
        raise ValueError(f"B3's 128-wide kernel has epilogue modes {B3_WIDE_MODES}, not "
                         f"{mode}: the int8 stem's packings run on the narrow route")
    n, h, w, _ = xq.shape
    dev = xq.device
    dtype = (torch.int8 if next_scale is not None else torch.bfloat16 if bf16_out
             else torch.float32)
    out = torch.empty((n, h, w, plan.cout), dtype=dtype, device=dev)
    with _on_device(dev):
        if plan.narrow:
            sparse_conv_q_narrow_kernel(xq, xs, plan, bias, mode, out, _raw_stream(dev),
                                        0.0 if next_scale is None else next_scale)
        else:
            sparse_conv_q_kernel(xq, xs, plan, bias, mode, out, _raw_stream(dev))
    return out


def sparse_conv_q_kernel(xq: torch.Tensor, xs: torch.Tensor, plan: FusedSparseConvQ,
                         bias: torch.Tensor | None, mode: int, out: torch.Tensor,
                         stream: int) -> None:
    """One launch of ``csrc/sparse_conv_q.cu`` (B3 on a 128-wide packing)
    into ``out`` with epilogue ``mode``, counted in
    ``sparse_conv_q_kernel.launches`` whichever entry point called it;
    raises if the launch fails."""
    from tpuseg_torch.ops._build import load_library

    n, h, w, cin = xq.shape
    lib = load_library()
    err = lib.tpuseg_sparse_conv_q(
        xq.data_ptr(), plan.vals_k.data_ptr(), plan.rows.data_ptr(), plan.steps.data_ptr(),
        plan.nsteps.data_ptr(), plan.w_scale.data_ptr(), xs.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), n, h, w, cin, plan.cout,
        plan.s, plan.kernel, plan.dilation, mode, stream)
    _raise_on(lib, "sparse_conv_q", err)
    sparse_conv_q_kernel.launches += 1


sparse_conv_q_kernel.launches = 0


def sparse_conv_q_narrow_kernel(xq: torch.Tensor, xs: torch.Tensor, plan: FusedSparseConvQ,
                                bias: torch.Tensor | None, mode: int, out: torch.Tensor,
                                stream: int, next_scale: float = 0.0) -> None:
    """One launch of ``csrc/sparse_conv_q_narrow.cu`` (B3 on a narrow
    packing) into ``out`` with epilogue ``mode`` (``next_scale``: the int8
    hand-off's static scale in modes 4 and 5, else 0), counted in
    ``sparse_conv_q_narrow_kernel.launches`` whichever entry point called
    it (``quant_conv_apply`` or the int8 stem's convs); raises if the
    launch fails."""
    from tpuseg_torch.ops._build import load_library

    n, h, w, cin = xq.shape
    lib = load_library()
    err = lib.tpuseg_sparse_conv_q_narrow(
        xq.data_ptr(), plan.vals_k.data_ptr(), plan.steps.data_ptr(), plan.nsteps.data_ptr(),
        plan.w_scale.data_ptr(), xs.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), n, h, w, cin, plan.cout, plan.s, plan.kernel, plan.dilation, plan.bk,
        plan.bm, *b3_narrow_tile(n, h, w), mode, float(next_scale), stream)
    _raise_on(lib, "sparse_conv_q_narrow", err)
    sparse_conv_q_narrow_kernel.launches += 1


sparse_conv_q_narrow_kernel.launches = 0


def _b3_cuda(x: torch.Tensor, plan: FusedSparseConvQ, chan: torch.Tensor | None,
             bias: torch.Tensor | None, bf16_out: bool, vecs: torch.Tensor | None = None,
             relu: bool = False, next_scale: float | None = None) -> torch.Tensor:
    """The CUDA half of every B3 entry point: quantize x through ``chan``,
    or a narrow packing's own padding map (``quantize_activation``'s
    kernels), then one B3 launch."""
    if chan is None and plan.in_chan is not None:
        chan, vecs = plan.in_chan, plan.in_vecs
    xq, xs = quantize_activation(x, plan.x_scale, chan, vecs=vecs)
    return _launch_b3(xq, xs, plan, bias, bf16_out, relu, next_scale)


def fused_sparse_conv_apply_q(x: torch.Tensor, plan: FusedSparseConvQ,
                              chan: torch.Tensor | None = None, *,
                              vecs: torch.Tensor | None = None) -> torch.Tensor:
    """Int8 stride-1 'same' block-sparse conv of NHWC-contiguous float ``x``
    -> f32 (N, H, W, Cout); with ``chan`` (int32; ``vecs`` its
    ``channel_map_vectors``) the conv of ``select_channels(x, chan)`` (a -1
    entry reads zeros), quantized over those channels.

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
    out = _b3_cuda(x, plan, chan, None, False, vecs)
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
                                  chan: torch.Tensor | None = None, *,
                                  vecs: torch.Tensor | None = None) -> torch.Tensor:
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
    out = _b3_cuda(x, plan, chan, b, True, vecs)
    fused_sparse_conv_apply_q.launches += 1
    return out


def relu_tpuseg(v: torch.Tensor) -> torch.Tensor:
    """``tpuseg``'s ``jax.nn.relu`` = ``jnp.maximum(v, 0)``: -0.0 becomes
    +0.0 and a NaN stays a NaN (``torch.relu`` keeps -0.0)."""
    return torch.where(v <= 0, 0.0, v)


def fused_sparse_conv_q_bias_relu_reference(x: torch.Tensor, plan: FusedSparseConvQ,
                                            bias: torch.Tensor,
                                            out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the int8 stem's route: B3's f32 y
    (``fused_sparse_conv_q_reference``), then the f32 bias added and
    ``relu_tpuseg`` in f32, then one cast to ``out_dtype``."""
    return _bias_relu(fused_sparse_conv_q_reference(x, plan), bias, out_dtype)


def _bias_relu(y: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The stem route's epilogue after B3's f32 y, in plain PyTorch."""
    return relu_tpuseg(y + bias.to(device=y.device, dtype=torch.float32)).to(out_dtype)


def fused_sparse_conv_q_bias_relu_int8_in_reference(xq: torch.Tensor, xs: torch.Tensor,
                                                    plan: FusedSparseConvQ, bias: torch.Tensor,
                                                    out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the stem route on a quantized x (the previous
    conv's hand-off): int8 NHWC ``xq`` with its (N,) f32 scales ``xs``
    through ``fused_sparse_conv_q_int8_reference``, then the bias, relu and
    cast of ``fused_sparse_conv_q_bias_relu_reference``."""
    return _bias_relu(fused_sparse_conv_q_int8_reference(xq, xs, plan), bias, out_dtype)


def fused_sparse_conv_q_bias_relu_int8_out_reference(
        x: torch.Tensor, plan: FusedSparseConvQ, bias: torch.Tensor, out_dtype: torch.dtype,
        next_scale: float, *, xs: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the stem route's int8 hand-off: the route's output
    in ``out_dtype`` (on float x, or with ``xs`` on an int8 x), then the
    next conv's quantization of it at the static scale ``next_scale``
    (``quantize_activation_reference``: ``tpuseg``'s division of the
    dtype-rounded output by the scale, round half to even, clip).  int8 out."""
    y = (fused_sparse_conv_q_bias_relu_reference(x, plan, bias, out_dtype) if xs is None
         else fused_sparse_conv_q_bias_relu_int8_in_reference(x, xs, plan, bias, out_dtype))
    return quantize_activation_reference(y, next_scale)[0]


def fused_sparse_conv_q_bias_relu(x: torch.Tensor, plan: FusedSparseConvQ, bias: torch.Tensor,
                                  out_dtype: torch.dtype, *, xs: torch.Tensor | None = None,
                                  next_scale: float | None = None) -> torch.Tensor:
    """The int8 stem's conv (``tpuseg/ops/polyphase.py:349-359``):
    ``relu(float(acc) * (x_scale * w_scale) + bias)`` in f32, each step
    rounded on its own, cast to ``out_dtype`` (f32 or bf16): (N, H, W, Cout).
    ``bias`` is taken as f32 (a bf16 bias converts exactly).

    ``x`` is float NHWC, quantized at ``plan.x_scale`` (None: per frame);
    or, with ``xs`` (its (N,) f32 scales), the int8 x a previous conv
    handed on, cin channels wide.  With ``next_scale`` (the next stem
    conv's static scale, a Python float, rounded to f32 as ``tpuseg``'s
    ``jnp.float32`` does) the result is that conv's int8 x instead:
    ``clip(round(float(out_dtype(v)) / next_scale), -127, 127)``.

    On a CUDA tensor the quantize kernels (for float x) and one launch of
    B3's narrow kernel write it (epilogue modes 2 and 3, or the hand-off's
    4 and 5), counted in ``fused_sparse_conv_apply_q.launches`` with B3's
    other routes, in ``fused_sparse_conv_q_bias_relu.launches``, and the
    hand-offs in ``fused_sparse_conv_q_bias_relu.handoff_launches`` too; on
    a CPU tensor it runs the plain version of its case
    (``fused_sparse_conv_q_bias_relu_reference``, ``..._int8_in_reference``
    or ``..._int8_out_reference``)."""
    quantized = xs is not None
    _check_q(x, plan, None, quantized)
    if bias.dim() != 1 or bias.shape[0] != plan.cout:
        raise ValueError(f"bias must be ({plan.cout},), got {tuple(bias.shape)}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if quantized and (xs.dtype != torch.float32 or tuple(xs.shape) != (x.shape[0],)
                      or xs.device != x.device or not xs.is_contiguous()):
        raise ValueError(f"xs must be x's contiguous f32 scales ({x.shape[0]},) on its device")
    if quantized and plan.in_chan is not None:
        raise ValueError("an int8 x is cin channels wide: a packing with a padding map "
                         "quantizes its own x")
    if next_scale is not None and not HANDOFF_SCALES[0] <= next_scale <= HANDOFF_SCALES[1]:
        raise ValueError(f"the hand-off takes a static scale in [2**-100, 2**100] (any the "
                         f"stem calibrates), got {next_scale}")
    if x.device.type == "cpu":
        if next_scale is not None:
            return fused_sparse_conv_q_bias_relu_int8_out_reference(x, plan, bias, out_dtype,
                                                                    next_scale, xs=xs)
        if quantized:
            return fused_sparse_conv_q_bias_relu_int8_in_reference(x, xs, plan, bias, out_dtype)
        return fused_sparse_conv_q_bias_relu_reference(x, plan, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b = bias.to(device=x.device, dtype=torch.float32).contiguous()
    bf16_out = out_dtype == torch.bfloat16
    if quantized:
        out = _launch_b3(x, xs, plan, b, bf16_out, True, next_scale)
    else:
        out = _b3_cuda(x, plan, None, b, bf16_out, relu=True, next_scale=next_scale)
    fused_sparse_conv_apply_q.launches += 1
    fused_sparse_conv_q_bias_relu.launches += 1
    fused_sparse_conv_q_bias_relu.handoff_launches += next_scale is not None
    return out


fused_sparse_conv_q_bias_relu.launches = 0
fused_sparse_conv_q_bias_relu.handoff_launches = 0
