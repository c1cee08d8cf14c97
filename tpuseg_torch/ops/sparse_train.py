"""Block-sparse conv TRAINING (counterpart of ``tpuseg/ops/sparse_train.py``):
an autograd function so high-sparsity layers train at their union block
density, not as masked dense convs.

All three passes of an eligible masked conv run on the mask's support:

- forward: kernel B2 (``csrc/sparse_conv.cu``, through
  ``sparse_conv_train_forward``) on values packed from the live weight each
  step.  The packing is one precomputed index gather over the flattened
  OIHW weight (``pack_vals``), so its backward scatters each value's
  gradient back to exactly one weight.
- dgrad (dx): a stride-1 'same' conv of dy with the taps flipped and the
  channel blocks transposed, itself block-sparse on the transposed support:
  kernel B2 again (``sparse_conv_train_dgrad``), on values re-indexed from
  the forward packing by a second gather (``_transpose_vals``).
- wgrad (dvals): per-tap batched matmuls restricted to the support blocks,
  K = all pixels, accumulated in f32 and masked by the structure
  (``tpuseg`` computes it in XLA, not Pallas; here PyTorch matmuls).

Both packings carry their live steps (``steps``/``nsteps``, what B2 walks)
built from the mask STRUCTURE, ``nzsel`` for the forward and ``gather_t`` !=
sentinel for the dgrad, never from the current values: a tile's weights can
be zero at one step and nonzero at the next.

The structure (``SparseTrainStruct``, ``plan_sparse_conv_train``,
``build_sparse_train_structs``) is ``tpuseg``'s numpy, array for array;
``SparseTrainStruct.to(device)`` builds, once, the ``SparseTrainPlan`` of
tensors the kernels read, and every function here takes that plan.  On CPU tensors B2's entry points run its plain version
(``fused_sparse_conv_reference``); on CUDA tensors they launch the kernel
or raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuseg_torch.ops.sparse_conv import FusedSparseConv, _run_b2, _step_list


@dataclasses.dataclass(frozen=True)
class SparseTrainStruct:
    """Static structure of a trainable block-sparse conv (host numpy and
    ints, ``tpuseg``'s fields and values)."""

    rows: np.ndarray       # (nmb, S) K-block index per fwd gather slot
    nzsel: np.ndarray      # (nmb, T, S) 0/1: tap t has a block at slot s
    rows_t: np.ndarray     # (nkb, St) M-block index per bwd gather slot
    gather_t: np.ndarray   # (nkb, T, St) flat index into fwd vals (+sentinel)
    kernel: int
    dilation: int
    bk: int
    bm: int
    cin: int
    cout: int
    s: int
    st: int
    rows_per_tile: int
    block_density: float

    @property
    def taps(self) -> np.ndarray:
        k, d = self.kernel, self.dilation
        return np.array([(p * d, q * d) for p in range(k) for q in range(k)],
                        np.int32)

    def to(self, device) -> "SparseTrainPlan":
        """The tensors the kernels read, on ``device``."""
        return SparseTrainPlan.build(self, torch.device(device))


def plan_sparse_conv_train(
    mask_hwio: np.ndarray,
    dilation: int = 1,
    bk: int = 128,
    bm: int = 128,
    rows_per_tile: int = 8,
) -> SparseTrainStruct:
    """Derive the static packing structure from a mask (weights-free);
    ``tpuseg``'s numpy on the HWIO mask."""
    kh, kw, cin, cout = mask_hwio.shape
    assert kh == kw
    assert cin % bk == 0 and cout % bm == 0
    nkb, nmb = cin // bk, cout // bm
    T = kh * kw
    m = np.asarray(mask_hwio) != 0
    nz = np.zeros((nmb, T, nkb), bool)
    for t in range(T):
        p, q = divmod(t, kw)
        blocks = m[p, q].reshape(nkb, bk, nmb, bm)
        nz[:, t, :] = blocks.any(axis=(1, 3)).T
    union = nz.any(axis=1)            # (nmb, nkb)
    union_t = union.T                 # (nkb, nmb)
    S = max(int(union.sum(axis=1).max()), 1)
    St = max(int(union_t.sum(axis=1).max()), 1)

    rows = np.zeros((nmb, S), np.int32)
    slot_of = -np.ones((nmb, nkb), np.int64)  # k-block -> fwd slot
    for j in range(nmb):
        ks = np.flatnonzero(union[j])
        rows[j, : len(ks)] = ks
        slot_of[j, ks] = np.arange(len(ks))

    nzsel = np.zeros((nmb, T, S), np.float32)
    for j in range(nmb):
        for s_i, k in enumerate(np.flatnonzero(union[j])):
            nzsel[j, :, s_i] = nz[j, :, k]

    # transposed structure: dgrad conv over (cout -> cin) with flipped taps.
    # valsT[jp, tp, sp] = vals[kp, T-1-tp, slot_of[kp, jp]]^T with
    # kp = rows_t[jp, sp]; padded slots point at an appended zero block.
    rows_t = np.zeros((nkb, St), np.int32)
    sentinel = nmb * T * S  # index of the appended zero block
    gather_t = np.full((nkb, T, St), sentinel, np.int64)
    for jp in range(nkb):
        ms = np.flatnonzero(union_t[jp])
        rows_t[jp, : len(ms)] = ms
        for sp, kp in enumerate(ms):
            si = slot_of[kp, jp]
            assert si >= 0
            for tp in range(T):
                gather_t[jp, tp, sp] = (kp * T + (T - 1 - tp)) * S + si

    return SparseTrainStruct(
        rows=rows, nzsel=nzsel, rows_t=rows_t, gather_t=gather_t,
        kernel=kh, dilation=dilation, bk=bk, bm=bm, cin=cin, cout=cout,
        s=S, st=St, rows_per_tile=rows_per_tile,
        block_density=float(union.mean()),
    )


def _pack_index(st: SparseTrainStruct) -> np.ndarray:
    """For every element of the forward packing (nmb, T*S*bk, bm), its index
    in the flattened OIHW weight followed by one zero (bk, bm) block: tile
    (j, t, s) of a live slot reads w[j*bm + m, rows[j, s]*bk + c, p, q]
    (t = p*k + q) at row c, column m; a dead slot reads the zero block."""
    T, S, bk, bm = st.kernel ** 2, st.s, st.bk, st.bm
    nmb = st.cout // bm
    c = np.arange(bk)[:, None]
    m = np.arange(bm)[None, :]
    zero = st.cout * st.cin * T + c * bm + m
    idx = np.empty((nmb, T, S, bk, bm), np.int64)
    for j in range(nmb):
        for t in range(T):
            for s in range(S):
                if st.nzsel[j, t, s] == 0:
                    idx[j, t, s] = zero
                    continue
                o = j * bm + m
                i = int(st.rows[j, s]) * bk + c
                idx[j, t, s] = (o * st.cin + i) * T + t
    return idx.reshape(-1)


def _transpose_index(st: SparseTrainStruct) -> np.ndarray:
    """For every element of the dgrad packing (nkb, T*St*bm, bk), its index
    in the flattened forward packing followed by one zero block: tile (jp,
    tp, sp) is the transpose of forward tile ``gather_t[jp, tp, sp]``, or
    the zero block at the sentinel."""
    bk, bm = st.bk, st.bm
    m = np.arange(bm)[:, None]
    c = np.arange(bk)[None, :]
    g = st.gather_t.reshape(-1, 1, 1)        # the sentinel indexes the zero block
    return (g * bk * bm + c * bm + m).reshape(-1)


@dataclasses.dataclass(frozen=True)
class SparseTrainPlan:
    """A ``SparseTrainStruct``'s tensors on one device: the two gather
    indices, both packings' ``rows``/``steps``/``nsteps`` (int32) and the
    structural 0/1 ``nzsel`` (f32) that masks the wgrad."""

    struct: SparseTrainStruct
    pack_index: torch.Tensor       # int64, (nmb*T*S*bk*bm,)
    transpose_index: torch.Tensor  # int64, (nkb*T*St*bm*bk,)
    rows: torch.Tensor
    steps: torch.Tensor
    nsteps: torch.Tensor
    rows_t: torch.Tensor
    steps_t: torch.Tensor
    nsteps_t: torch.Tensor
    nzsel: torch.Tensor

    @classmethod
    def build(cls, st: SparseTrainStruct, device: torch.device) -> "SparseTrainPlan":
        T = st.kernel ** 2
        nmb, nkb = st.cout // st.bm, st.cin // st.bk
        steps, nsteps = _step_list(st.nzsel.reshape(nmb, T * st.s) != 0)
        sentinel = nmb * T * st.s
        steps_t, nsteps_t = _step_list(st.gather_t.reshape(nkb, T * st.st) != sentinel)
        return cls(
            struct=st,
            pack_index=torch.from_numpy(_pack_index(st)).to(device),
            transpose_index=torch.from_numpy(_transpose_index(st)).to(device),
            rows=torch.from_numpy(st.rows).to(device),
            steps=steps.to(device), nsteps=nsteps.to(device),
            rows_t=torch.from_numpy(st.rows_t).to(device),
            steps_t=steps_t.to(device), nsteps_t=nsteps_t.to(device),
            nzsel=torch.from_numpy(st.nzsel).to(device),
        )


def pack_vals(w_oihw: torch.Tensor, plan: SparseTrainPlan,
              dtype=torch.bfloat16) -> torch.Tensor:
    """Differentiable packing: dense OIHW weight -> (nmb, T*S*bk, bm) in
    ``dtype``, ``tpuseg``'s ``pack_vals`` value for value (its HWIO
    weight's tiles).  One gather of the flattened weight with one zero block
    appended; its backward puts each gradient on the one weight it came
    from (zero off the support).  ``plan`` lies on ``w_oihw``'s device."""
    st = plan.struct
    flat = torch.cat([w_oihw.reshape(-1), w_oihw.new_zeros(st.bk * st.bm)])
    vals = flat.index_select(0, plan.pack_index)
    return vals.reshape(st.cout // st.bm, -1, st.bm).to(dtype)


def _transpose_vals(vals: torch.Tensor, plan: SparseTrainPlan) -> torch.Tensor:
    """Re-index forward packed vals into the dgrad (transposed) packing
    (nkb, T*St*bm, bk): one gather of the flattened vals with one zero block
    appended (``tpuseg``'s ``_transpose_vals``)."""
    st = plan.struct
    flat = torch.cat([vals.reshape(-1), vals.new_zeros(st.bk * st.bm)])
    return flat.index_select(0, plan.transpose_index).reshape(st.cin // st.bk, -1, st.bk)


def _fwd_plan(vals: torch.Tensor, plan: SparseTrainPlan) -> FusedSparseConv:
    st = plan.struct
    return FusedSparseConv(
        vals=vals, rows=plan.rows, taps=st.taps, s=st.s, bk=st.bk, bm=st.bm,
        kernel=st.kernel, dilation=st.dilation, cin=st.cin, cout=st.cout,
        block_density=st.block_density, steps=plan.steps, nsteps=plan.nsteps,
    )


def _bwd_plan(vals_t: torch.Tensor, plan: SparseTrainPlan) -> FusedSparseConv:
    st = plan.struct
    return FusedSparseConv(
        vals=vals_t, rows=plan.rows_t, taps=st.taps, s=st.st, bk=st.bm, bm=st.bk,
        kernel=st.kernel, dilation=st.dilation, cin=st.cout, cout=st.cin,
        block_density=st.block_density, steps=plan.steps_t, nsteps=plan.nsteps_t,
    )


def sparse_conv_train_forward(x: torch.Tensor, vals: torch.Tensor,
                              plan: SparseTrainPlan) -> torch.Tensor:
    """The forward's conv: B2 on the forward packing of ``vals``, NHWC-
    contiguous ``x`` -> f32 (N, H, W, Cout).  A launch on a CUDA tensor
    counts in ``sparse_conv_train_forward.launches``; a CPU tensor runs
    ``fused_sparse_conv_reference``."""
    return _run_b2(x, _fwd_plan(vals, plan), sparse_conv_train_forward)


sparse_conv_train_forward.launches = 0


def sparse_conv_train_dgrad(dy: torch.Tensor, vals_t: torch.Tensor,
                            plan: SparseTrainPlan) -> torch.Tensor:
    """The dgrad's conv: B2 on the transposed packing ``vals_t``
    (``_transpose_vals``), NHWC-contiguous ``dy`` -> f32 (N, H, W, Cin).
    B2 checks ``dy``'s contiguity and raises on a strided one.  A launch on
    a CUDA tensor counts in ``sparse_conv_train_dgrad.launches``; a CPU
    tensor runs ``fused_sparse_conv_reference``."""
    return _run_b2(dy, _bwd_plan(vals_t, plan), sparse_conv_train_dgrad)


sparse_conv_train_dgrad.launches = 0


def sparse_wgrad(x: torch.Tensor, dy: torch.Tensor, plan: SparseTrainPlan) -> torch.Tensor:
    """dvals (nmb, T*S*bk, bm) in f32: for each tap, the products of the
    tap-shifted support channels of ``x`` with ``dy`` summed over all
    pixels, masked by the structure (``tpuseg`` sparse_train.py:241-266).
    ``x`` and ``dy`` in the vals dtype; bf16 products accumulate in f32."""
    st = plan.struct
    T, S, bk, bm = st.kernel ** 2, st.s, st.bk, st.bm
    nmb = st.cout // bm
    n, h, w, _ = x.shape
    pad = st.dilation * (st.kernel - 1) // 2
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    # the support channels of every (out-block, slot), once: (n, h+2p, w+2p, nmb*S*bk)
    chan = (plan.rows.long()[..., None] * bk + torch.arange(bk, device=x.device)).reshape(-1)
    xg = xp.index_select(3, chan)
    dyr = dy.reshape(n * h * w, nmb, bm).permute(1, 0, 2)           # (nmb, P, bm)
    parts = []
    for ty, tx in st.taps.tolist():
        xs = xg[:, ty:ty + h, tx:tx + w, :].reshape(n * h * w, nmb, S * bk)
        a = xs.permute(1, 2, 0)                                        # (nmb, S*bk, P)
        if a.device.type == "cuda" and a.dtype != torch.float32:
            d_t = torch.bmm(a, dyr, out_dtype=torch.float32)
        else:
            d_t = torch.bmm(a.float(), dyr.float())
        parts.append(d_t.reshape(nmb, S, bk, bm))
    dvals = torch.stack(parts, dim=1) * plan.nzsel[:, :, :, None, None]
    return dvals.reshape(nmb, T * S * bk, bm)


class SparseConvVals(torch.autograd.Function):
    """Differentiable fused block-sparse conv on packed values:
    ``(x, vals) -> y`` f32, with dgrad and wgrad on the support."""

    @staticmethod
    def forward(ctx, x, vals, plan):
        x = x.contiguous()
        ctx.plan = plan
        ctx.save_for_backward(x, vals)
        return sparse_conv_train_forward(x, vals, plan)

    @staticmethod
    def backward(ctx, dy):
        x, vals = ctx.saved_tensors
        plan = ctx.plan
        dyc = dy.to(vals.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dx = sparse_conv_train_dgrad(dyc, _transpose_vals(vals, plan), plan).to(x.dtype)
        dvals = None
        if ctx.needs_input_grad[1]:
            dvals = sparse_wgrad(x, dyc, plan).to(vals.dtype)
        return dx, dvals, None


def sparse_conv_train(x: torch.Tensor, w_oihw: torch.Tensor, plan: SparseTrainPlan,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Trainable block-sparse conv of NHWC ``x`` with the live OIHW weight:
    pack, run B2, with B2's dgrad and the support-restricted wgrad in the
    backward.  Output f32 (like the inference kernel).  ``plan`` is the
    struct's ``SparseTrainPlan`` on ``x``'s device
    (``SparseTrainStruct.to``)."""
    vals = pack_vals(w_oihw, plan, dtype=compute_dtype)
    return SparseConvVals.apply(x.to(compute_dtype), vals, plan)


def build_sparse_train_structs(
    masks, spec, dense_threshold: float = 0.75, rows_per_tile: int = 8,
) -> tuple[dict, dict]:
    """{conv_name: SparseTrainStruct} for every eligible masked conv
    (``tpuseg``'s rules and report strings: stride 1, channels /128, union
    block density below ``dense_threshold``).  ``masks`` are the port's
    OIHW masks (tensors or arrays); the structure is planned on their HWIO
    view."""
    from tpuseg_torch.models.weights import oihw_to_hwio_np

    convs = {}
    for _, stage in spec.stages:
        if stage.kind == "convs":
            for cdef, _bn in stage.convs:
                convs[cdef.name] = cdef
        else:
            for blk in stage.blocks:
                for cdef in blk.convs:
                    convs[cdef.name] = cdef
                if blk.downsample is not None:
                    convs[blk.downsample[0].name] = blk.downsample[0]

    structs: dict = {}
    report: dict = {}
    for mask_name, mask in masks.items():
        if not mask_name.endswith(".weight"):
            continue
        cname = mask_name[: -len(".weight")]
        cdef = convs.get(cname)
        if cdef is None:
            continue
        if cdef.stride != 1:
            report[cname] = "dense: stride != 1"
            continue
        if cdef.cin % 128 or cdef.cout % 128:
            report[cname] = f"dense: channels {cdef.cin}x{cdef.cout} not /128"
            continue
        st = plan_sparse_conv_train(
            oihw_to_hwio_np(mask), dilation=cdef.dilation,
            rows_per_tile=rows_per_tile,
        )
        if st.block_density >= dense_threshold:
            report[cname] = f"dense: union block density {st.block_density:.2f}"
            continue
        structs[cname] = st
        report[cname] = f"sparse-train: union density {st.block_density:.2f}"
    return structs, report
