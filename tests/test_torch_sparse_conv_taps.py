"""Port parity for the per-tap sparse conv lowering: tpuseg_torch.ops.
sparse_conv's XwBsr packing, the plain version of kernel B4
(``bsr_matmul_xw``), ``plan_sparse_conv`` and ``sparse_conv_apply`` against
their tpuseg functions on the same weights, masks and inputs.  The JAX
side of B4 is the Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpuseg.ops.sparse_conv as jsc
from tpuseg.models.drn import conv2d as j_conv2d
from tpuseg_torch.ops import sparse_conv as tsc

torch.set_num_threads(2)

JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jsc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _coarse_mask(rng, K, M, density):
    """tests/test_sparse_conv.py's (K, M) mask: every column block keeps
    in-block 0."""
    nz = (rng.random((K // 128, M // 128)) < density).astype(np.float32)
    nz[0, :] = 1
    return np.kron(nz, np.ones((128, 128), np.float32))


def _oihw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("kind", ["coarse_0.4", "dead_column", "all_zero", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_xw_bsr_byte_equal(kind, dtype):
    """vals/rows/S/density equal tpuseg's bytes; rows and zero tiles pad a
    ragged column, and S >= 1 when a column block (or all of W) is empty."""
    rng = np.random.default_rng(0)
    K, M = 384, 512
    w = rng.normal(size=(K, M)).astype(np.float32)
    if kind == "coarse_0.4":
        w *= _coarse_mask(rng, K, M, 0.4)
    elif kind == "dead_column":
        w *= _coarse_mask(rng, K, M, 0.5)
        w[:, 128:256] = 0
    elif kind == "all_zero":
        w[:] = 0
    got = tsc.pack_xw_bsr(w, dtype)
    want = jsc.pack_xw_bsr(w, dtype=JDTYPE[dtype])
    assert (got.shape, got.bk, got.bm, got.s, got.block_density) == (
        want.shape, want.bk, want.bm, want.s, want.block_density)
    assert got.rows.dtype == torch.int32
    assert got.rows.numpy().tobytes() == np.asarray(want.rows).tobytes()
    assert got.vals.dtype == dtype and tuple(got.vals.shape) == tuple(want.vals.shape)
    assert got.vals.float().numpy().tobytes() == np.asarray(want.vals, np.float32).tobytes()
    # the packing holds the masked matrix, rounded to its dtype
    np.testing.assert_array_equal(tsc.xw_dense(got).numpy(),
                                  torch.from_numpy(w).to(dtype).float().numpy())


@pytest.mark.parametrize("P", [256, 200])
def test_bsr_matmul_xw_matches_jax(P):
    """test_xw_bsr_matmul's shapes, f32 plan: the plain version vs tpuseg's
    interpret-mode kernel (P padded to its tile there, any P here) and the
    masked dense product, at tpuseg's rtol = atol = 1e-4."""
    rng = np.random.default_rng(0)
    K, M = 256, 384
    w = rng.normal(size=(K, M)).astype(np.float32)
    wm = w * _coarse_mask(rng, K, M, 0.4)
    x = rng.normal(size=(P, K)).astype(np.float32)
    got = tsc.bsr_matmul_xw(torch.from_numpy(x), tsc.pack_xw_bsr(wm, torch.float32))
    assert got.dtype == torch.float32 and tuple(got.shape) == (P, M)
    Pp = -(-P // 128) * 128
    xp = np.pad(x, ((0, Pp - P), (0, 0)))
    want = np.asarray(jsc.bsr_matmul_xw(jnp.asarray(xp), jsc.pack_xw_bsr(wm, dtype=jnp.float32),
                                        bp=128))[:P]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), x @ wm, rtol=1e-4, atol=1e-4)


def test_bsr_matmul_xw_bf16_and_checks():
    """bf16 plan: within 2*K*eps of max|y| of tpuseg's kernel; the CPU path
    launches nothing; a non-contiguous x and a wrong K raise."""
    rng = np.random.default_rng(1)
    K, M, P = 512, 256, 384
    wm = rng.normal(size=(K, M)).astype(np.float32) * _coarse_mask(rng, K, M, 0.5)
    x = torch.from_numpy(rng.normal(size=(P, K)).astype(np.float32)).to(torch.bfloat16)
    packed = tsc.pack_xw_bsr(wm, torch.bfloat16)
    before = tsc.bsr_matmul_xw.launches
    got = tsc.bsr_matmul_xw(x, packed).numpy()
    assert tsc.bsr_matmul_xw.launches == before
    want = np.asarray(jsc.bsr_matmul_xw(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                        jsc.pack_xw_bsr(wm), bp=128))
    assert np.abs(got - want).max() <= 2 * K * np.finfo(np.float32).eps * np.abs(want).max()
    with pytest.raises(ValueError, match="contiguous"):
        tsc.bsr_matmul_xw(torch.zeros((K, P), dtype=torch.bfloat16).t(), packed)
    with pytest.raises(ValueError, match="K=256"):
        tsc.bsr_matmul_xw(torch.zeros((P, 256)), packed)


def test_plan_sparse_conv_same_choices():
    """Per-tap dense/sparse choices and the plan density equal tpuseg's: a
    fine 1x1-blocklet mask coarsens to dense, a 128-block mask stays
    sparse, and a tap with every block live goes dense.  Every tap's packing
    holds tpuseg's matrix for it: the dense W of a dense tap, else its
    XwBsr's rows."""
    rng = np.random.default_rng(2)
    k, cin, cout = 3, 256, 384
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    mask = np.zeros_like(w)
    mask[0, 0] = (rng.random((cin, cout)) < 0.5)                 # fine: coarsens dense
    mask[0, 1] = _coarse_mask(rng, cin, cout, 0.3)               # sparse
    mask[1, 1] = 1.0                                             # dense
    mask[2, 2] = _coarse_mask(rng, cin, cout, 0.5)
    for dense_threshold in (0.9, 0.5):
        got = tsc.plan_sparse_conv(_oihw(w), _oihw(mask), dense_threshold=dense_threshold)
        want = jsc.plan_sparse_conv(w, mask, dense_threshold=dense_threshold)
        assert got.density == want.density and got.kernel == want.kernel == k
        assert [(p, q, d) for p, q, _, d in got.taps] == [
            (p, q, not isinstance(wt, jsc.XwBsr)) for p, q, wt in want.taps]
        for (_, _, packed, dense), (_, _, wt) in zip(got.taps, want.taps):
            if dense:
                np.testing.assert_array_equal(tsc.xw_dense(packed).numpy(),
                                              np.asarray(wt, np.float32))
            else:
                assert packed.rows.numpy().tobytes() == np.asarray(wt.rows).tobytes()


@pytest.mark.parametrize("kernel,dilation", [(1, 1), (3, 1), (3, 2)])
def test_sparse_conv_apply_matches_jax(kernel, dilation):
    """test_sparse_conv_matches_masked_dense's case, f32 plan: the port's
    plain path vs tpuseg's sparse_conv_apply (interpret mode) at rtol =
    atol = 1e-4, and both vs the masked dense conv."""
    rng = np.random.default_rng(1)
    cin = cout = 256
    w = rng.normal(size=(kernel, kernel, cin, cout)).astype(np.float32)
    coarse = np.array([[1, 0], [1, 1]], dtype=np.float32)
    mask = np.broadcast_to(np.kron(coarse, np.ones((128, 128), np.float32)),
                           (kernel, kernel, cin, cout)).copy()
    x = rng.normal(size=(1, 8, 16, cin)).astype(np.float32)
    plan = tsc.plan_sparse_conv(_oihw(w), _oihw(mask), dtype=torch.float32)
    jplan = jsc.plan_sparse_conv(w, mask, dtype=jnp.float32)
    assert plan.density == jplan.density < 0.9
    got = tsc.sparse_conv_apply(torch.from_numpy(x), plan, dilation=dilation)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 8, 16, cout)
    want = np.asarray(jsc.sparse_conv_apply(jnp.asarray(x), jplan, dilation=dilation, bp=128))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    pad = dilation * (kernel - 1) // 2
    ref = np.asarray(j_conv2d(jnp.asarray(x), jnp.asarray(w * mask), stride=1,
                              dilation=dilation, padding=pad))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_sparse_conv_apply_odd_width_bf16():
    """Port only: an odd feature grid (W = 10, P = 2*7*10) with a dense tap,
    bf16 plan: within 2*K*eps of the f32 masked dense conv on the same bf16
    operands; each tap sums unrounded in f32."""
    rng = np.random.default_rng(5)
    k, cin, cout, d = 3, 256, 256, 2
    w = (rng.normal(size=(cout, cin, k, k)) * 0.1).astype(np.float32)
    mask = np.zeros_like(w)
    mask[:128, 128:] = 1.0
    mask[:, :, 1, 1] = 1.0  # the centre tap dense
    plan = tsc.plan_sparse_conv(w, mask)
    assert [dense for *_, dense in plan.taps].count(True) == 1
    x = torch.from_numpy(rng.normal(size=(2, 7, 10, cin)).astype(np.float32))
    got = tsc.sparse_conv_apply(x, plan, dilation=d)
    xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wb = torch.from_numpy(w * mask).to(torch.bfloat16).float()
    ref = torch.nn.functional.conv2d(xb, wb, None, 1, d, d).permute(0, 2, 3, 1)
    tol = 2 * k * k * cin * np.finfo(np.float32).eps * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol
