"""The port's RMCDB roll lowering (``tpuseg_torch.ops.rmcdb_lowering``)
against ``tpuseg``'s: the same plans (offsets, block indices, blocklet
values) from the same masks, the roll matmul within rtol 1e-5 of
``tpuseg``'s in f32 and of the masked dense matmul, bf16 too, and the same
rejections."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.ops import rmcdb_lowering as jrl
from tpuseg_torch.ops import rmcdb_lowering as trl
from tpuseg_torch.sparsity.rmcdb import BlockletType, RmcdbConfig, prune_as_rmcdb

CASES = [  # rows, cols, bh, b, count, spo
    (256, 256, 64, 8, 2, 0.0), (128, 256, 32, 4, 3, 0.5), (512, 512, 64, 16, 1, 0.0),
    (512, 512, 128, 16, 2, 0.25)]


def _case(seed, rows, cols, bh, b, count, spo):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(rows, cols)).astype(np.float32)
    cfg = RmcdbConfig(bh=bh, bw=bh, spo=spo, bl_types=[BlockletType(b, b)],
                      bl_counts=[count])
    mask, _ = prune_as_rmcdb(w, cfg)
    x = rng.normal(size=(48, cols)).astype(np.float32)
    return w, mask.astype(np.float32), x


@pytest.mark.parametrize("case", CASES)
def test_plan_and_matmul_equal_tpuseg(case):
    rows, cols, bh, b, count, spo = case
    w, mask, x = _case(rows + b, *case)
    tplan = trl.detect_rmcdb_rolls(w, mask, bh, bh, b, dtype=torch.float32)
    jplan = jrl.detect_rmcdb_rolls(w, mask, bh, bh, b, dtype=jnp.float32)
    assert tplan is not None and jplan is not None
    assert sorted(tplan.per_offset) == sorted(jplan.per_offset)
    for d, (rb, cb, vals) in jplan.per_offset.items():
        trb, tcb, tvals = tplan.per_offset[d]
        np.testing.assert_array_equal(trb.numpy(), rb)
        np.testing.assert_array_equal(tcb.numpy(), cb)
        np.testing.assert_array_equal(tvals.numpy(), np.asarray(vals))
    assert (tplan.bh, tplan.bw, tplan.b, tplan.rows, tplan.cols) == (
        jplan.bh, jplan.bw, jplan.b, jplan.rows, jplan.cols)
    assert tplan.density == jplan.density
    got = trl.rmcdb_roll_matmul(torch.from_numpy(x), tplan).numpy()
    want = np.asarray(jrl.rmcdb_roll_matmul(jnp.asarray(x), jplan))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, x @ (w * mask).T, rtol=1e-5, atol=1e-4)


def test_bf16_plan_matmul_against_masked_dense():
    w, mask, x = _case(7, *CASES[0])
    plan = trl.detect_rmcdb_rolls(w, mask, 64, 64, 8)  # bf16 values, the bench's
    assert plan.per_offset[next(iter(plan.per_offset))][2].dtype == torch.bfloat16
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = trl.rmcdb_roll_matmul(xb, plan)
    assert y.dtype == torch.bfloat16 and y.shape == (48, 256)
    ref = xb.float() @ (torch.from_numpy(w * mask).to(torch.bfloat16).float()).T
    # bf16 rounds each diagonal's einsum and each index_add_ (2 diagonals
    # here): four roundings of at most 2^-8 relative, against max |y|
    err = float((y.float() - ref).abs().max())
    assert err <= 4 * 2.0 ** -8 * float(ref.abs().max()), err
    with pytest.raises(ValueError, match="x must be"):
        trl.rmcdb_roll_matmul(xb[:, :128], plan)


def test_rejects_partial_diagonal():
    w, mask, _ = _case(2, 128, 128, 32, 4, 2, 0.0)
    live = np.argwhere(mask != 0)
    r0, c0 = live[0]
    mask[(r0 // 4) * 4:(r0 // 4 + 1) * 4, (c0 // 4) * 4:(c0 // 4 + 1) * 4] = 0.0
    assert trl.detect_rmcdb_rolls(w, mask, 32, 32, 4) is None
    assert jrl.detect_rmcdb_rolls(w, mask, 32, 32, 4) is None


@pytest.mark.parametrize("geom", [(48, 64, 8), (64, 64, 12), (64, 32, 8), (64, 64, 8)])
def test_rejects_geometry(geom):
    """Rows not divided by bh, b not dividing bh, non-square blocklet
    grids: None in both packages; an all-zero mask: None too."""
    w, mask, _ = _case(3, 256, 256, 64, 8, 2, 0.0)
    if geom == (64, 64, 8):
        mask = np.zeros_like(mask)
    assert trl.detect_rmcdb_rolls(w, mask, *geom) is None
    assert jrl.detect_rmcdb_rolls(w, mask, *geom) is None
