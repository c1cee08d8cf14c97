"""Port parity for the BSR matmuls: tpuseg_torch.ops.bsr (packing and the
plain version of kernels B5/B6) against tpuseg.ops.bsr on the same
weights, masks and inputs.  The JAX side is the Pallas kernel in interpret
mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpuseg.ops.bsr as jbsr
from tpuseg_torch.ops import bsr as tbsr

torch.set_num_threads(2)

BM = BK = 128


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jbsr.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _random_block_mask(rng, nrb, ncb, density):
    """tests/test_bsr.py's mask: every row keeps at least one block."""
    coarse = (rng.random((nrb, ncb)) < density).astype(np.float32)
    for i in range(nrb):
        if coarse[i].sum() == 0:
            coarse[i, rng.integers(0, ncb)] = 1
    return np.kron(coarse, np.ones((BM, BK), np.float32))


def _kron(coarse):
    return np.kron(np.asarray(coarse, np.float32), np.ones((BM, BK), np.float32))


def _case(kind, seed):
    """(w, mask, x) for one case: tests/test_bsr.py's densities, ragged
    rows, a row with no block, an all-zero W."""
    rng = np.random.default_rng(seed)
    if kind.startswith("density"):
        M, K, N = 256, 512, 256
        mask = _random_block_mask(rng, M // BM, K // BK, float(kind.split("_")[1]))
    elif kind == "ragged":
        M, K, N = 384, 384, 128
        mask = _kron([[1, 0, 0], [1, 1, 1], [0, 1, 0]])
    elif kind == "empty_row":
        M, K, N = 384, 512, 256
        mask = _kron([[0, 1, 0, 1], [0, 0, 0, 0], [1, 1, 1, 0]])
    else:  # all_zero
        M, K, N = 256, 256, 128
        mask = np.zeros((M, K), np.float32)
    w = rng.normal(size=(M, K)).astype(np.float32)
    x = rng.normal(size=(K, N)).astype(np.float32)
    return w, mask, x


KINDS = ["density_0.25", "density_0.5", "density_1.0", "ragged", "empty_row", "all_zero"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_bsr_byte_equal(kind, dtype):
    w, mask, _ = _case(kind, 0)
    got = tbsr.pack_bsr(w, mask, dtype=dtype)
    want = jbsr.pack_bsr(w, mask, dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    np.testing.assert_array_equal(got.rowptr, want.rowptr)
    np.testing.assert_array_equal(got.colidx, want.colidx)
    assert got.rowptr.dtype == want.rowptr.dtype and got.colidx.dtype == want.colidx.dtype
    assert got.vals.dtype == dtype and tuple(got.vals.shape) == tuple(want.vals.shape)
    assert got.vals.float().numpy().tobytes() == np.asarray(want.vals, np.float32).tobytes()
    assert (got.nrb, got.max_nnzb_row, got.block_density) == (
        want.nrb, want.max_nnzb_row, want.block_density)
    assert got.rowptr_t.dtype == got.colidx_t.dtype == torch.int32
    np.testing.assert_array_equal(got.rowptr_t.numpy(), got.rowptr)
    if kind == "all_zero":
        assert tuple(got.vals.shape) == (0, BM, BK)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("entry", ["bsr_matmul", "bsr_matmul_gathered"])
def test_bsr_matmul_matches_jax(kind, entry):
    """f32 plans: the port's plain version vs tpuseg's interpret-mode kernel
    and the masked dense product, tpuseg's tolerance (rtol = atol = 1e-4 at
    unit-normal inputs; the sides differ only in summation order)."""
    w, mask, x = _case(kind, 1)
    packed = tbsr.pack_bsr(w, mask, dtype=torch.float32)
    jpacked = jbsr.pack_bsr(w, mask, dtype=jnp.float32)
    got = getattr(tbsr, entry)(packed, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (w.shape[0], x.shape[1])
    ref = (w * mask) @ x
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    # tpuseg's bsr_matmul cannot slice an empty vals; the port's can
    if not (kind == "all_zero" and entry == "bsr_matmul"):
        want = np.asarray(getattr(jbsr, entry)(jpacked, jnp.asarray(x), bn=128))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    if kind == "empty_row":
        assert not got[BM:2 * BM].any()
    np.testing.assert_array_equal(
        got.numpy(), tbsr.bsr_matmul_reference(packed, torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("kind", ["density_0.5", "ragged", "empty_row"])
def test_bsr_matmul_bf16_matches_jax(kind):
    """bf16 plans: within 2*K*eps of max|y| of tpuseg's kernel, K the
    contraction length (both sum exact bf16 products in f32)."""
    w, mask, x = _case(kind, 2)
    packed = tbsr.pack_bsr(w, mask, dtype=torch.bfloat16)
    jpacked = jbsr.pack_bsr(w, mask, dtype=jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tbsr.bsr_matmul(packed, xt).numpy()
    want = np.asarray(jbsr.bsr_matmul(jpacked, jnp.asarray(xt.float().numpy(), jnp.bfloat16),
                                      bn=128))
    tol = 2 * w.shape[1] * np.finfo(np.float32).eps * np.abs(want).max()
    assert np.abs(got - want).max() <= tol


def test_bsr_matmul_ragged_n_and_counts():
    """An N that is no multiple of any tile runs (tpuseg needs N % bn == 0);
    the CPU path launches nothing; a non-contiguous x and a wrong K raise."""
    w, mask, _ = _case("ragged", 3)
    packed = tbsr.pack_bsr(w, mask, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(384, 37)).astype(np.float32))
    before = (tbsr.bsr_matmul.launches, tbsr.bsr_matmul_gathered.launches)
    got = tbsr.bsr_matmul_gathered(packed, x)
    np.testing.assert_allclose(got.numpy(), (w * mask) @ x.numpy(), rtol=1e-4, atol=1e-4)
    assert (tbsr.bsr_matmul.launches, tbsr.bsr_matmul_gathered.launches) == before
    with pytest.raises(ValueError, match="contiguous"):
        tbsr.bsr_matmul(packed, torch.zeros((37, 384)).t())
    with pytest.raises(ValueError, match="K=384"):
        tbsr.bsr_matmul(packed, torch.zeros((256, 8)))
    np.testing.assert_array_equal(
        tbsr.masked_dense_matmul(w, mask, x.numpy()), (w * mask) @ x.numpy())
