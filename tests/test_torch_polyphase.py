"""Port parity: tpuseg_torch.ops.polyphase against tpuseg.ops.polyphase and
against the direct (unfolded) stem, in f32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.models import drnseg as jseg
from tpuseg.ops import polyphase as jpoly
from tpuseg.ops.fold_bn import fold_bn as jfold
from tpuseg_torch.models import drn as tdrn
from tpuseg_torch.models.weights import from_jax_params
from tpuseg_torch.ops import polyphase as tpoly

torch.set_num_threads(2)

MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]


def _assert_close(out, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("f", [2, 4])
def test_space_to_depth_flat_bit_equal(f):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(2, 16, 24 * 3), dtype=np.uint8)
    ref = np.asarray(jpoly.space_to_depth_flat(jnp.asarray(x), f))
    out = tpoly.space_to_depth_flat(torch.from_numpy(x), f).numpy()
    np.testing.assert_array_equal(out, ref)
    # the 4-D form moves the same bytes
    x4 = torch.from_numpy(x.reshape(2, 16, 24, 3))
    np.testing.assert_array_equal(tpoly.space_to_depth(x4, f).numpy(), ref)
    np.testing.assert_array_equal(
        tpoly.depth_to_space(torch.from_numpy(ref), f).numpy(),
        x.reshape(2, 16, 24, 3))


def test_fold_conv_poly_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    for args in [(1, 1, 4, 4), (2, 1, 4, 2), (2, 1, 2, 1), (2, 0, 2, 1)]:
        wj, *pj = jpoly.fold_conv_poly(w, *args)
        wt, *pt = tpoly.fold_conv_poly(w, *args)
        np.testing.assert_array_equal(wt, wj)
        assert pt == pj


def _frontend_world(arch, seed, h, w):
    params, state, spec = jseg.init_drnseg(0, arch, 19)
    folded = jfold(params, state, spec)
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(2, h, w * 3), dtype=np.uint8)
    tp, _ = from_jax_params(folded)
    tspec = tdrn.build_drn_spec(arch, 0, naming="seg")
    return folded, spec, frames, tp, tspec


@pytest.mark.parametrize("arch,cls,stages", [
    ("drn_d_54", "PolyphaseFrontend", 3),
    ("drn_d_22", "FusedStage3Frontend", 4),
])
def test_frontend_matches_jax_and_direct_stem(arch, cls, stages):
    folded, spec, frames, tp, tspec = _frontend_world(arch, 2, 32, 48)
    jfe = getattr(jpoly, cls)(folded, dtype=jnp.float32, normalize=(MEAN, STD))
    tfe = getattr(tpoly, cls)(tp, device="cpu", dtype=torch.float32,
                              normalize=(MEAN, STD))
    ref = np.asarray(jfe(jnp.asarray(frames)))
    out = tfe(torch.from_numpy(frames))
    _assert_close(out.numpy(), ref)
    # the direct (unfolded) stages compute the same function
    x = (torch.from_numpy(frames).reshape(2, 32, 48, 3).float() / 255.0
         - torch.tensor(MEAN)) / torch.tensor(STD)
    direct = tdrn.nhwc_to_nchw(x)
    for _, stage in tspec.stages[:stages]:
        direct = tdrn._run_stage(direct, tp, {}, stage, None)
    _assert_close(out.numpy(), tdrn.nchw_to_nhwc(direct).numpy())


def test_fused_frontend_rejects_deeper_stage3():
    folded, _, _, tp, _ = _frontend_world("drn_d_54", 3, 16, 16)
    with pytest.raises(ValueError, match="two basic blocks"):
        tpoly.FusedStage3Frontend(tp, device="cpu", dtype=torch.float32)


def test_frontend_bf16_keeps_dtype_and_layout():
    _, _, frames, tp, _ = _frontend_world("drn_d_22", 4, 32, 32)
    fe = tpoly.FusedStage3Frontend(tp, device="cpu", normalize=(MEAN, STD))
    out = fe(torch.from_numpy(frames))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 8, 8, 64)
    assert out.is_contiguous()


@pytest.mark.parametrize("f_from,f_to", [(4, 2), (4, 1), (2, 1), (4, 4)])
def test_refold_bit_equal(f_from, f_to):
    """refold moves the same bytes as tpuseg's (and s2d(f_from) + refold ==
    s2d(f_to))."""
    x = np.random.default_rng(7).normal(size=(2, 16, 24, 3)).astype(np.float32)
    j = np.asarray(jpoly.refold(jpoly.space_to_depth(jnp.asarray(x), f_from), f_from, f_to))
    t = tpoly.refold(tpoly.space_to_depth(torch.from_numpy(x), f_from), f_from, f_to).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, tpoly.space_to_depth(torch.from_numpy(x), f_to).numpy())


@pytest.mark.parametrize("args", [(2, 1, 4, 2), (2, 1, 2, 2), (1, 1, 4, 4), (2, 0, 2, 2),
                                  (4, 3, 4, 2), (2, 3, 1, 1)])
def test_fold_conv_poly_general_bit_equal(args):
    w = np.random.default_rng(11).normal(size=(3, 3, 2, 5)).astype(np.float32)
    if args == (2, 3, 1, 1):
        w = np.random.default_rng(11).normal(size=(7, 7, 2, 5)).astype(np.float32)
    wj, *pj = jpoly.fold_conv_poly_general(w, *args)
    wt, *pt = tpoly.fold_conv_poly_general(w, *args)
    np.testing.assert_array_equal(wt, wj)
    assert pt == pj


@pytest.mark.parametrize("f,pad", [(2, 3), (4, 3), (4, 1)])
def test_fold_stem_weights_bit_equal(f, pad):
    w7 = np.random.default_rng(12).normal(size=(7, 7, 3, 16)).astype(np.float32)
    wj, *pj = jpoly.fold_stem_weights(w7, f, pad)
    wt, *pt = tpoly.fold_stem_weights(w7, f, pad)
    np.testing.assert_array_equal(wt, wj)
    assert pt == pj


@pytest.mark.parametrize("f", [2, 4])
def test_polyphase_stem_matches_jax_and_direct(f):
    """PolyphaseStem == tpuseg's PolyphaseStem and == the direct 7x7 conv +
    bias, f32 (``tests/test_polyphase.py``'s 1e-4), from (n, h, w, 3)
    frames and from flat rows."""
    rng = np.random.default_rng(1)
    w7 = rng.normal(size=(7, 7, 3, 16)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    x = rng.normal(size=(1, 32, 64, 3)).astype(np.float32)
    ref = np.asarray(jpoly.PolyphaseStem(w7, bias, f=f, dtype=jnp.float32)(jnp.asarray(x)))
    w_oihw = torch.from_numpy(np.ascontiguousarray(w7.transpose(3, 2, 0, 1)))
    stem = tpoly.PolyphaseStem(w_oihw, bias, f=f, dtype=torch.float32)
    out = stem(torch.from_numpy(x)).numpy()
    _assert_close(out, ref)
    direct = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w_oihw,
                                        torch.from_numpy(bias), padding=3)
    _assert_close(out, direct.permute(0, 2, 3, 1).numpy())
    flat = torch.from_numpy(x.reshape(1, 32, 64 * 3))
    np.testing.assert_array_equal(stem(flat).numpy(), out)
    with pytest.raises(ValueError, match="fold factor"):
        stem(torch.zeros(1, 31, 64, 3))
