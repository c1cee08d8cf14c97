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
