"""The port's native sparsity library (``tpuseg_torch.native`` on
``native/sparsity.cpp``, built by ``tpuseg_torch.native_build`` into
``tpuseg_torch/_build/``): each entry point equal to the port's numpy
paths and to ``tpuseg``'s numpy maskers on seeded inputs; the rmb masker
gives equal masks with ``use_native`` on and off; the library loaded is
the keyed build, never ``native/libtpuseg_sparsity.so``; a failed build
raises with the compiler's output."""

import os

import numpy as np
import pytest
import torch

from tpuseg.sparsity import block as jblock
from tpuseg.sparsity import rmb as jrmb
from tpuseg_torch import native, native_build
from tpuseg_torch.ops.bsr import pack_bsr
from tpuseg_torch.sparsity import block as tblock
from tpuseg_torch.sparsity import rmb as trmb


@pytest.mark.parametrize("shape,bh,bw", [((64, 96), 8, 16), ((30, 50), 8, 16),
                                         ((128, 1152), 128, 128)])
def test_block_abs_sums(shape, bh, bw):
    mat = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = native.block_abs_sums(mat, bh, bw)
    np.testing.assert_allclose(got, tblock.block_abs_sums(mat, bh, bw), rtol=1e-6)
    np.testing.assert_allclose(got, jblock.block_abs_sums(mat, bh, bw), rtol=1e-6)


@pytest.mark.parametrize("bh,bw,sp", [(2, 2, 0.5), (1, 1, 0.75), (4, 8, 0.25), (8, 8, 0.875)])
def test_prune_block_mask(bh, bw, sp):
    mat = np.random.default_rng(2).normal(size=(32, 64)).astype(np.float32)
    got = native.prune_block_mask(mat, bh, bw, sp)
    m64 = mat.astype(np.float64)
    np.testing.assert_array_equal(
        got, tblock.prune_as_block(m64, tblock.BlockConfig(sp, bh, bw, -1, -1, True)))
    np.testing.assert_array_equal(
        got, jblock.prune_as_block(m64, jblock.BlockConfig(sp, bh, bw, -1, -1, True)))


@pytest.mark.parametrize("shape,bh,bw,spo,types,counts", [
    ((16, 16), 8, 8, 0.5, [(2, 2), (1, 1)], [1, 2]),
    ((64, 288), 32, 32, 0.25, [(4, 4)], [2]),
    ((512, 4608), 64, 64, 0.5, [(2, 2)], [8])])
def test_rmb_prune(shape, bh, bw, spo, types, counts):
    mat = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    got = native.rmb_prune(mat, bh, bw, spo, [trmb.BlockletType(*t) for t in types], counts)
    tmask, _ = trmb.prune_as_rmb(mat.astype(np.float64), trmb.RmbConfig(
        bh, bw, spo, [trmb.BlockletType(*t) for t in types], counts))
    jmask, _ = jrmb.prune_as_rmb(mat.astype(np.float64), jrmb.RmbConfig(
        bh, bw, spo, [jrmb.BlockletType(*t) for t in types], counts))
    np.testing.assert_array_equal(got, tmask.astype(np.float32))
    np.testing.assert_array_equal(got, jmask.astype(np.float32))


def test_bsr_pack():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(256, 512)).astype(np.float32)
    coarse = (rng.random((2, 4)) < 0.5).astype(np.float32)
    coarse[0, 0] = 1
    mask = np.kron(coarse, np.ones((128, 128), np.float32))
    vals, rowptr, colidx = native.bsr_pack(w * mask, 128, 128)
    ref = pack_bsr(w, mask, 128, 128, dtype=torch.float32)
    np.testing.assert_array_equal(rowptr, ref.rowptr)
    np.testing.assert_array_equal(colidx, ref.colidx)
    np.testing.assert_array_equal(vals, ref.vals.numpy())
    with pytest.raises(ValueError, match="divide"):
        native.bsr_pack(w[:200], 128, 128)


RMB_CONFIG = {"pruner_type": "rmb", "configs": [
    {"layer_set": ["a.weight"], "global_bh": 32, "global_bw": 32, "global_sp": 0.5,
     "blocklets": [{"bh": 2, "bw": 2, "count": 2}]},
    {"layer_set": ["b.weight"], "global_bh": 16, "global_bw": 16, "global_sp": 0.25,
     "blocklets": [{"bh": 4, "bw": 4, "count": 1}, {"bh": 1, "bw": 1, "count": 2}]}]}


def test_rmb_masker_native_on_and_off(monkeypatch):
    from tpuseg.sparsity import create_masker as jcreate
    from tpuseg_torch.models.weights import to_jax_params
    from tpuseg_torch.sparsity import create_masker

    rng = np.random.default_rng(5)
    params = {"a.weight": torch.from_numpy(rng.normal(size=(64, 32, 3, 3)).astype(np.float32)),
              "b.weight": torch.from_numpy(rng.normal(size=(128, 64, 1, 1)).astype(np.float32))}
    assert trmb.RmbMasker.use_native  # tpuseg's default
    got_native = create_masker(RMB_CONFIG, seed=0).generate_masks(params, is_static=False)
    monkeypatch.setattr(trmb.RmbMasker, "use_native", False)
    got_numpy = create_masker(RMB_CONFIG, seed=0).generate_masks(params, is_static=False)
    # tpuseg's numpy path (its native one may be mid-rebuild by test_native.py)
    monkeypatch.setattr(jrmb.RmbMasker, "use_native", False)
    want = jcreate(RMB_CONFIG, seed=0).generate_masks(to_jax_params(params)[0], is_static=False)
    assert set(got_native) == set(got_numpy) == set(want) == {"a.weight", "b.weight"}
    for k in want:
        assert got_native[k].sum() > 0
        torch.testing.assert_close(got_native[k], got_numpy[k], rtol=0, atol=0)
        np.testing.assert_array_equal(got_native[k].numpy().transpose(2, 3, 1, 0), want[k])


def test_library_is_the_keyed_build():
    path = os.path.realpath(native.so_path())
    assert os.path.dirname(path) == os.path.realpath(native_build.BUILD_DIR)
    assert path == os.path.realpath(native_build.sparsity_path())
    assert os.path.basename(path).startswith("libtpuseg_sparsity_")


def test_failed_build_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="build failed"):
        native_build.build_sparsity(src=str(bad), build_dir=str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="not found"):
        native_build.build_sparsity(src=str(tmp_path / "missing.cpp"),
                                    build_dir=str(tmp_path / "build"))
    assert not os.path.exists(tmp_path / "build") or not any(
        n.endswith(".so") for n in os.listdir(tmp_path / "build"))
