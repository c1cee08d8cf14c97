"""The port's sparse text formats (``tpuseg_torch.sparsity.formats``): the
BSR, RMB and RMCDB files it writes are byte-identical to ``tpuseg``'s on
the same seeded weights, each package's blocklets from its own masker."""

import numpy as np
import pytest

from tpuseg.sparsity import formats as jformats
from tpuseg.sparsity import rmb as jrmb
from tpuseg.sparsity import rmcdb as jrmcdb
from tpuseg_torch.sparsity import formats as tformats
from tpuseg_torch.sparsity import rmb as trmb
from tpuseg_torch.sparsity import rmcdb as trmcdb


def _bytes(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("shape,bh,bw,density", [
    ((32, 64), 8, 8, 0.3), ((48, 80), 8, 16, 0.5), ((16, 16), 1, 1, 0.2),
    ((64, 96), 16, 32, 0.25)])
def test_bsr_file_byte_identical(tmp_path, shape, bh, bw, density):
    rng = np.random.default_rng(sum(shape) + bh)
    mat = rng.normal(size=shape).astype(np.float32)
    mat[rng.random(shape) > density] = 0.0
    mat[: min(bh, shape[0]), : min(bw, shape[1])] = 0.0  # an empty block
    jbm, tbm = jformats.to_block_matrix(mat, bh, bw), tformats.to_block_matrix(mat, bh, bw)
    for field in ("values", "indices", "rowBlockPtr"):
        np.testing.assert_array_equal(getattr(tbm, field), getattr(jbm, field))
    jformats.write_block_matrix(jbm, tmp_path / "j.txt")
    tformats.write_block_matrix(tbm, tmp_path / "t.txt")
    assert _bytes(tmp_path / "t.txt") == _bytes(tmp_path / "j.txt")


@pytest.mark.parametrize("shape,bh,bw,spo,types,counts", [
    ((16, 16), 8, 8, 0.5, [(2, 2), (1, 1)], [1, 2]),
    ((32, 64), 16, 16, 0.25, [(4, 4)], [2]),
    ((64, 32), 16, 8, 0.0, [(2, 2), (4, 2)], [1, 1])])
def test_rmb_file_byte_identical(tmp_path, shape, bh, bw, spo, types, counts):
    rng = np.random.default_rng(shape[0] * 7 + bh)
    mat = rng.normal(size=shape)
    jcfg = jrmb.RmbConfig(bh, bw, spo, [jrmb.BlockletType(*t) for t in types], counts)
    tcfg = trmb.RmbConfig(bh, bw, spo, [trmb.BlockletType(*t) for t in types], counts)
    jmask, jbls = jrmb.prune_as_rmb(mat, jcfg, collect=True)
    tmask, tbls = trmb.prune_as_rmb(mat, tcfg, collect=True)
    np.testing.assert_array_equal(tmask, jmask)
    assert len(tbls) == len(jbls) > 0
    jformats.write_rmb_matrix(*shape, bh, bw, jbls, tmp_path / "j.txt")
    tformats.write_rmb_matrix(*shape, bh, bw, tbls, tmp_path / "t.txt")
    assert _bytes(tmp_path / "t.txt") == _bytes(tmp_path / "j.txt")


@pytest.mark.parametrize("shape,bh,bw,spo,b,count", [
    ((128, 128), 32, 32, 0.0, 4, 2), ((64, 128), 32, 32, 0.5, 8, 1),
    ((256, 256), 64, 64, 0.25, 8, 3)])
def test_rmcdb_file_byte_identical(tmp_path, shape, bh, bw, spo, b, count):
    rng = np.random.default_rng(shape[1] + b)
    mat = rng.normal(size=shape)
    jcfg = jrmcdb.RmcdbConfig(bh, bw, spo, [jrmcdb.BlockletType(b, b)], [count])
    tcfg = trmcdb.RmcdbConfig(bh, bw, spo, [trmcdb.BlockletType(b, b)], [count])
    jmask, jbls = jrmcdb.prune_as_rmcdb(mat, jcfg, collect=True)
    tmask, tbls = trmcdb.prune_as_rmcdb(mat, tcfg, collect=True)
    np.testing.assert_array_equal(tmask, jmask)
    assert len(tbls) == len(jbls) > 0
    jformats.write_rmcdb_matrix(*shape, bh, bw, jbls, tmp_path / "j.txt")
    tformats.write_rmcdb_matrix(*shape, bh, bw, tbls, tmp_path / "t.txt")
    assert _bytes(tmp_path / "t.txt") == _bytes(tmp_path / "j.txt")


def test_formats_exported():
    import tpuseg_torch.sparsity as tsp

    assert tsp.formats is tformats
