"""The port's directory checkpoint envelope (``.orbax`` paths,
``tpuseg_torch.train.orbax_ckpt``, written with
``torch.distributed.checkpoint``) against ``tpuseg``'s orbax envelope:
the tuple round-trips; a committed ``.new`` is preferred, an uncommitted
one removed, ``.old`` the fallback; the best copy; two gloo ranks save
together without deadlock; a directory orbax wrote is refused with a
message naming npz; and one train step saved by each package's envelope
and loaded by that package gives the same flat keys, metadata and values
(within the one-step tolerance of ``tests/test_torch_train_step.py``)."""

import os
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _state(epoch=1):
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.train import create_train_state, make_sgd

    params, state, _ = init_drnseg(0, "drn_d_22", 19)
    params = {k: v + epoch for k, v in params.items()}
    masks = {"layer.6.0.conv1.weight": (params["layer.6.0.conv1.weight"] > epoch).float()}
    ts = create_train_state(params, state, make_sgd(0.01), masks)
    return ts, {"epoch": epoch, "arch": "drn_d_22"}


def _save(path, epoch=1, **kw):
    from tpuseg_torch.train import save_checkpoint

    ts, meta = _state(epoch)
    save_checkpoint(path, ts.params, ts.bn_state, opt_state=ts.opt_state, masks=ts.masks,
                    meta=meta, **kw)
    return ts, meta


def test_round_trip_equals_npz(tmp_path):
    """The directory envelope's tuple equals the npz envelope's, array for
    array, and an async save lands once ``wait_for_saves`` returns."""
    from tpuseg_torch.train import load_checkpoint
    from tpuseg_torch.train.orbax_ckpt import wait_for_saves

    _save(str(tmp_path / "c.npz"))
    _save(str(tmp_path / "c.orbax"), async_save=True)
    wait_for_saves()
    assert sorted(os.listdir(tmp_path / "c.orbax"))[0] == ".metadata"
    a, b = load_checkpoint(str(tmp_path / "c.npz")), load_checkpoint(str(tmp_path / "c.orbax"))
    for part_a, part_b in zip(a[:3], b[:3]):
        assert part_a.keys() == part_b.keys()
        for k in part_a:
            assert torch.equal(part_a[k], part_b[k]), k
    assert a[3].keys() == b[3].keys() and a[4] == b[4] == {"epoch": 1, "arch": "drn_d_22"}
    for k in a[3]:
        np.testing.assert_array_equal(a[3][k], b[3][k])


def test_new_old_recovery(tmp_path):
    """A committed ``.new`` (a crash between commit and swap) is newer than
    the path and wins; ``.old`` serves when the path is gone; a save
    removes an uncommitted ``.new`` and rescues a committed one."""
    from tpuseg_torch.train import load_checkpoint

    path = str(tmp_path / "checkpoint.orbax")
    _save(path, epoch=1)
    _save(str(tmp_path / "other.orbax"), epoch=2)
    shutil.move(str(tmp_path / "other.orbax"), path + ".new")
    assert load_checkpoint(path)[4]["epoch"] == 2
    # the next save swaps the committed .new in first, then lands its own
    _save(path, epoch=3)
    assert not os.path.exists(path + ".new")
    assert load_checkpoint(path)[4]["epoch"] == 3
    # an uncommitted .new (no .metadata) is ignored on load, removed on save
    os.makedirs(path + ".new")
    open(os.path.join(path + ".new", "__0_0.distcp"), "wb").close()
    assert load_checkpoint(path)[4]["epoch"] == 3
    _save(path, epoch=4)
    assert not os.path.exists(path + ".new")
    assert load_checkpoint(path)[4]["epoch"] == 4
    # the path gone: .old is the fallback
    shutil.move(path, path + ".old")
    assert load_checkpoint(path)[4]["epoch"] == 4


def test_best_copy(tmp_path):
    from tpuseg_torch.train import load_checkpoint

    path = str(tmp_path / "checkpoint.orbax")
    _save(path, epoch=1, is_best=True, async_save=True)
    _save(path, epoch=2, async_save=True)
    from tpuseg_torch.train.orbax_ckpt import wait_for_saves

    wait_for_saves()
    assert load_checkpoint(str(tmp_path / "checkpoint_best.orbax"))[4]["epoch"] == 1
    assert load_checkpoint(path)[4]["epoch"] == 2


def _ranked_save(path):
    """Both ranks save the same replica twice (async, the first as best),
    then wait."""
    from tpuseg_torch.train.orbax_ckpt import wait_for_saves

    _save(path, epoch=1, is_best=True, async_save=True)
    _save(path, epoch=2, async_save=True)
    wait_for_saves()
    return sorted(os.listdir(os.path.dirname(path)))


def test_two_ranks_save(tmp_path):
    """Every rank calls save (DCP's plan and commit are collective); rank 0
    alone moves directories, between barriers: no deadlock, one committed
    checkpoint and its best copy."""
    from tpuseg_torch.parallel.mesh import spawn_ranks
    from tpuseg_torch.train import load_checkpoint

    path = str(tmp_path / "ranks" / "checkpoint.orbax")
    listings = spawn_ranks(_ranked_save, 2, "cpu", args=(path,), timeout=180)
    assert listings[0] == listings[1] == ["checkpoint.orbax", "checkpoint_best.orbax"]
    ts, _ = _state(2)
    params, _, masks, _, meta = load_checkpoint(path)
    assert meta["epoch"] == 2
    assert all(torch.equal(params[k], ts.params[k]) for k in ts.params)
    assert torch.equal(masks["layer.6.0.conv1.weight"], ts.masks["layer.6.0.conv1.weight"])


def _jax_one_step(path):
    """tpuseg: one f32 step of DRN-D-22 at 2x32x32 saved with its orbax
    envelope; returns its flat arrays as tpuseg loads them."""
    import jax
    import jax.numpy as jnp

    from tpuseg.models import init_drnseg
    from tpuseg.train import create_train_state, load_checkpoint, make_seg_train_step
    from tpuseg.train import make_sgd, save_checkpoint

    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    tx = make_sgd(0.01, weight_decay=0.0)
    images, labels = _batch()
    ts, _ = jax.jit(make_seg_train_step(spec, tx, compute_dtype=None))(
        create_train_state(params, state, tx), jnp.asarray(images), jnp.asarray(labels))
    save_checkpoint(path, ts.params, ts.bn_state, opt_state=ts.opt_state,
                    meta={"epoch": 1, "arch": "drn_d_22"})
    return load_checkpoint(path)


def _batch():
    rng = np.random.default_rng(0)
    return (rng.random((2, 32, 32, 3), dtype=np.float32),
            rng.integers(0, 19, size=(2, 32, 32)).astype(np.int64))


def test_same_step_both_envelopes(tmp_path):
    """One step saved by tpuseg's orbax envelope (loaded by tpuseg) and by
    the port's (loaded by the port, conv weights HWIO as on disk): the
    same keys, metadata and values; and the port refuses tpuseg's directory
    with a message naming npz."""
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.train import create_train_state, load_checkpoint, make_seg_train_step
    from tpuseg_torch.train import make_sgd, save_checkpoint
    from tpuseg_torch.train.orbax_ckpt import load_arrays_orbax

    jpath = str(tmp_path / "jax" / "checkpoint.orbax")
    jp, jb, _, jopt, jmeta = _jax_one_step(jpath)
    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    tx = make_sgd(0.01, weight_decay=0.0)
    ts, _ = make_seg_train_step(spec, tx, compute_dtype=None)(
        create_train_state(params, state, tx), *(torch.from_numpy(a) for a in _batch()))
    tpath = str(tmp_path / "torch" / "checkpoint.orbax")
    save_checkpoint(tpath, ts.params, ts.bn_state, opt_state=ts.opt_state,
                    meta={"epoch": 1, "arch": "drn_d_22"})
    flat = load_arrays_orbax(tpath)
    assert load_checkpoint(tpath)[4] == jmeta == {"epoch": 1, "arch": "drn_d_22"}
    want = {**{f"params/{k}": v for k, v in jp.items()},
            **{f"bn_state/{k}": v for k, v in jb.items()},
            **{f"opt/{k}": v for k, v in jopt.items()}}
    assert sorted(want) == sorted(k for k in flat if k != "__meta__")
    for k, v in want.items():
        v = np.asarray(v)
        assert flat[k].shape == v.shape and flat[k].dtype == v.dtype, k
        np.testing.assert_allclose(flat[k], v, rtol=2e-3, atol=5e-4, err_msg=k)
    with pytest.raises(SystemExit, match="npz"):
        load_checkpoint(jpath)
