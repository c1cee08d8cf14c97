"""Train-step parity of the port (``tpuseg_torch.train.make_seg_train_step``)
against ``tpuseg``'s masked-dense step: DRN-D-22 DRNSeg at 64x64, batch 2,
f32, two SGD steps at lr 0.005 with the block128reg_87.50 masks, the port
both masked-dense and with ``--sparse-exec`` (its 10 eligible convs through
``sparse_conv_train``; on CPU tensors B2's plain version).  Tolerances are
``tests/test_sparse_train.py``'s: loss rtol 1e-3, params and BN state rtol
2e-3 / atol 5e-4, masked positions exactly 0."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.sparsity import create_masker as j_create_masker
from tpuseg.train import create_train_state as j_create_train_state
from tpuseg.train import make_seg_train_step as j_make_seg_train_step
from tpuseg.train import make_sgd as j_make_sgd
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.models.weights import from_jax_params
from tpuseg_torch.ops import sparse_train as tst
from tpuseg_torch.sparsity import create_masker
from tpuseg_torch.train import create_train_state, make_seg_train_step, make_sgd

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REG = os.path.join(REPO, "optimal_configs", "drn_d_22", "drn_d_22_block128reg_87.50.json")
LR = 0.005


def _batches():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        images = rng.random((2, 64, 64, 3), dtype=np.float32)
        labels = rng.integers(0, 19, size=(2, 64, 64)).astype(np.int32)
        labels[rng.random(labels.shape) < 0.05] = 255
        out.append((images, labels))
    return out


@pytest.fixture(scope="module")
def tpuseg_masked_dense():
    """tpuseg's masked-dense trajectory: (losses, params, bn_state) in the
    port's layout."""
    params, state, spec = j_init(0, "drn_d_22", 19)
    masks = j_create_masker(REG, seed=0).generate_masks(params, is_static=True)
    tx = j_make_sgd(lambda _: LR, 0.9, 1e-4)
    ts = j_create_train_state(params, state, tx, masks)
    step = jax.jit(j_make_seg_train_step(spec, tx, compute_dtype=None))
    losses = []
    for images, labels in _batches():
        ts, m = step(ts, jnp.asarray(images), jnp.asarray(labels))
        losses.append(float(m["loss"]))
    p, s = from_jax_params({k: np.asarray(v) for k, v in ts.params.items()},
                           {k: np.asarray(v) for k, v in ts.bn_state.items()})
    return losses, p, s


def _port_run(sparse_exec: bool, remat: bool = False):
    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    masks = create_masker(REG, seed=0).generate_masks(params)
    plans = None
    if sparse_exec:
        structs, report = tst.build_sparse_train_structs(masks, spec)
        assert len(structs) == 10, report
        plans = {k: st.to("cpu") for k, st in structs.items()}
    tx = make_sgd(lambda _: LR, 0.9, 1e-4)
    ts = create_train_state(params, state, tx, masks)
    step = make_seg_train_step(spec, tx, compute_dtype=None, remat=remat, sparse_plans=plans)
    losses = []
    for images, labels in _batches():
        ts, m = step(ts, torch.from_numpy(images), torch.from_numpy(labels))
        losses.append(float(m["loss"]))
        for k, mask in masks.items():
            assert float((ts.params[k] * (1 - mask)).abs().max()) == 0.0, k
    return losses, ts, masks


@pytest.mark.parametrize("sparse_exec", [False, True], ids=["masked_dense", "sparse_exec"])
def test_train_steps_match_tpuseg_masked_dense(tpuseg_masked_dense, sparse_exec):
    """Two steps of the port's masked-dense and --sparse-exec steps against
    tpuseg's masked-dense step: losses, every param and BN statistic; the
    masked weights stay exactly 0 after every step."""
    want_losses, want_params, want_bn = tpuseg_masked_dense
    losses, ts, masks = _port_run(sparse_exec)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    assert sorted(ts.params) == sorted(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(ts.params[k].numpy(), v.numpy(), rtol=2e-3, atol=5e-4,
                                   err_msg=k)
    assert sorted(ts.bn_state) == sorted(want_bn)
    for k, v in want_bn.items():
        np.testing.assert_allclose(ts.bn_state[k].numpy(), v.numpy(), rtol=2e-3, atol=5e-4,
                                   err_msg=k)
    assert ts.step == 2
    # the frozen upsampler never moves
    assert torch.equal(ts.params["up.weight"], init_drnseg(0, "drn_d_22", 19)[0]["up.weight"])


def test_sparse_exec_with_remat_equals_without():
    """--remat recomputes each stage (B2's forward twice a step) and applies
    each BN momentum once: the same trajectory as without it."""
    plain, ts_plain, _ = _port_run(True)
    remat, ts_remat, _ = _port_run(True, remat=True)
    np.testing.assert_allclose(remat, plain, rtol=1e-6)
    for k in ts_plain.params:
        np.testing.assert_allclose(ts_remat.params[k].numpy(), ts_plain.params[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ts_plain.bn_state:
        np.testing.assert_allclose(ts_remat.bn_state[k].numpy(),
                                   ts_plain.bn_state[k].numpy(), rtol=1e-6, atol=0, err_msg=k)
