"""Port parity for the classification train and eval steps
(``classifier_forward``, ``make_cls_train_step``, ``make_eval_step("cls")``)
against ``tpuseg``'s, on the CPU in f32.

cifar_resnet20 at 16x16, batch 4, SGD with momentum and weight decay: the
loss, the accuracy, every BN update and every parameter after one step
(the SGD update is ``-lr * (grad + wd * p)``, so the params carry the
grads) within rtol 1e-4 of ``tpuseg``'s, with and without a KD teacher.
Three steps keep the losses within 1e-4.  The DRN-D-22 classifier step
is held the same way, unmasked, with and without KD; its masked path by
its ``--sparse-exec`` plans: the port's trajectory against its own masked
dense one (loss rtol 1e-4, phase 32's tolerance on the card), and the
plans' report against ``tpuseg``'s."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuseg.models import cifar as jcifar
from tpuseg.models.drn import build_drn_spec as j_build_drn_spec
from tpuseg.ops.sparse_train import build_sparse_train_structs as j_structs
from tpuseg.sparsity import create_masker as j_create_masker
from tpuseg.train import create_train_state as j_cts
from tpuseg.train import make_cls_train_step as j_step
from tpuseg.train import make_eval_step as j_eval
from tpuseg.train import make_sgd as j_sgd
from tpuseg.train.trainer import classifier_forward as j_cfwd
from tpuseg_torch.models import cifar as tcifar
from tpuseg_torch.models.drn import build_drn_spec, init_drn
from tpuseg_torch.models.weights import to_jax_params
from tpuseg_torch.ops.sparse_train import build_sparse_train_structs
from tpuseg_torch.sparsity import create_masker
from tpuseg_torch.train import (
    classifier_forward,
    create_train_state,
    make_cls_train_step,
    make_eval_step,
    make_sgd,
)

torch.set_num_threads(2)

RTOL = 1e-4
# the block-regular config of tests/test_cli.py's rmbsnn --sparse-exec smoke
# test: two eligible DRN-D-22 convs in classifier naming
CLS_BLOCK = {"pruner_type": "block_regular", "configs": [{
    "layer_set": ["layer6.0.conv1.weight", "layer7.0.weight"],
    "sparsity": 0.875, "block_height": 128, "block_width": 128}]}


def _batch(seed=0, n=4, size=16, classes=10):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, size, size, 3)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


def _models():
    jp, js, jspec = jcifar.create_cifar_model(0, "cifar_resnet20", 10)
    tp, ts, tspec = tcifar.create_cifar_model(0, "cifar_resnet20", 10)
    return (jp, js, jspec), (tp, ts, tspec)


def _teachers():
    """cifar_resnet20 from seed 1 as the teacher, in both packages."""
    jp, js, jspec = jcifar.create_cifar_model(1, "cifar_resnet20", 10)
    tp, ts, tspec = tcifar.create_cifar_model(1, "cifar_resnet20", 10)
    jf, tf = j_cfwd(jspec), classifier_forward(tspec)
    return ((lambda p, s, x: jf(p, s, x, train=False)[0], jp, js),
            (lambda p, s, x: tf(p, s, x, train=False)[0], tp, ts))


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * (np.abs(want).max() + 1e-12),
                               err_msg=name)


@pytest.mark.parametrize("kd", [False, True])
def test_cls_train_step_matches_tpuseg(kd):
    (jp, js, jspec), (tp, ts, tspec) = _models()
    jt, tt = _teachers() if kd else (None, None)
    jtx, ttx = j_sgd(0.05, 0.9, 1e-4), make_sgd(0.05, 0.9, 1e-4)
    jstep = jax.jit(j_step(jspec, jtx, compute_dtype=None, teacher=jt))
    tstep = make_cls_train_step(tspec, ttx, compute_dtype=None, teacher=tt)
    jst, tst = j_cts(jp, js, jtx), create_train_state(tp, ts, ttx)
    for i in range(3):
        x, y = _batch(i)
        jst, jm = jstep(jst, jnp.asarray(x), jnp.asarray(y))
        tst, tm = tstep(tst, torch.from_numpy(x), torch.from_numpy(y))
        _close(tm["loss"], jm["loss"], f"loss {i}")
        assert float(tm["acc"]) == pytest.approx(float(jm["acc"]))
        if i == 0:
            bp, bs = to_jax_params(tst.params, tst.bn_state)
            for k, v in jst.params.items():
                _close(bp[k], v, k)
            for k, v in jst.bn_state.items():
                _close(bs[k], v, k)
    assert tst.step == 3


def test_cls_train_step_remat_equals_no_remat():
    """``remat`` recomputes each stage group in the backward pass: the same
    loss, params and BN state, bit for bit on the CPU."""
    _, (tp, ts, tspec) = _models()
    tx = make_sgd(0.05)
    x, y = (torch.from_numpy(a) for a in _batch(1))
    out = []
    for remat in (False, True):
        st, m = make_cls_train_step(tspec, tx, compute_dtype=None, remat=remat)(
            create_train_state(tp, ts, tx), x, y)
        out.append((m["loss"], st.params, st.bn_state))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
    for k in out[0][2]:
        assert torch.equal(out[0][2][k], out[1][2][k]), k


def test_cls_train_step_masks_stay_zero():
    _, (tp, ts, tspec) = _models()
    masks = create_masker({"pruner_type": "block_regular", "configs": [{
        "layer_set": ["layer2.1.conv1.weight"], "sparsity": 0.5, "block_height": 8,
        "block_width": 8}]}, seed=0).generate_masks(tp)
    tx = make_sgd(0.05)
    st = create_train_state(tp, ts, tx, masks)
    x, y = (torch.from_numpy(a) for a in _batch(2))
    st, _ = make_cls_train_step(tspec, tx, compute_dtype=None)(st, x, y)
    w, m = st.params["layer2.1.conv1.weight"], masks["layer2.1.conv1.weight"]
    assert float(m.mean()) == 0.5 and torch.all(w[m == 0] == 0)


def test_eval_step_cls_matches_tpuseg():
    (jp, js, jspec), (tp, ts, tspec) = _models()
    x, y = _batch(3)
    jl, jpred = j_eval(jspec, "cls", compute_dtype=None)(jp, js, jnp.asarray(x),
                                                         jnp.asarray(y))
    tl, tpred = make_eval_step(tspec, "cls", compute_dtype=None)(
        tp, ts, torch.from_numpy(x), torch.from_numpy(y))
    _close(tl, jl)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))


def test_cifar_spec_refuses_sparse_plans():
    _, (_, _, tspec) = _models()
    with pytest.raises(ValueError, match="DrnSpec"):
        classifier_forward(tspec, sparse_plans={"layer1.0.conv1": object()})


@pytest.mark.parametrize("kd", [False, True])
def test_drn_cls_train_step_matches_tpuseg(kd):
    """The DRN-D-22 classifier step (classifier naming, the 1x1-conv head,
    cross entropy or KD from cifar_resnet20, SGD with momentum and weight
    decay) against ``tpuseg``'s at 32x32, batch 2, f32: the first step's
    loss within rtol 1e-4 and its accuracy equal (forward only), then
    every parameter and BN update after the step within rtol 1e-4 (the
    update is ``-lr * (grad + wd * p)``, so the params carry the grads).
    Unmasked: under the block-regular 87.5 % masks of ``CLS_BLOCK`` on
    4x4 maps the step is ill-conditioned in both packages (their steps
    differ by percents even with float64 convs, as BN's statistics stay
    f32 in both), so the masked step is held against the port's
    ``--sparse-exec`` plans instead (below)."""
    spec = build_drn_spec("drn_d_22", num_classes=10, naming="cls")
    jspec = j_build_drn_spec("drn_d_22", num_classes=10, naming="cls")
    tp, ts = init_drn(0, spec)
    jp, js = to_jax_params(tp, ts)
    jt, tt = _teachers() if kd else (None, None)
    jtx, ttx = j_sgd(0.01, 0.9, 1e-4), make_sgd(0.01, 0.9, 1e-4)
    x, y = _batch(5, n=2, size=32)
    jst, jm = jax.jit(j_step(jspec, jtx, compute_dtype=None, teacher=jt))(
        j_cts(jp, js, jtx), jnp.asarray(x), jnp.asarray(y))
    tst, tm = make_cls_train_step(spec, ttx, compute_dtype=None, teacher=tt)(
        create_train_state(tp, ts, ttx), torch.from_numpy(x), torch.from_numpy(y))
    _close(tm["loss"], jm["loss"], "loss")
    assert float(tm["acc"]) == float(jm["acc"])
    bp, bs = to_jax_params(tst.params, tst.bn_state)
    assert sorted(bp) == sorted(jst.params) and sorted(bs) == sorted(jst.bn_state)
    for k, v in jst.params.items():
        _close(bp[k], v, k)
    for k, v in jst.bn_state.items():
        _close(bs[k], v, k)


def test_drn_cls_sparse_exec_matches_masked_dense():
    """DRN-D-22 classifier naming: the block-regular config gives 2
    eligible convs in both packages with ``tpuseg``'s report; two f32
    steps through the plans (kernel B2's plain version on the CPU) follow
    the masked dense trajectory (loss rtol 1e-4), masked weights stay 0."""
    spec = build_drn_spec("drn_d_22", num_classes=10, naming="cls")
    params, state = init_drn(0, spec)
    masks = create_masker(CLS_BLOCK, seed=0).generate_masks(params, is_static=True)
    structs, report = build_sparse_train_structs(masks, spec)
    jspec = j_build_drn_spec("drn_d_22", num_classes=10, naming="cls")
    jp, _ = to_jax_params(params, state)
    jmasks = j_create_masker(CLS_BLOCK, seed=0).generate_masks(jp, is_static=True)
    _, jreport = j_structs(jmasks, jspec)
    assert report == jreport
    assert sorted(structs) == ["layer6.0.conv1", "layer7.0"]
    plans = {k: st.to("cpu") for k, st in structs.items()}
    tx = make_sgd(0.01)
    runs = []
    for sp in (None, plans):
        st = create_train_state(params, state, tx, masks)
        step = make_cls_train_step(spec, tx, compute_dtype=None, sparse_plans=sp)
        losses = []
        for i in range(2):
            x, y = (torch.from_numpy(a) for a in _batch(i, n=2, size=32))
            st, m = step(st, x, y)
            losses.append(float(m["loss"]))
        runs.append((losses, st))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=RTOL)
    for k, m in masks.items():
        assert torch.all(runs[1][1].params[k][m == 0] == 0), k
