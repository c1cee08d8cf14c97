"""Port parity for the trainable block-sparse conv
(``tpuseg_torch.ops.sparse_train``) against ``tpuseg.ops.sparse_train``: the
structures, both packings, and the forward and gradients of
``sparse_conv_train``, with the JAX side's Pallas kernel in interpret mode.
On CPU tensors the port runs B2's plain version."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpuseg.ops.sparse_conv as jsc
from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.ops import sparse_train as jst
from tpuseg.sparsity import create_masker as j_create_masker
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.ops import sparse_train as tst
from tpuseg_torch.ops.sparse_conv import _step_list
from tpuseg_torch.sparsity import create_masker

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REG = os.path.join(REPO, "optimal_configs", "drn_d_22", "drn_d_22_block128reg_87.50.json")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jsc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _mask(rng, kernel, cin, cout, density=0.5):
    """tests/test_sparse_train.py's mask: random 128x128 blocks (block (0, 0)
    always live), some dropped at random taps so nzsel varies per tap."""
    nz = rng.random((cin // 128, cout // 128)) < density
    nz[0, 0] = True
    m2 = np.kron(nz, np.ones((128, 128), np.float32))
    mask = np.broadcast_to(m2, (kernel, kernel, cin, cout)).copy()
    if kernel > 1:
        drop = rng.random((kernel, kernel, cin // 128, cout // 128)) < 0.3
        mask *= np.kron(1.0 - drop, np.ones((128, 128))).astype(np.float32)
    return mask.astype(np.float32)


def _oihw(a_hwio):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a_hwio).transpose(3, 2, 0, 1)))


def _struct_equal(t, j):
    for f in ("rows", "nzsel", "rows_t", "gather_t"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("kernel", "dilation", "bk", "bm", "cin", "cout", "s", "st", "rows_per_tile",
              "block_density"):
        assert getattr(t, f) == getattr(j, f), f
    assert np.array_equal(t.taps, j.taps)


@pytest.mark.parametrize("kernel,dilation,cin,cout,density", [
    (3, 2, 256, 256, 0.5), (1, 1, 256, 384, 0.5), (3, 1, 384, 256, 0.3), (3, 4, 512, 512, 0.2),
])
def test_plan_equals_tpuseg(kernel, dilation, cin, cout, density):
    mask = _mask(np.random.default_rng(kernel * 10 + dilation), kernel, cin, cout, density)
    _struct_equal(tst.plan_sparse_conv_train(mask, dilation=dilation, rows_per_tile=4),
                  jst.plan_sparse_conv_train(mask, dilation=dilation, rows_per_tile=4))


def test_build_structs_equal_tpuseg_on_block128reg():
    """build_sparse_train_structs on the full DRN-D-22 with block128reg_87.50
    masks from one seed: the same report strings and, conv for conv, the same
    structures as tpuseg's (no serving 1x1 rule: every eligible conv is
    planned)."""
    jp, _, jspec = j_init(0, "drn_d_22", 19)
    jmasks = j_create_masker(REG, seed=0).generate_masks(jp, is_static=True)
    tp, _, tspec = init_drnseg(0, "drn_d_22", 19)
    tmasks = create_masker(REG, seed=0).generate_masks(tp)
    jstructs, jreport = jst.build_sparse_train_structs(jmasks, jspec)
    tstructs, treport = tst.build_sparse_train_structs(tmasks, tspec)
    assert treport == jreport
    assert sorted(tstructs) == sorted(jstructs) and len(tstructs) == 10
    for name in jstructs:
        _struct_equal(tstructs[name], jstructs[name])


@pytest.mark.parametrize("kernel,dilation", [(3, 2), (1, 1)])
def test_packings_equal_tpuseg(kernel, dilation):
    """pack_vals and _transpose_vals bit-equal to tpuseg's, f32 and bf16."""
    rng = np.random.default_rng(3)
    cin, cout = 256, 384
    mask = _mask(rng, kernel, cin, cout)
    w = rng.normal(size=(kernel, kernel, cin, cout)).astype(np.float32)
    jst_ = jst.plan_sparse_conv_train(mask, dilation=dilation)
    plan = tst.plan_sparse_conv_train(mask, dilation=dilation).to("cpu")
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jv = jst.pack_vals(jnp.asarray(w), jst_, dtype=jdt)
        tv = tst.pack_vals(_oihw(w), plan, dtype=tdt)
        assert tv.dtype == tdt and tuple(tv.shape) == jv.shape
        assert np.array_equal(tv.float().numpy(), np.asarray(jv, np.float32))
        jt = jst._transpose_vals(jv, jst_)
        tt = tst._transpose_vals(tv, plan)
        assert tuple(tt.shape) == jt.shape
        assert np.array_equal(tt.float().numpy(), np.asarray(jt, np.float32))


def test_steps_come_from_the_structure():
    """Both packings' live steps are the structure's (nzsel; gather_t !=
    sentinel), whatever the weights: a live tile of all-zero weights is a
    step, and the padded slots and dead taps are not."""
    rng = np.random.default_rng(5)
    mask = _mask(rng, 3, 256, 256)
    st = tst.plan_sparse_conv_train(mask, dilation=2)
    plan = st.to("cpu")
    T, nmb, nkb = 9, 2, 2
    want, want_n = _step_list(st.nzsel.reshape(nmb, T * st.s) != 0)
    assert torch.equal(plan.steps, want) and torch.equal(plan.nsteps, want_n)
    sentinel = nmb * T * st.s
    want_t, want_nt = _step_list(st.gather_t.reshape(nkb, T * st.st) != sentinel)
    assert torch.equal(plan.steps_t, want_t) and torch.equal(plan.nsteps_t, want_nt)
    assert int(plan.nsteps.sum()) == int(st.nzsel.sum())
    assert int(plan.nsteps_t.sum()) == int((st.gather_t != sentinel).sum())


def _grads_tpuseg(x, w, dy, mask, dilation):
    st = jst.plan_sparse_conv_train(mask, dilation=dilation, rows_per_tile=4)

    def f(w_, x_):
        y = jst.sparse_conv_train(x_, w_, st, compute_dtype=jnp.float32)
        return jnp.sum(y * dy), y

    (_, y), (gw, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(w), jnp.asarray(x))
    return np.asarray(y), np.asarray(gx), np.asarray(gw).transpose(3, 2, 0, 1)


def _grads_port(x, w_oihw, dy, plan, dtype=torch.float32):
    xt = torch.from_numpy(x).requires_grad_()
    wt = w_oihw.clone().requires_grad_()
    y = tst.sparse_conv_train(xt, wt, plan, compute_dtype=dtype)
    (y * torch.from_numpy(dy)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("kernel,dilation", [(3, 1), (3, 2), (1, 1), (1, 2)])
def test_forward_and_grads_match_tpuseg(kernel, dilation):
    """y, dx and dW of sparse_conv_train at 256->256 channels against
    tpuseg's (its fused kernel in interpret mode), f32: rtol 1e-4, atol
    1e-4 (f32 sums of up to 2304 products in other orders)."""
    rng = np.random.default_rng(kernel * 7 + dilation)
    cin = cout = 256
    mask = _mask(rng, kernel, cin, cout)
    w = (rng.normal(size=(kernel, kernel, cin, cout)) * np.sqrt(2 / (kernel * kernel * cin))
         ).astype(np.float32)
    x = rng.normal(size=(2, 8, 16, cin)).astype(np.float32)
    dy = rng.normal(size=(2, 8, 16, cout)).astype(np.float32)
    jy, jgx, jgw = _grads_tpuseg(x, w, dy, mask, dilation)
    plan = tst.plan_sparse_conv_train(mask, dilation=dilation, rows_per_tile=4).to("cpu")
    ty, tgx, tgw = _grads_port(x, _oihw(w), dy, plan)
    np.testing.assert_allclose(ty, jy, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tgx, jgx, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tgw, jgw, rtol=1e-4, atol=1e-4)
    # the weight gradient lies on the support only, exactly
    assert float(np.abs(tgw * (1 - _oihw(mask).numpy())).max()) == 0.0


def test_live_tile_of_zero_weights():
    """A live tile whose weights are all zero is still a step: y, dx and dW
    match tpuseg's with the tile zero, and the same struct stays right once
    the tile's weights are nonzero."""
    rng = np.random.default_rng(11)
    cin = cout = 256
    mask = _mask(rng, 3, cin, cout, density=0.6)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.03).astype(np.float32)
    p, q = np.argwhere(mask[:, :, :128, :128].any(axis=(2, 3)))[0]
    w0 = w.copy()
    w0[p, q, :128, :128] = 0.0    # block (0, 0) is always live
    x = rng.normal(size=(2, 8, 16, cin)).astype(np.float32)
    dy = rng.normal(size=(2, 8, 16, cout)).astype(np.float32)
    plan = tst.plan_sparse_conv_train(mask, dilation=2).to("cpu")
    for wv in (w0, w):
        jy, jgx, jgw = _grads_tpuseg(x, wv, dy, mask, 2)
        ty, tgx, tgw = _grads_port(x, _oihw(wv), dy, plan)
        np.testing.assert_allclose(ty, jy, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tgx, jgx, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tgw, jgw, rtol=1e-4, atol=1e-4)


def test_bf16_grads_close_to_f32():
    """In bf16 the packing, B2's plain version, the dgrad and the f32-summed
    wgrad stay within bf16 rounding of the f32 run."""
    rng = np.random.default_rng(2)
    mask = _mask(rng, 3, 256, 256)
    w = (rng.normal(size=(3, 3, 256, 256)) * 0.03).astype(np.float32)
    x = rng.normal(size=(2, 8, 16, 256)).astype(np.float32)
    dy = rng.normal(size=(2, 8, 16, 256)).astype(np.float32)
    plan = tst.plan_sparse_conv_train(mask, dilation=2).to("cpu")
    y32, gx32, gw32 = _grads_port(x, _oihw(w), dy, plan)
    y16, gx16, gw16 = _grads_port(x, _oihw(w), dy, plan, torch.bfloat16)
    for a, b in ((y16, y32), (gx16, gx32), (gw16, gw32)):
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max()


def test_pack_gradient_scatters_onto_the_support():
    """The packing's backward puts each value's gradient on exactly the weight
    it came from (tests/test_sparse_train.py::test_pack_vals_roundtrip_gradient)."""
    rng = np.random.default_rng(1)
    mask = _mask(rng, 1, 128, 256, density=0.99)
    mask[..., :, 128:] = 0.0
    plan = tst.plan_sparse_conv_train(mask).to("cpu")
    w = _oihw(rng.normal(size=(1, 1, 128, 256)).astype(np.float32)).requires_grad_()
    (tst.pack_vals(w, plan, dtype=torch.float32) ** 2).sum().backward()
    m = _oihw(mask)
    assert float((w.grad * (1 - m)).abs().max()) == 0.0
    torch.testing.assert_close(w.grad, 2 * w.detach() * m, rtol=1e-6, atol=0)


def test_dgrad_rejects_strided_dy():
    """B2's dgrad entry checks dy's layout: an NHWC view that is not
    contiguous raises (the autograd backward makes dy contiguous first)."""
    mask = _mask(np.random.default_rng(4), 3, 256, 256)
    plan = tst.plan_sparse_conv_train(mask, dilation=1).to("cpu")
    vals_t = tst._transpose_vals(
        tst.pack_vals(torch.randn(256, 256, 3, 3), plan, dtype=torch.float32), plan)
    dy = torch.randn(2, 256, 8, 16).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tst.sparse_conv_train_dgrad(dy, vals_t, plan)
    out = tst.sparse_conv_train_dgrad(dy.contiguous(), vals_t, plan)
    assert tuple(out.shape) == (2, 8, 16, 256) and out.dtype == torch.float32


def test_train_step_takes_plans_only():
    """The train step takes ``SparseTrainPlan``s built once on the images'
    device (``SparseTrainStruct.to``) and refuses a bare struct, whose
    index arrays it would otherwise rebuild every step."""
    from tpuseg_torch.train import make_seg_train_step, make_sgd

    params, _, spec = init_drnseg(0, "drn_d_22", 19)
    structs, _ = tst.build_sparse_train_structs(
        create_masker(REG, seed=0).generate_masks(params), spec)
    name, st = next(iter(structs.items()))
    tx = make_sgd(lambda _: 0.01, 0.9, 1e-4)
    with pytest.raises(TypeError, match="SparseTrainPlan"):
        make_seg_train_step(spec, tx, sparse_plans={name: st})
    plan = st.to("cpu")
    assert isinstance(plan, tst.SparseTrainPlan) and plan.pack_index.device.type == "cpu"
    make_seg_train_step(spec, tx, sparse_plans={name: plan})
