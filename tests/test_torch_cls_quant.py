"""Port parity for the classifier's int8 evaluation: ``build_cls_quant_plans``
and the int8 zoo forward against ``tpuseg``'s, ``build_quant_plans`` on a
DRN classifier spec (``layer5`` naming), and B3's narrow packing of the
zoo's 16-64 channel convs (``int8_packing``).

``tpuseg``'s ``QuantConv.apply`` is an XLA int8 conv with an int32 sum; the
port's plain version is an exact integer conv, so every conv is compared
bit for bit on the same activation.  The narrow packing's plain version
(B3's plain version on the unpadded x) is held bit-equal to the integer
conv and to ``tpuseg``'s."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.models import cifar as jcifar
from tpuseg.models.drn import build_drn_spec as j_build_drn_spec
from tpuseg.models.drn import init_drn as j_init_drn
from tpuseg.ops.quant import build_cls_quant_plans as j_build_cls
from tpuseg.ops.quant import QuantConv as JQuantConv
from tpuseg.ops.quant import build_quant_plans as j_build_quant
from tpuseg_torch.models import cifar as tcifar
from tpuseg_torch.models.drn import build_drn_spec, init_drn
from tpuseg_torch.models.weights import from_jax_params
from tpuseg_torch.ops.quant import (
    BK,
    build_cls_quant_plans,
    build_quant_plans,
    int8_packing,
    narrow_widths,
    quant_conv_apply,
    quant_conv_reference,
    quantize_weight,
)
from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_q_reference

torch.set_num_threads(2)

# the 20 int8 plans of cifar_resnet20: its 18 3x3 block convs and the 1x1
# downsamples of layer2/3, in init order (the stride-2 convs among them get
# a plan too, and the forward skips them)
R20_INT8 = [f"layer{g}.{b}.{c}" for g in (1, 2, 3) for b in range(3)
            for c in (["downsample.0"] if g > 1 and b == 0 else []) + ["conv1", "conv2"]]


def _bits(a):
    return (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).tobytes()


def test_build_cls_quant_plans_matches_tpuseg_resnet20():
    jp, _js, _ = jcifar.create_cifar_model(0, "cifar_resnet20", 10)
    tp, _ts, _ = tcifar.create_cifar_model(0, "cifar_resnet20", 10)
    j = j_build_cls(jp)
    t = build_cls_quant_plans(tp)
    assert list(t) == list(j) == R20_INT8
    for name, jplan in j.items():
        tplan = t[name]
        assert _bits(tplan.w_q) == _bits(jplan.w_q), name
        assert _bits(tplan.w_scale) == _bits(jplan.w_scale), name
        assert (tplan.stride, tplan.dilation, tplan.padding) == \
            (jplan.stride, jplan.dilation, jplan.padding)
        # every zoo conv of resnet20 is narrower than 128: a narrow packing
        # at its own widths, K and N the channels rounded up to 32 and 16
        cin, cout = tplan.w_q.shape[2:]
        assert tplan.packed.narrow and (tplan.packed.cin, tplan.packed.cout) == (cin, cout)
        assert (tplan.packed.bk, tplan.packed.bm) == narrow_widths(cin, cout) == \
            (max(32, cin), cout) and tplan.packed.s == 1


def test_build_cls_quant_plans_skips_grouped_convs():
    """resnext's grouped 3x3 convs get no plan with ``groups``, as in
    ``tpuseg``; its 1x1s and the downsample do."""
    fields = dict(family="tvresnet", arch="t", block="bottleneck", layers=(1, 1, 1, 1),
                  groups=4, width_per_group=4)
    jp, _ = jcifar.init_cifar(0, jcifar.CifarSpec(num_classes=10, **fields))
    tp, _ = tcifar.init_cifar(0, tcifar.CifarSpec(num_classes=10, **fields))
    j = j_build_cls(jp, groups=4)
    t = build_cls_quant_plans(tp, groups=4)
    assert list(t) == list(j) and not any(k.endswith("conv2") for k in t)
    assert list(build_cls_quant_plans(tp)) == list(j_build_cls(jp))


@pytest.mark.parametrize("x_scale", [None, 0.05])
def test_cls_int8_convs_bit_equal_tpuseg(x_scale):
    """Each int8 conv of cifar_resnet20 (and its static-scale variant) on
    one random activation: the port's plain version, the narrow packing's
    plain version and ``tpuseg``'s ``QuantConv.apply``, bit for bit."""
    jp, _, _ = jcifar.create_cifar_model(1, "cifar_resnet20", 10)
    tp, _, _ = tcifar.create_cifar_model(1, "cifar_resnet20", 10)
    scales = None if x_scale is None else {n: x_scale for n in R20_INT8}
    j = j_build_cls(jp, x_scales=scales)
    t = build_cls_quant_plans(tp, x_scales=scales)
    rng = np.random.default_rng(3)
    for name in R20_INT8:
        cin = t[name].w_q.shape[2]
        x = rng.normal(size=(2, 8, 8, cin)).astype(np.float32)
        want = np.asarray(j[name].apply(jnp.asarray(x)))
        xt = torch.from_numpy(x)
        got = t[name].apply(xt)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _bits(got) == _bits(want), name
        assert _bits(quant_conv_apply(xt, t[name])) == _bits(want), name


@pytest.mark.parametrize("k,cin,cout", [(3, 16, 16), (3, 16, 32), (1, 32, 64), (3, 64, 64),
                                        (3, 96, 200), (3, 128, 128)])
def test_int8_packing_pads_to_b3(k, cin, cout):
    """The narrow packing (K = cin rounded up to 32, or 128-channel slots,
    x padded to S * K by the quantize pass's -1 map; N = cout rounded up to
    16, or 128-channel blocks; zero rows and columns past cin and cout,
    scale 1 past cout) run by B3's plain version equals the integer conv
    and ``tpuseg``'s ``QuantConv.apply`` bit for bit; a conv of
    128-multiples gets the full-support packing."""
    rng = np.random.default_rng(k * cin + cout)
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    wq, ws = quantize_weight(w)
    packed = int8_packing("c", wq, ws, 1, (k - 1) // 2)
    wide = cin % BK == 0 and cout % BK == 0
    kb, bn = (BK, BK) if wide else narrow_widths(cin, cout)
    S, nmb = -(-cin // kb), -(-cout // bn)
    assert (packed.cin, packed.cout, packed.bk, packed.bm, packed.s) == (cin, cout, kb, bn, S)
    assert packed.narrow == (not wide)
    # x padded to whole K-wide steps through the quantize pass's map
    assert (packed.in_chan is None) == (cin == S * kb)
    if packed.in_chan is not None:
        assert packed.in_chan.tolist() == list(range(cin)) + [-1] * (S * kb - cin)
    assert tuple(packed.vals_k.shape) == (nmb, k * k * S, bn, kb)
    assert packed.w_scale.reshape(-1)[cout:].tolist() == [1.0] * (nmb * bn - cout)
    dense = packed.vals.reshape(nmb, k * k, S * kb, bn).permute(1, 2, 0, 3).reshape(
        k, k, S * kb, nmb * bn)
    assert not dense[:, :, cin:].any() and not dense[..., cout:].any()
    assert torch.equal(dense[:, :, :cin, :cout], torch.from_numpy(wq))
    assert int(packed.nsteps.sum()) == nmb * k * k * S
    x = rng.normal(size=(2, 5, 7, cin)).astype(np.float32)
    from tpuseg_torch.ops.quant import QuantConv

    plan = QuantConv(w_q=torch.from_numpy(wq), w_scale=torch.from_numpy(ws), stride=1,
                     dilation=1, padding=(k - 1) // 2, packed=packed)
    want = quant_conv_reference(torch.from_numpy(x), plan)
    got = fused_sparse_conv_q_reference(torch.from_numpy(x), packed)
    assert got.shape == want.shape == (2, 5, 7, cout)
    assert _bits(got) == _bits(want)
    jqc = JQuantConv(jnp.asarray(wq), jnp.asarray(ws), 1, 1, (k - 1) // 2, None)
    assert _bits(want) == _bits(jqc.apply(jnp.asarray(x)))
    # the route B3 takes on the card, through its wrappers' plain versions
    assert _bits(quant_conv_apply(torch.from_numpy(x), plan)) == _bits(want)


def test_int8_packing_names_what_b3_cannot_run():
    wq = np.zeros((2, 2, 16, 16), np.int8)
    with pytest.raises(ValueError, match="layer1.0.conv1"):
        int8_packing("layer1.0.conv1", wq, np.ones(16, np.float32), 1, 0)


def test_cifar_int8_forward_matches_tpuseg():
    """The whole int8 cifar_resnet20 forward in f32 on the CPU against
    ``tpuseg``'s int8 forward: two exact int8 paths agree only to float
    rounding (a last-bit difference flips an x/scale rounding and
    cascades), so the logits are held within 2 % of their range and the
    argmax to 15 of 16 images."""
    jp, js, jspec = jcifar.create_cifar_model(2, "cifar_resnet20", 10)
    tp, ts, tspec = tcifar.create_cifar_model(2, "cifar_resnet20", 10)
    x = np.random.default_rng(4).normal(size=(16, 32, 32, 3)).astype(np.float32)
    want, _ = jcifar.cifar_forward(jp, js, jnp.asarray(x), jspec, plans=j_build_cls(jp))
    got, _ = tcifar.cifar_forward(tp, ts, torch.from_numpy(x), tspec,
                                  plans=build_cls_quant_plans(tp))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=0.02 * np.ptp(want))
    assert (got.numpy().argmax(-1) == want.argmax(-1)).sum() >= 15


@pytest.mark.parametrize("arch", ["drn_d_22", "drn_c_26"])
def test_build_quant_plans_parses_cls_names(arch):
    """``build_quant_plans`` on a classifier-named DRN spec (``layer5``):
    the same plans as ``tpuseg``'s, and as many as its seg naming gives."""
    jspec = j_build_drn_spec(arch, num_classes=10, naming="cls")
    tspec = build_drn_spec(arch, num_classes=10, naming="cls")
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    jp, js = j_init_drn(0, jspec)
    tp, _ = from_jax_params(jp, js)
    j = j_build_quant(jp, jspec)
    t = build_quant_plans(tp, tspec)
    assert list(t) == list(j) and len(t) >= 9
    assert all(name.startswith(("layer4", "layer5", "layer6", "layer7", "layer8")) for name in t)
    for name in t:
        assert _bits(t[name].w_q) == _bits(j[name].w_q), name
        assert not t[name].packed.narrow and t[name].packed.cout == t[name].w_q.shape[3]
    seg = build_quant_plans(init_drn(0, build_drn_spec(arch, 0, naming="seg"))[0],
                            build_drn_spec(arch, 0, naming="seg")) if arch.startswith(
        "drn_d") else t
    assert len(seg) == len(t)
