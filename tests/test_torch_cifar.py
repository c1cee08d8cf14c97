"""Port parity: the classifier zoo (``tpuseg_torch.models.cifar``), the DRN
classifier heads and ``tpuseg_torch.models.factory`` against ``tpuseg``'s.

Weights come from the same seed on both sides (numpy draws, compared after
the HWIO -> OIHW transpose); forwards run in f32 on the CPU, logits within
rtol 2e-4 and atol 2e-4 * max|ref| (conv sums are taken in another order).
Each family runs at a cut depth (one block a stage) through a spec built
field for field in both packages, so every block kind is covered at a
small size; the published archs' specs are compared as data."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.models import cifar as jcifar
from tpuseg.models import drn as jdrn
from tpuseg.models import factory as jfactory
from tpuseg_torch.models import cifar as tcifar
from tpuseg_torch.models import drn as tdrn
from tpuseg_torch.models import factory as tfactory
from tpuseg_torch.models.weights import to_jax_params

torch.set_num_threads(2)

RTOL = 2e-4

# (spec fields, input size): each family and block kind at one block a stage
CUT_SPECS = {
    "cresnet_basic": (dict(family="cresnet", arch="c", block="basic", layers=(1, 1, 1)), 16),
    "cresnet_bottleneck": (dict(family="cresnet", arch="c", block="bottleneck",
                                layers=(1, 1, 1)), 16),
    "cresnet_preact": (dict(family="cresnet", arch="c", block="preact", layers=(1, 2, 1)), 16),
    "cresnet_preact_bottleneck": (dict(family="cresnet", arch="c",
                                       block="preact_bottleneck", layers=(1, 1, 1)), 16),
    "tvresnet_basic": (dict(family="tvresnet", arch="t", block="basic",
                            layers=(1, 1, 1, 1)), 16),
    "tvresnet_resnext": (dict(family="tvresnet", arch="t", block="bottleneck",
                              layers=(1, 1, 1, 1), groups=4, width_per_group=4), 16),
    "vgg_bn": (dict(family="vgg", arch="v", vgg_cfg="R64", vgg_bn=True, fmaps=64), 32),
    "vgg_plain": (dict(family="vgg", arch="v", vgg_cfg="A", vgg_bn=False), 16),
    "rvgg": (dict(family="rvgg", arch="r", vgg_cfg="R64", vgg_bn=True, rvgg_res=True,
                  fmaps=64), 32),
    "wrn": (dict(family="wrn", arch="w", layers=(1, 1, 1), widen=2), 16),
}


def _assert_close(out, ref, rtol=RTOL):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _random_bn(jp, js, rng):
    """Non-trivial BN statistics and affine params from the seed."""
    jp, js = dict(jp), dict(js)
    for k in list(js):
        n = js[k].shape[0]
        js[k] = (rng.normal(0, 0.2, n) if k.endswith("running_mean")
                 else rng.uniform(0.5, 1.5, n)).astype(np.float32)
        base = k.rsplit(".", 1)[0]
        jp[f"{base}.weight"] = (1 + rng.normal(0, 0.1, n)).astype(np.float32)
        jp[f"{base}.bias"] = rng.normal(0, 0.1, n).astype(np.float32)
    return jp, js


def _cut(name, classes=7):
    fields, size = CUT_SPECS[name]
    return (jcifar.CifarSpec(num_classes=classes, **fields),
            tcifar.CifarSpec(num_classes=classes, **fields), size)


@pytest.mark.parametrize("arch", jcifar.CIFAR_ARCHS)
def test_build_cifar_spec_matches_tpuseg(arch):
    assert tcifar.CIFAR_ARCHS == jcifar.CIFAR_ARCHS
    assert dataclasses.asdict(tcifar.build_cifar_spec(arch, 10)) == \
        dataclasses.asdict(jcifar.build_cifar_spec(arch, 10))


@pytest.mark.parametrize("arch", ["cifar_resnet20", "cifar_resnet18", "cifar_vgg11_bn",
                                  "cifar_res_rvgg11_64_bn", "cifar_wrn_16_4",
                                  "cifar_preact_resnet20"])
def test_init_cifar_matches_tpuseg(arch):
    """Params and keys equal after the layout transpose, from an int seed
    and from ``jax_key`` (``tpuseg``'s ``jax.random.key(seed)``)."""
    import jax

    for tkey, jkey in ((3, 3), (tdrn.jax_key(2), jax.random.key(2))):
        jp, js, _ = jcifar.create_cifar_model(jkey, arch, 10)
        tp, ts, tspec = tcifar.create_cifar_model(tkey, arch, 10)
        assert sorted(tp) == sorted(jp) and sorted(ts) == sorted(js)
        bp, bs = to_jax_params(tp, ts)
        for k, v in jp.items():
            np.testing.assert_array_equal(bp[k], np.asarray(v), err_msg=k)
        for k, v in js.items():
            np.testing.assert_array_equal(bs[k], np.asarray(v), err_msg=k)
    assert tp["conv1.weight" if "vgg" not in arch else "features.0.weight"].shape[1] == 3


@pytest.mark.parametrize("name", list(CUT_SPECS))
def test_cifar_forward_matches_tpuseg(name):
    """Eval logits, and train-mode logits with every BN's running-stat
    update, in f32."""
    jspec, tspec, size = _cut(name)
    rng = np.random.default_rng(7)
    jp, js = jcifar.init_cifar(1, jspec)
    jp, js = _random_bn(jp, js, rng)
    tp, ts = tdrn.from_jax_params(jp, js)
    x = rng.normal(size=(3, size, size, 3)).astype(np.float32)
    for train in (False, True):
        ref, jupd = jcifar.cifar_forward(jp, js, jnp.asarray(x), jspec, train=train)
        out, tupd = tcifar.cifar_forward(tp, ts, torch.from_numpy(x), tspec, train=train)
        assert out.dtype == torch.float32 and out.shape == (3, 7)
        _assert_close(out, ref)
        assert sorted(tupd) == sorted(jupd) and bool(tupd) == train
        for k in jupd:
            _assert_close(tupd[k], jupd[k])


def test_cifar_forward_bf16_close_to_tpuseg():
    """bf16 compute: logits in bf16, near ``tpuseg``'s bf16 logits (a few
    bf16 ulps of the largest logit)."""
    jspec, tspec, size = _cut("cresnet_basic")
    jp, js = jcifar.init_cifar(0, jspec)
    tp, ts = tcifar.init_cifar(0, tspec)
    x = np.random.default_rng(1).normal(size=(2, size, size, 3)).astype(np.float32)
    ref, _ = jcifar.cifar_forward(jp, js, jnp.asarray(x), jspec, compute_dtype=jnp.bfloat16)
    out, _ = tcifar.cifar_forward(tp, ts, torch.from_numpy(x), tspec,
                                  compute_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.05 * np.abs(ref).max())


def test_cifar_forward_channels_last_inside():
    """NHWC in, NCHW-shaped channels_last activations inside (the convs see
    channels_last memory)."""
    _, tspec, size = _cut("cresnet_basic")
    tp, ts = tcifar.init_cifar(0, tspec)
    seen = []
    orig = tcifar.conv2d

    def spy(x, *a, **k):
        seen.append(x.is_contiguous(memory_format=torch.channels_last))
        return orig(x, *a, **k)

    tcifar.conv2d = spy
    try:
        tcifar.cifar_forward(tp, ts, torch.zeros((2, size, size, 3)), tspec)
    finally:
        tcifar.conv2d = orig
    assert seen and all(seen)


# ---------------------------------------------------------------------------
# DRN classifier heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,size", [("drn_a_50", 64), ("drn_c_26", 64), ("drn_d_22", 64),
                                       ("drn_d_22", 40)])
def test_drn_classifier_heads_match_tpuseg(arch, size):
    """DRN-A (stem max pool, stride-1 average pool, Linear fc), DRN-C and
    DRN-D (average pool at its window's stride, 1x1-conv fc): the fc drawn
    as ``tpuseg`` draws it; eval and train logits in f32, the window clamped
    to a map smaller than ``pool_size`` (and, at 40, not a multiple of the
    stride's grid)."""
    jspec = jdrn.build_drn_spec(arch, num_classes=11, naming="cls")
    tspec = tdrn.build_drn_spec(arch, num_classes=11, naming="cls")
    jp, js = jdrn.init_drn(4, jspec)
    tp, ts = tdrn.init_drn(4, tspec)
    bp, _ = to_jax_params(tp, ts)
    np.testing.assert_array_equal(bp["fc.weight"], np.asarray(jp["fc.weight"]))
    np.testing.assert_array_equal(bp["fc.bias"], np.asarray(jp["fc.bias"]))
    rng = np.random.default_rng(2)
    jp, js = _random_bn(jp, js, rng)
    tp, ts = tdrn.from_jax_params(jp, js)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    for train in (False, True):
        ref, _, jupd = jdrn.drn_forward(jp, js, jnp.asarray(x), jspec, train=train)
        out, tupd = tdrn.drn_forward(tp, ts, torch.from_numpy(x), tspec, train=train)
        assert out.shape == (2, 11)
        _assert_close(out, ref)
        assert sorted(tupd) == sorted(jupd)


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset,arch", [("cifar10", "cifar_resnet20"),
                                          ("imagenet", "drn_d_22"),
                                          ("voc", "drn_d_22"), ("mnist", "cifar_vgg11")])
def test_create_model_matches_tpuseg(dataset, arch):
    import jax

    assert tfactory.DATASET_CLASSES == jfactory.DATASET_CLASSES
    for ds in jfactory.DATASET_CLASSES:
        assert tfactory.num_classes_for_dataset(ds.upper()) == \
            jfactory.num_classes_for_dataset(ds)
    jp, js, jspec, jkw = jfactory.create_model(jax.random.key(5), dataset, arch)
    tp, ts, tspec, tkw = tfactory.create_model(tdrn.jax_key(5), dataset, arch)
    assert tkw == jkw
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    bp, bs = to_jax_params(tp, ts)
    assert sorted(bp) == sorted(jp)
    for k in ("fc.weight", "seg.weight", "conv1.weight", "features.0.weight"):
        if k in jp:
            np.testing.assert_array_equal(bp[k], np.asarray(jp[k]), err_msg=k)
