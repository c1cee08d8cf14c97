"""Port parity: tpuseg_torch.models (spec, init, forward) against tpuseg.models.

Weights come from the same int seed on both sides (numpy draws) or go
through ``from_jax_params``; forwards are compared in f32 on the CPU with
rtol 1e-4 and atol 1e-4 * max|ref| (conv sums are taken in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.models import drn as jdrn
from tpuseg.models import drnseg as jseg
from tpuseg_torch.models import drn as tdrn
from tpuseg_torch.models import drnseg as tseg
from tpuseg_torch.models.weights import from_jax_params, to_jax_params

torch.set_num_threads(2)


def _assert_close(out, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("naming", ["cls", "seg"])
@pytest.mark.parametrize("arch", sorted(jdrn.DRN_ARCHS))
def test_build_drn_spec_matches_jax(arch, naming):
    assert tdrn.DRN_ARCHS[arch] == jdrn.DRN_ARCHS[arch]
    if naming == "seg" and jdrn.DRN_ARCHS[arch][2] != "D":
        with pytest.raises(ValueError):
            jdrn.build_drn_spec(arch, naming=naming)
        with pytest.raises(ValueError):
            tdrn.build_drn_spec(arch, naming=naming)
        return
    nc = 0 if naming == "seg" else 1000
    j = jdrn.build_drn_spec(arch, num_classes=nc, naming=naming)
    t = tdrn.build_drn_spec(arch, num_classes=nc, naming=naming)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("arch", ["drn_d_22", "drn_d_54"])
def test_init_drnseg_matches_jax(arch):
    jp, js, _ = jseg.init_drnseg(0, arch, 19)
    tp, ts, _ = tseg.init_drnseg(0, arch, 19)
    assert sorted(tp) == sorted(jp) and sorted(ts) == sorted(js)
    back_p, back_s = to_jax_params(tp, ts)
    for k, v in jp.items():
        assert back_p[k].dtype == np.float32, k
        np.testing.assert_array_equal(back_p[k], np.asarray(v), err_msg=k)
    for k, v in js.items():
        np.testing.assert_array_equal(back_s[k], np.asarray(v), err_msg=k)
    assert tp["layer.0.0.weight"].shape == (16, 3, 7, 7)  # OIHW


def test_weight_conversion_round_trips():
    rng = np.random.default_rng(0)
    p = {"a.weight": rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
         "a.bias": rng.normal(size=(5,)).astype(np.float32),
         "up.weight": rng.normal(size=(16, 16)).astype(np.float32)}
    s = {"bn.running_var": rng.random(5).astype(np.float32)}
    tp, ts = from_jax_params(p, s)
    assert tp["a.weight"].shape == (5, 4, 3, 3)
    assert tp["a.weight"][2, 1, 0, 2].item() == p["a.weight"][0, 2, 1, 2]
    bp, bs = to_jax_params(tp, ts)
    for k in p:
        np.testing.assert_array_equal(bp[k], p[k])
    np.testing.assert_array_equal(bs["bn.running_var"], s["bn.running_var"])


def _random_bn(params, state, rng):
    """Non-trivial BN statistics and affine params from the seed."""
    params = dict(params)
    state = dict(state)
    for k in list(state):
        n = state[k].shape[0]
        if k.endswith("running_mean"):
            state[k] = rng.normal(0, 0.2, n).astype(np.float32)
        else:
            state[k] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    for k in list(params):
        if k.replace(".weight", ".running_var") in state or k.replace(".bias", ".running_var") in state:
            n = params[k].shape[0]
            base = 1.0 if k.endswith(".weight") else 0.0
            params[k] = (base + rng.normal(0, 0.1, n)).astype(np.float32)
    return params, state


@pytest.mark.parametrize("arch", ["drn_d_22", "drn_d_54"])
def test_drn_forward_matches_jax_f32(arch):
    rng = np.random.default_rng(5)
    jp, js, spec = jseg.init_drnseg(0, arch, 19)
    jp, js = _random_bn(jp, js, rng)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref, _, _ = jdrn.drn_forward(jp, js, jnp.asarray(x), spec)
    tp, ts = from_jax_params(jp, js)
    tspec = tdrn.build_drn_spec(arch, num_classes=0, naming="seg")
    out, updates = tdrn.drn_forward(tp, ts, torch.from_numpy(x), tspec)
    assert updates == {}
    assert out.is_contiguous()
    _assert_close(out.numpy(), ref)


@pytest.mark.parametrize("arch", ["drn_d_22", "drn_d_54"])
@pytest.mark.parametrize("upsample", [True, False])
def test_drnseg_forward_matches_jax_f32(arch, upsample):
    rng = np.random.default_rng(6)
    jp, js, spec = jseg.init_drnseg(0, arch, 19)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    jlogp, jseg_out, _ = jseg.drnseg_forward(
        jp, js, jnp.asarray(x), spec, upsample=upsample)
    tp, ts, tspec = tseg.init_drnseg(0, arch, 19)
    logp, seg, _ = tseg.drnseg_forward(tp, ts, torch.from_numpy(x), tspec,
                                       upsample=upsample)
    _assert_close(seg.numpy(), jseg_out)
    _assert_close(logp.numpy(), jlogp)


def test_drn_forward_rejects_classifier_heads():
    """Classifier heads were refused before the classifier arm; a head now
    runs, with bf16 logits of the DRN-A Linear head and f32 logits of the
    1x1-conv head under bf16 compute (``tpuseg``'s dtypes), and a headless
    spec still returns its NHWC feature map."""
    x = torch.zeros((1, 32, 32, 3))
    for arch, dtype in (("drn_a_50", torch.bfloat16), ("drn_d_22", torch.float32)):
        spec = tdrn.build_drn_spec(arch, num_classes=10)
        params, state = tdrn.init_drn(0, spec)
        out, _ = tdrn.drn_forward(params, state, x, spec, compute_dtype=torch.bfloat16)
        assert out.shape == (1, 10) and out.dtype == dtype
    spec = tdrn.build_drn_spec("drn_d_22", num_classes=0)
    params, state = tdrn.init_drn(0, spec)
    feats, _ = tdrn.drn_forward(params, state, x, spec)
    assert feats.shape == (1, 4, 4, 512)
