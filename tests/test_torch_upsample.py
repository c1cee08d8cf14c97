"""Port parity: tpuseg_torch.ops.upsample against tpuseg.ops.upsample.

Inputs come from numpy seeds and go through both packages; the Pallas kernel
runs in interpret mode, as tests/test_ops.py runs it on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.models.drnseg import bilinear_upsample_kernel
from tpuseg.ops import upsample as jup
from tpuseg_torch.ops import _build
from tpuseg_torch.ops import upsample as tup

torch.set_num_threads(2)


def _asym_kernel(rng):
    f1 = rng.random(16).astype(np.float32) + 0.1  # positive, asymmetric
    return np.outer(f1, f1).astype(np.float32)


@pytest.mark.parametrize("kind", ["bilinear", "asymmetric"])
def test_upsample8_phase_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 9, 5)).astype(np.float32)
    k = bilinear_upsample_kernel() if kind == "bilinear" else _asym_kernel(rng)
    ref = np.asarray(jup.upsample8_phase(jnp.asarray(x), jnp.asarray(k)))
    out = tup.upsample8_phase(torch.from_numpy(x), k).numpy()
    assert out.shape == ref.shape == (2, 56, 72, 5)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_upsample8_phase_matches_transposed_conv():
    """The phase formulation equals the port's plain transposed conv."""
    from tpuseg_torch.models.drnseg import upsample8

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 5, 6, 3)).astype(np.float32))
    k = torch.from_numpy(_asym_kernel(rng))
    np.testing.assert_allclose(
        tup.upsample8_phase(x, k).numpy(), upsample8(x, k).numpy(),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["bilinear", "asymmetric"])
def test_upsample_argmax_reference_matches_jax(kind):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 8, 19)).astype(np.float32)
    k = bilinear_upsample_kernel() if kind == "bilinear" else _asym_kernel(rng)
    ref = np.asarray(jup.upsample_argmax(jnp.asarray(x), jnp.asarray(k)))
    ids = tup.upsample_argmax_reference(torch.from_numpy(x), k)
    assert ids.dtype == torch.uint8 and ids.shape == (2, 48, 64)
    np.testing.assert_array_equal(ids.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_argmax_reference_matches_pallas_interpret(dtype, monkeypatch):
    """The Pallas kernel interpolates in f32 from either logits dtype, as
    the port's plain version (and CUDA kernel) do: ids are equal."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    monkeypatch.setattr("jax.experimental.pallas.pallas_call", interp)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 3, 4, 5)).astype(np.float32)
    k = bilinear_upsample_kernel()
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ref = np.asarray(jup.upsample_argmax_pallas(xj, jnp.asarray(k)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ids = tup.upsample_argmax_reference(xt, k)
    np.testing.assert_array_equal(ids.numpy(), ref)


def test_upsample_argmax_cpu_runs_plain_version_without_launch():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 4, 5, 7)).astype(np.float32))
    k = bilinear_upsample_kernel()
    tup.upsample_argmax.launches = 0
    ids = tup.upsample_argmax(x, k)
    assert tup.upsample_argmax.launches == 0
    assert torch.equal(ids, tup.upsample_argmax_reference(x, k))
    for bf16 in (x.to(torch.bfloat16),):
        assert torch.equal(tup.upsample_argmax(bf16, k),
                           tup.upsample_argmax_reference(bf16, k))
    assert tup.upsample_argmax.launches == 0


@pytest.mark.parametrize("bad", ["rank", "dtype", "layout", "classes", "kernel_device"])
def test_upsample_argmax_rejects_unsupported_input(bad):
    k = bilinear_upsample_kernel()
    x = torch.zeros((1, 4, 5, 3))
    err = ValueError
    if bad == "rank":
        x = torch.zeros((4, 5, 3))
    elif bad == "dtype":
        x, err = x.half(), TypeError
    elif bad == "layout":
        x = torch.zeros((1, 3, 4, 5)).permute(0, 2, 3, 1)
    elif bad == "classes":
        x = torch.zeros((1, 2, 2, 256))
    elif bad == "kernel_device":
        k = torch.from_numpy(k).to("meta")
    with pytest.raises(err):
        tup.upsample_argmax(x, k)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library(build_dir=str(tmp_path / "build"))
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_build_surfaces_compiler_errors(monkeypatch, tmp_path):
    """A failing compiler raises with its output and leaves no library."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    build = tmp_path / "build"
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build_library(build_dir=str(build))
    assert list(build.iterdir()) == []


def test_library_path_keys_on_sources(tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    p1 = _build.library_path(str(src), str(tmp_path))
    (src / "a.cu").write_text("// two\n")
    p2 = _build.library_path(str(src), str(tmp_path))
    assert p1 != p2 and p1.startswith(str(tmp_path))
