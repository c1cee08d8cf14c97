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


def _interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr("jax.experimental.pallas.pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _edge_logits(case, rng):
    """(logits f32, the id every pixel must take or None) for an edge case
    of the CUDA kernel's tiling and staging, and the tie rule."""
    shapes = {"h1_w1": (2, 1, 1, 19), "odd_w33": (2, 3, 33, 19),
              "ragged_w130": (1, 2, 130, 19), "part_lane_w6": (1, 4, 6, 19),
              "c1": (1, 5, 7, 1), "c127": (1, 3, 5, 127), "c255": (1, 3, 5, 255),
              "tie_all_equal": (2, 3, 130, 19), "tie_two_max": (2, 3, 130, 19),
              "tie_two_max_c255": (1, 5, 7, 255), "one_chunk_w128": (1, 2, 128, 19),
              "chunk_and_one_w129": (1, 2, 129, 19), "three_chunks_w257": (1, 2, 257, 19)}
    shape = shapes[case]
    if case == "tie_all_equal":
        x = np.repeat(rng.normal(size=shape[:3] + (1,)), shape[3], axis=3)
        return x.astype(np.float32), 0
    if case.startswith("tie_two_max"):
        i, j = (30, 200) if case.endswith("c255") else (3, 11)
        x = -rng.random(shape).astype(np.float32)
        x[..., i] = x[..., j] = 5 + rng.random(shape[:3]).astype(np.float32)
        return x, i
    return rng.normal(size=shape).astype(np.float32), None


EDGE_CASES = ["h1_w1", "odd_w33", "ragged_w130", "part_lane_w6", "c1", "c127", "c255",
              "tie_all_equal", "tie_two_max", "tie_two_max_c255"]
# widths about the CUDA kernel's 128-column chunks (plain version vs XLA only)
CHUNK_CASES = ["one_chunk_w128", "chunk_and_one_w129", "three_chunks_w257"]


@pytest.mark.parametrize("case", EDGE_CASES + CHUNK_CASES)
def test_upsample_argmax_edge_cases_match_jax(case):
    """Odd shapes and exact ties: the port's entry point (the plain version
    on the CPU) gives tpuseg's XLA ids, and ties go to the lowest class."""
    x, want_id = _edge_logits(case, np.random.default_rng(5))
    k = _asym_kernel(np.random.default_rng(6)) if "w" in case else bilinear_upsample_kernel()
    ref = np.asarray(jup.upsample_argmax(jnp.asarray(x), jnp.asarray(k)))
    ids = tup.upsample_argmax(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(ids, ref)
    if want_id is not None:
        assert (ids == want_id).all()


@pytest.mark.parametrize("case", [c for c in EDGE_CASES if "255" not in c])
def test_upsample_argmax_edge_cases_match_pallas_interpret(case, monkeypatch):
    """The same cases against tpuseg's Pallas kernel (C <= 127) in interpret
    mode, from bf16 logits (the served dtype; both interpolate in f32)."""
    _interpret_pallas(monkeypatch)
    x, want_id = _edge_logits(case, np.random.default_rng(7))
    k = bilinear_upsample_kernel()
    ref = np.asarray(jup.upsample_argmax_pallas(jnp.asarray(x).astype(jnp.bfloat16),
                                                jnp.asarray(k)))
    ids = tup.upsample_argmax(torch.from_numpy(x).to(torch.bfloat16), k).numpy()
    np.testing.assert_array_equal(ids, ref)
    if want_id is not None:
        assert (ids == want_id).all()


def test_tall_input_matches_jax():
    """8h = 65,600 (the CUDA kernel puts the rows on the grid's x axis, so
    only the card's run in chip_smoke.py phase 2 shows that the kernel
    takes it): the plain version's ids are tpuseg's."""
    x = np.random.default_rng(8).normal(size=(1, 8200, 1, 3)).astype(np.float32)
    k = bilinear_upsample_kernel()
    ids = tup.upsample_argmax(torch.from_numpy(x), k)
    assert ids.shape == (1, 65600, 8)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jup.upsample_argmax(jnp.asarray(x), jnp.asarray(k))))


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(_build.SRC_DIR), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind, issued", [("bilinear", 5.25), ("asymmetric", 6.375)])
def test_b1_instruction_count(kind, issued):
    """B1's f32 instructions per output pixel and class: each pass needs one
    distinct product per output value when a[q] == b[7-q] (the bilinear
    kernel), two otherwise, plus its add; the argmax's compare and two
    selects run on the half-rate pipe."""
    k = bilinear_upsample_kernel() if kind == "bilinear" else _asym_kernel(np.random.default_rng(9))
    a, b = tup._phase_weights(tup._kernel_1d(k))
    assert _chip_smoke()._b1_instructions(a, b) == (issued, 3)


def test_b1_bound_at_the_serving_shape():
    """At (32,128,256,19) bf16 on 132 SMs at 1980 MHz, the compare/select
    pipe bounds B1 (0.2287 ms), above its issue count (0.2001 ms) and its
    bytes (0.0319 ms)."""
    cs = _chip_smoke()
    a, b = tup._phase_weights(tup._kernel_1d(bilinear_upsample_kernel()))
    ms, by, parts = cs._b1_bound((32, 128, 256, 19), 2, a, b, 132 * 128 * 1980e6)
    assert by == "operations"
    assert ms == parts["compare_select_ms"] == pytest.approx(0.228684, abs=1e-6)
    assert parts["issue_ms"] == pytest.approx(0.200098, abs=1e-6)
    assert parts["bytes_ms"] == pytest.approx(0.031927, abs=1e-6)
