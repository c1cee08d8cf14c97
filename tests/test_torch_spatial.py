"""Spatial H-sharding in the port (``tpuseg_torch.parallel.halo``,
``spatial_forward``, ``shard_train_step(spatial=True)``) against
``tpuseg``'s unsharded functions, on gloo ranks of the CPU.

``tpuseg``'s own test puts 64 rows over 8 strips, so at stride 8 a strip is
one row against a dilation-4 halo of 4: the halo spans several strips.
Here 4 ranks share a 1x64x64 frame (2 rows a strip at stride 8, halos of up
to 4 rows), whose logits must match ``tpuseg``'s unsharded forward within
2e-4 (``tests/test_parallel.py``), and a 2x2 (data x spatial) mesh takes one
train step that must match ``tpuseg``'s one-device step within 1e-4.  The
halo convs are also held exactly against the whole-image conv in float64.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(2)

CONVS = [  # (kernel, stride, padding, dilation): DRN's convs and a 1x1 stride 2
    (3, 1, 1, 1), (3, 1, 4, 4), (7, 1, 3, 1), (3, 2, 1, 1), (1, 2, 0, 1), (3, 1, 2, 2),
    (1, 1, 0, 1)]


def _halo_cases():
    """Each rank: every conv of CONVS and the x8 upsampler on its strip of
    16 rows (4 ranks) vs the whole-image op, float64; returns the largest
    differences."""
    from tpuseg_torch.parallel import make_mesh

    mesh = make_mesh(data=1, spatial=4)
    halo = mesh.ranks(spatial=True).halo
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 16, 8, generator=g, dtype=torch.float64)
    h = 16 // 4
    strip = x[:, :, halo.index * h:(halo.index + 1) * h]
    errs = []
    for k, s, p, d in CONVS:
        w = torch.randn(4, 3, k, k, generator=g, dtype=torch.float64)
        ref = F.conv2d(x, w, None, s, p, d)
        ho = ref.shape[2] // 4
        got = halo.conv2d(strip, w, None, s, p, d)
        errs.append(float((got - ref[:, :, halo.index * ho:(halo.index + 1) * ho]).abs().max()))
    wu = torch.rand(16, 16, generator=g, dtype=torch.float64).reshape(1, 1, 16, 16)
    wu = wu.expand(3, 1, -1, -1)
    ref = F.conv_transpose2d(x, wu, stride=8, padding=4, groups=3)
    got = halo.upsample8(strip, wu)
    errs.append(float((got - ref[:, :, halo.index * 32:(halo.index + 1) * 32]).abs().max()))
    return errs


def _spatial_forward():
    """1x64x64 DRN-D-22 logits over 4 strips (the full output on every
    rank)."""
    from tpuseg_torch.models.drnseg import drnseg_forward, init_drnseg
    from tpuseg_torch.parallel import make_mesh, spatial_forward

    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    mesh = make_mesh(data=1, spatial=4)
    x = np.random.default_rng(1).random((1, 64, 64, 3), dtype=np.float32)
    fwd = spatial_forward(
        lambda p, s, x, ranks: drnseg_forward(p, s, x, spec, train=False, ranks=ranks)[0],
        mesh)
    out = fwd(params, state, torch.from_numpy(x)).numpy()
    with pytest.raises(ValueError, match="divide by spatial"):
        fwd(params, state, torch.zeros(1, 48, 64, 3))
    return out


def _batch():
    rng = np.random.default_rng(3)
    images = rng.random((4, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 19, size=(4, 32, 32)).astype(np.int64)
    return images, labels


def _step_2x2():
    """One train step on a 2x2 (data x spatial) mesh: each rank its sample
    pair's strip of 16 rows."""
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.parallel import make_mesh, shard_batch, shard_train_step
    from tpuseg_torch.train import create_train_state, make_seg_train_step, make_sgd

    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    tx = make_sgd(0.01, weight_decay=0.0)
    ts = create_train_state(params, state, tx)
    mesh = make_mesh(data=2, spatial=2)
    step = shard_train_step(make_seg_train_step(spec, tx, compute_dtype=None), mesh,
                            spatial=True)
    x, y = (torch.from_numpy(a) for a in shard_batch(mesh, _batch(), ("data", "spatial")))
    ts1, m = step(ts, x, y)
    return {"loss": float(m["loss"]), "seg": ts1.params["seg.weight"].numpy(),
            "rm": ts1.bn_state["layer.1.1.running_mean"].numpy()}


def _all():
    return {"halo": _halo_cases(), "forward": _spatial_forward(), "step": _step_2x2()}


@pytest.fixture(scope="module")
def ranked():
    from tpuseg_torch.parallel.mesh import spawn_ranks

    return spawn_ranks(_all, 4, "cpu", timeout=300)


def test_halo_convs_exact(ranked):
    """Every rank's strip of each conv (halos of up to 8 rows over strips of
    4, 2 and 1 rows) and of the x8 upsampler equals the whole-image op in
    float64 to rounding."""
    for r in ranked:
        assert max(r["halo"]) < 1e-12, r["halo"]


def test_spatial_forward_matches_tpuseg(ranked):
    import jax
    import jax.numpy as jnp

    from tpuseg.models import init_drnseg
    from tpuseg.models.drnseg import drnseg_forward

    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    x = np.random.default_rng(1).random((1, 64, 64, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda p, s, v: drnseg_forward(p, s, v, spec, train=False)[0])(
        params, state, jnp.asarray(x)))
    for r in ranked:
        np.testing.assert_allclose(r["forward"], ref, rtol=2e-4, atol=2e-4)


def test_2d_mesh_train_step_matches_tpuseg(ranked):
    import jax
    import jax.numpy as jnp

    from tpuseg.models import init_drnseg
    from tpuseg.train import create_train_state, make_seg_train_step, make_sgd

    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    tx = make_sgd(0.01, weight_decay=0.0)
    images, labels = _batch()
    ts1, m1 = jax.jit(make_seg_train_step(spec, tx, compute_dtype=None))(
        create_train_state(params, state, tx), jnp.asarray(images), jnp.asarray(labels))
    for r in ranked:
        got = r["step"]
        assert got["loss"] == pytest.approx(float(m1["loss"]), rel=1e-4)
        np.testing.assert_allclose(got["seg"].transpose(2, 3, 1, 0),
                                   np.asarray(ts1.params["seg.weight"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["rm"], np.asarray(ts1.bn_state["layer.1.1.running_mean"]),
                                   rtol=1e-4, atol=1e-5)
    # every rank holds the same replica
    for r in ranked[1:]:
        np.testing.assert_array_equal(r["step"]["seg"], ranked[0]["step"]["seg"])


def test_spatial_needs_ranks():
    from tpuseg_torch.parallel import make_mesh, spatial_forward
    from tpuseg_torch.parallel.mesh import check_spatial_height

    with pytest.raises(ValueError, match="process group"):
        make_mesh(data=1, spatial=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="spatial"):
        spatial_forward(lambda *a, **k: None, make_mesh(data=1, devices=["cpu"]))
    check_spatial_height(64, 8)
    with pytest.raises(ValueError, match="divide by spatial"):
        check_spatial_height(72, 2)
