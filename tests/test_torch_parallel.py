"""Data-parallel training and serving over a mesh in the port
(``tpuseg_torch.parallel``) against ``tpuseg``'s single-device functions.

Two gloo ranks on the CPU, started with ``torch.multiprocessing`` and joined
through a file store (``spawn_ranks``), each take their half of a global
batch through ``shard_train_step``; the step must equal ``tpuseg``'s jitted
single-device step over the whole batch at ``tpuseg``'s tolerances
(``tests/test_parallel.py``: loss rel 1e-5, ``seg.weight`` rtol 1e-5,
``running_mean`` rtol 1e-5), also when one rank's labels are half ignored
(where averaging per-rank means, as DDP does, goes wrong), and the
replicas must be bit-equal.  ``--sparse-exec`` plans, ``remat`` and masks,
and the classifier's KD step, hold the 2-rank step to the port's 1-rank
step.  Serving replicas in one process (``VideoSegmenter(mesh=...)``) keep
``tpuseg``'s ids and guards.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REG = os.path.join(REPO, "optimal_configs", "drn_d_22", "drn_d_22_block128reg_87.50.json")
MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
GLOBAL = 4  # global batch of the DRN steps, 2 samples a rank
SIZE = 32


def _batch(seed, half_ignored=False):
    rng = np.random.default_rng(seed)
    images = rng.random((GLOBAL, SIZE, SIZE, 3), dtype=np.float32)
    labels = rng.integers(0, 19, size=(GLOBAL, SIZE, SIZE)).astype(np.int64)
    if half_ignored:
        # the second rank's samples: half their pixels ignored
        labels[GLOBAL // 2:, :SIZE // 2] = 255
    return images, labels


def _seg_state(masks=False):
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.sparsity import create_masker
    from tpuseg_torch.train import create_train_state, make_sgd

    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    m = create_masker(REG, seed=0).generate_masks(params) if masks else None
    tx = make_sgd(0.01, weight_decay=0.0)
    return create_train_state(params, state, tx, m), tx, spec, m


def _seg_step(tx, spec, masks=None, sparse=False, remat=False):
    from tpuseg_torch.ops.sparse_train import build_sparse_train_structs
    from tpuseg_torch.train import make_seg_train_step

    plans = None
    if sparse:
        structs, _ = build_sparse_train_structs(masks, spec)
        plans = {k: st.to("cpu") for k, st in structs.items()}
    return make_seg_train_step(spec, tx, compute_dtype=None, remat=remat, sparse_plans=plans)


def _cls_case():
    """The DRN-D-22 classifier (10 classes) with a DRN-D-22 teacher (KD) on
    a batch of 8 32x32 images.  (At init cifar_resnet20's step is
    ill-conditioned on the CPU: rounding-level input changes move its first
    layers' gradients past ``_close_to_one_rank``'s rule.)"""
    from tpuseg_torch.models.drn import build_drn_spec, init_drn
    from tpuseg_torch.train import classifier_forward, create_train_state, make_cls_train_step
    from tpuseg_torch.train import make_sgd

    spec = build_drn_spec("drn_d_22", num_classes=10, naming="cls")
    params, state = init_drn(0, spec)
    t_params, t_state = init_drn(1, spec)
    t_fwd = classifier_forward(spec)
    tx = make_sgd(0.05, weight_decay=1e-4)
    step = make_cls_train_step(spec, tx, compute_dtype=None,
                               teacher=(lambda p, s, x: t_fwd(p, s, x)[0], t_params, t_state))
    rng = np.random.default_rng(5)
    images = rng.random((8, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, size=(8,)).astype(np.int64)
    return create_train_state(params, state, tx), step, images, labels


def _summary(ts, m):
    return {"loss": float(m["loss"]), "params": {k: v.numpy() for k, v in ts.params.items()},
            "bn_state": {k: v.numpy() for k, v in ts.bn_state.items()},
            **({"acc": float(m["acc"])} if "acc" in m else {})}


def _ranked():
    """Runs in each of 2 ranks: every case's one step on this rank's half."""
    from tpuseg_torch.parallel import make_mesh, shard_batch, shard_train_step

    mesh = make_mesh(data=2)
    out = {}
    for name, half in (("dense", False), ("ignore", True)):
        ts, tx, spec, _ = _seg_state()
        x, y = (torch.from_numpy(a) for a in shard_batch(mesh, _batch(0, half)))
        out[name] = _summary(*shard_train_step(_seg_step(tx, spec), mesh)(ts, x, y))
    ts, tx, spec, masks = _seg_state(masks=True)
    step = _seg_step(tx, spec, masks, sparse=True, remat=True)
    x, y = (torch.from_numpy(a) for a in shard_batch(mesh, _batch(2)))
    out["sparse"] = _summary(*shard_train_step(step, mesh)(ts, x, y))
    ts, step, images, labels = _cls_case()
    x, y = (torch.from_numpy(a) for a in shard_batch(mesh, [images, labels]))
    out["kd"] = _summary(*shard_train_step(step, mesh)(ts, x, y))
    return out


@pytest.fixture(scope="module")
def ranked():
    from tpuseg_torch.parallel.mesh import spawn_ranks

    return spawn_ranks(_ranked, 2, "cpu", timeout=300)


@pytest.fixture(scope="module")
def jax_steps():
    """tpuseg's jitted single-device step over the global batch, from the
    same seed: the dense batch and the half-ignored one."""
    import jax
    import jax.numpy as jnp

    from tpuseg.models import init_drnseg
    from tpuseg.train import create_train_state, make_seg_train_step, make_sgd

    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    tx = make_sgd(0.01, weight_decay=0.0)
    step = jax.jit(make_seg_train_step(spec, tx, compute_dtype=None))
    out = {}
    for name, half in (("dense", False), ("ignore", True)):
        ts = create_train_state(params, state, tx)
        images, labels = _batch(0, half)
        ts1, m = step(ts, jnp.asarray(images), jnp.asarray(labels))
        out[name] = {"loss": float(m["loss"]),
                     "seg": np.asarray(ts1.params["seg.weight"]),
                     "rm": np.asarray(ts1.bn_state["layer.1.1.running_mean"])}
    return out


@pytest.mark.parametrize("case", ["dense", "ignore"])
def test_data_parallel_step_matches_tpuseg(ranked, jax_steps, case):
    """2 ranks of the port == the one-device step over the global batch,
    with one rank's labels half ignored in the ``ignore`` case: against the
    port's one-device step at ``tests/test_parallel.py``'s tolerances (the
    semantics of the sharded step), and against tpuseg's at the same
    tolerances but for ``running_mean``'s absolute floor, 5e-7, which the
    port's own one-device step needs against tpuseg's too (PyTorch's and
    XLA's CPU convs round differently; asserted here)."""
    got, want = ranked[0][case], jax_steps[case]
    ts, tx, spec, _ = _seg_state()
    ts1, m1 = _seg_step(tx, spec)(ts, *(torch.from_numpy(a) for a in _batch(0, case == "ignore")))
    for ref, rm_atol in (({"loss": float(m1["loss"]),
                           "seg": ts1.params["seg.weight"].numpy().transpose(2, 3, 1, 0),
                           "rm": ts1.bn_state["layer.1.1.running_mean"].numpy()}, 1e-7),
                         (want, 5e-7)):
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        seg = got["params"]["seg.weight"].transpose(2, 3, 1, 0)  # OIHW -> HWIO
        np.testing.assert_allclose(seg, ref["seg"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["bn_state"]["layer.1.1.running_mean"], ref["rm"],
                                   rtol=1e-5, atol=rm_atol)
    rm1 = ts1.bn_state["layer.1.1.running_mean"].numpy()
    assert not np.allclose(rm1, want["rm"], rtol=1e-5, atol=1e-7)  # the floor is real
    np.testing.assert_allclose(rm1, want["rm"], rtol=1e-5, atol=5e-7)


@pytest.mark.parametrize("case", ["dense", "ignore", "sparse", "kd"])
def test_replicas_bit_equal(ranked, case):
    a, b = ranked[0][case], ranked[1][case]
    assert a["loss"] == b["loss"]
    for part in ("params", "bn_state"):
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=f"{part} {k}")


def _close_to_one_rank(got, ts1, m1):
    """Every parameter and BN statistic within rtol 1e-4, atol 1e-4 of the
    tensor's largest magnitude (``tests/test_torch_cls_train.py``'s rule)."""
    assert got["loss"] == pytest.approx(float(m1["loss"]), rel=1e-5)
    for part in ("params", "bn_state"):
        want = getattr(ts1, part)
        for k in want:
            w = want[k].numpy()
            np.testing.assert_allclose(got[part][k], w, rtol=1e-4,
                                       atol=1e-4 * (np.abs(w).max() + 1e-12),
                                       err_msg=f"{part} {k}")


def test_sparse_exec_remat_masks_match_one_rank(ranked):
    """--sparse-exec (B2's plain version on the CPU), remat and static
    block128reg_87.50 masks on 2 ranks == the port's 1-rank step; the
    masked weights stay exactly zero."""
    ts, tx, spec, masks = _seg_state(masks=True)
    images, labels = _batch(2)
    ts1, m1 = _seg_step(tx, spec, masks, sparse=True, remat=True)(
        ts, torch.from_numpy(images), torch.from_numpy(labels))
    got = ranked[0]["sparse"]
    _close_to_one_rank(got, ts1, m1)
    for k, m in masks.items():
        assert not np.any(got["params"][k] * (1 - m.numpy())), k


def test_kd_step_matches_one_rank(ranked):
    """The classifier's KD step (DRN-D-22, a teacher) on 2 ranks: the
    global mean of CE and KL, the global batch's BN statistics and top-1."""
    ts, step, images, labels = _cls_case()
    ts1, m1 = step(ts, torch.from_numpy(images), torch.from_numpy(labels))
    got = ranked[0]["kd"]
    _close_to_one_rank(got, ts1, m1)
    assert got["acc"] == pytest.approx(float(m1["acc"]))


def test_mesh_shapes_and_rules():
    from tpuseg_torch.parallel import data_parallel_size, make_mesh, setup_data_parallel
    from tpuseg_torch.parallel.mesh import local_ranks

    mesh = make_mesh(data=2, devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 2, "spatial": 1} and mesh.rank is None
    assert mesh.ranks() is None  # a one-process mesh reduces nothing
    assert data_parallel_size(12, 8) == 6 and data_parallel_size(7, 4) == 1
    assert local_ranks(8, 2, "cpu") == 2 and local_ranks(6, 4, "cpu") == 3
    assert local_ranks(8, 0, "cpu") == 1
    one, local = setup_data_parallel(8, 0, torch.device("cpu"))
    assert one.size == 1 and local == 8
    with pytest.raises(ValueError):
        make_mesh(data=3, devices=["cpu", "cpu"])


def _serving(quantize=False, lowering="gathered", config=REG):
    """(port params, state, spec, exec plans) for serving a pruned model."""
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.models.sparse_exec import build_sparse_plans
    from tpuseg_torch.ops.fold_bn import fold_bn
    from tpuseg_torch.sparsity import apply_masks, create_masker

    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    masks = create_masker(config, seed=0).generate_masks(params)
    params = apply_masks(params, masks)
    plans, _ = build_sparse_plans(fold_bn(params, state, spec), masks, spec,
                                  lowering=lowering, dtype=torch.float32)
    return params, state, spec, plans


def _segment(mesh=None, batch=4, **kw):
    from tpuseg_torch.video.pipeline import SyntheticFrames, VideoSegmenter

    params, state, spec, plans = _serving()
    seg = VideoSegmenter(params, state, spec, MEAN, STD, device="cpu",
                         compute_dtype=torch.float32, batch=batch, exec_plans=plans,
                         mesh=mesh, **kw)
    return seg.run(SyntheticFrames(8, (64, 128), seed=0), need_color=False)["ids"]


def test_serving_mesh_gathered_matches_tpuseg():
    """Two CPU replicas serving sparse-gathered plans (block128reg_87.50,
    f32): the ids equal the port's one-device segmenter run at the
    replicas' batch, and agree with tpuseg's one-device segmenter as the
    port's one-device ids do (tests/test_torch_sparse_exec.py, >= 0.999)."""
    import jax.numpy as jnp

    from tpuseg.models.drnseg import init_drnseg as j_init
    from tpuseg.models.sparse_exec import build_sparse_plans as j_build
    from tpuseg.ops.fold_bn import fold_bn as j_fold_bn
    from tpuseg.sparsity import apply_masks as j_apply, create_masker as j_masker
    from tpuseg.video.pipeline import SyntheticFrames as JFrames
    from tpuseg.video.pipeline import VideoSegmenter as JSegmenter
    from tpuseg_torch.parallel import make_mesh

    ids = _segment(make_mesh(data=2, devices=["cpu", "cpu"]))
    np.testing.assert_array_equal(ids, _segment(batch=2))
    jp, js, jspec = j_init(0, "drn_d_22", 19)
    jmasks = j_masker(REG, seed=0).generate_masks(jp, is_static=True)
    jp = dict(j_apply(jp, jmasks))
    jplans, _ = j_build(j_fold_bn(jp, js, jspec), jmasks, jspec, lowering="gathered",
                        dtype=jnp.float32)
    jseg = JSegmenter(jp, js, jspec, MEAN, STD, compute_dtype=None, batch=4,
                      exec_plans=jplans)
    ref = np.asarray(jseg.run(JFrames(8, (64, 128), seed=0), need_color=False)["ids"])
    assert ids.shape == ref.shape == (8, 64, 128)
    assert float((ids == ref).mean()) >= 0.999


def test_serving_mesh_int8_agreement():
    """int8 serving (QuantConv plans through B3's plain version, calibrated)
    on two replicas: ids equal the one-device int8 segmenter at the
    replicas' batch, and agree with it at the whole batch >= 0.99, as
    tpuseg's ``test_parallel_compression.py`` requires of its mesh."""
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.parallel import make_mesh
    from tpuseg_torch.video.pipeline import SyntheticFrames, VideoSegmenter

    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    frames = list(SyntheticFrames(8, (64, 64), seed=0))

    def run(mesh=None, batch=8):
        seg = VideoSegmenter(params, state, spec, MEAN, STD, device="cpu",
                             compute_dtype=torch.float32, batch=batch, quantize=True,
                             calib_frames=frames[:4], mesh=mesh)
        return seg.run(frames, need_color=False)["ids"]

    q = run(make_mesh(data=2, devices=["cpu", "cpu"]))
    np.testing.assert_array_equal(q, run(batch=4))
    assert float((q == run()).mean()) >= 0.99


@pytest.mark.parametrize("arch", ["drn_d_22", "drn_d_38"])
def test_serving_replica_copies_one_segmenter(arch):
    """A replica on another device is this segmenter copied, not built
    again: the folded weights, the frontend (drn_d_22's stage-3 fold or
    drn_d_38's polyphase stem, int8 with its calibrated scales) and the
    int8 plans are the same values, and its ids are bit-equal.
    ``replicate`` gives one copy per distinct device."""
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.parallel import make_mesh, replicate
    from tpuseg_torch.video.pipeline import SyntheticFrames, VideoSegmenter

    params, state, spec = init_drnseg(0, arch, 19)
    frames = list(SyntheticFrames(4, (64, 64), seed=0))
    seg = VideoSegmenter(params, state, spec, MEAN, STD, device="cpu",
                         compute_dtype=torch.float32, batch=2, quantize=True,
                         quantize_stem=True, calib_frames=frames[:2])
    rep = seg._replica_on(torch.device("cpu"))
    assert rep.stem_fn is not seg.stem_fn and type(rep.stem_fn) is type(seg.stem_fn)
    assert rep.stem_fn.stem_x_scales == seg.stem_fn.stem_x_scales is not None
    assert rep.exec_plans.keys() == seg.exec_plans.keys() and rep.exec_plans
    for k, v in seg.params.items():
        assert torch.equal(rep.params[k], v), k
    x = torch.from_numpy(np.stack(frames).reshape(4, 64, -1))
    np.testing.assert_array_equal(rep._replica_ids(x).numpy(), seg._replica_ids(x).numpy())
    copies = replicate(make_mesh(data=2, devices=["cpu", "cpu"]), {"w": params["seg.weight"]})
    assert len(copies) == 2 and copies[0] is copies[1]
    assert torch.equal(copies[0]["w"], params["seg.weight"])


def test_serving_mesh_guards():
    """tpuseg's guards: Pallas-lowered plans, the adaptive temporal modes
    and a batch that does not divide over the mesh are refused; the
    CLI refuses --temporal-autotune with --mesh-devices."""
    from tpuseg_torch.cli import seg_video
    from tpuseg_torch.parallel import make_mesh
    from tpuseg_torch.video.pipeline import VideoSegmenter

    mesh = make_mesh(data=2, devices=["cpu", "cpu"])
    params, state, spec, plans = _serving(lowering="pallas")
    with pytest.raises(ValueError, match="Pallas-backed exec plans"):
        VideoSegmenter(params, state, spec, MEAN, STD, device="cpu", batch=4,
                       exec_plans=plans, mesh=mesh)
    for kw in ({"temporal_thresh": 3.0}, {"temporal_thresh": 3.0, "temporal_budget": 2}):
        with pytest.raises(ValueError, match="sequential"):
            VideoSegmenter(params, state, spec, MEAN, STD, device="cpu", batch=4,
                           mesh=mesh, **kw)
    with pytest.raises(ValueError, match="divide"):
        VideoSegmenter(params, state, spec, MEAN, STD, device="cpu", batch=3, mesh=mesh)
    with pytest.raises(SystemExit, match="mesh-devices"):
        seg_video.main(["--device", "cpu", "--video", "synthetic", "--size", "64x128",
                        "--frames", "4", "--batch", "2", "--mesh-devices", "2",
                        "--temporal-autotune", "0.9"])


def test_serving_mesh_interval_mode():
    """Interval reuse composes with the mesh (tpuseg serves it over its
    mesh too): the ids equal the one-device segmenter's."""
    from tpuseg_torch.parallel import make_mesh

    mesh = make_mesh(data=2, devices=["cpu", "cpu"])
    np.testing.assert_array_equal(_segment(mesh, temporal_interval=2),
                                  _segment(temporal_interval=2))


def test_new_modules_load_no_jax():
    """The modules of this slice import no jax, jaxlib or tpuseg module."""
    code = (
        "import sys, json\n"
        "import tpuseg_torch.parallel, tpuseg_torch.parallel.halo\n"
        "import tpuseg_torch.parallel.dryrun, tpuseg_torch.train.orbax_ckpt\n"
        "import tpuseg_torch.ops.polyphase, tpuseg_torch.video.pipeline\n"
        "import tpuseg_torch.cli.semantic_seg, tpuseg_torch.cli.rmbsnn\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpuseg'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []
