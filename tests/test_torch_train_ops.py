"""Port parity for the training pieces (``tpuseg_torch.train``,
``tpuseg_torch.metrics``, ``tpuseg_torch.data``) against ``tpuseg``: losses,
schedules, the SGD chain, train-mode BatchNorm and the train forward, the
paired transforms, batching and prefetch, and the mIoU metrics."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from tpuseg.data import transforms as JT
from tpuseg.data.loaders import batch_iterator as j_batch_iterator
from tpuseg.metrics import seg as jmetrics
from tpuseg.models import drn as jdrn
from tpuseg.models.drnseg import drnseg_forward as j_drnseg_forward
from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.train import loss as jloss
from tpuseg.train import optim as joptim
from tpuseg.train import trainer as jtrainer
from tpuseg_torch.data import transforms as TT
from tpuseg_torch.data.loaders import batch_iterator, prefetch_to_device
from tpuseg_torch.metrics import AverageMeter
from tpuseg_torch.metrics import seg as tmetrics
from tpuseg_torch.metrics.runlog import RunLogger, read_run
from tpuseg_torch.models import drn as tdrn
from tpuseg_torch.models.drnseg import drnseg_forward, init_drnseg
from tpuseg_torch.models.weights import from_jax_params
from tpuseg_torch.train import loss as tloss
from tpuseg_torch.train import optim as toptim
from tpuseg_torch.train import trainer as ttrainer

torch.set_num_threads(2)


def _logits(rng, shape):
    return (rng.normal(size=shape) * 3).astype(np.float32)


def test_seg_loss_matches_tpuseg():
    rng = np.random.default_rng(0)
    logits = _logits(rng, (2, 16, 24, 19))
    labels = rng.integers(0, 19, size=(2, 16, 24)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.1] = 255
    logp = np.asarray(jnp.asarray(logits) - jnp.log(jnp.exp(logits).sum(-1, keepdims=True)))
    want = float(jloss.seg_loss_from_logprobs(jnp.asarray(logp), jnp.asarray(labels)))
    got = float(tloss.seg_loss_from_logprobs(torch.from_numpy(logp), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # every label ignored: the denominator is clamped to 1
    ign = np.full_like(labels, 255)
    assert float(tloss.seg_loss_from_logprobs(torch.from_numpy(logp),
                                              torch.from_numpy(ign))) == 0.0


@pytest.mark.parametrize("ignore", [255, -1])
def test_cross_entropy_matches_tpuseg(ignore):
    rng = np.random.default_rng(1)
    logits = _logits(rng, (64, 10))
    labels = rng.integers(0, 10, size=(64,)).astype(np.int32)
    if ignore == 255:
        labels[::7] = 255
    want = float(jloss.cross_entropy_ignore(jnp.asarray(logits), jnp.asarray(labels), ignore))
    got = float(tloss.cross_entropy_ignore(torch.from_numpy(logits), torch.from_numpy(labels),
                                           ignore))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_kd_losses_match_tpuseg():
    rng = np.random.default_rng(2)
    s, t = _logits(rng, (32, 10)), _logits(rng, (32, 10))
    labels = rng.integers(0, 10, size=(32,)).astype(np.int32)
    for temp in (1.0, 4.0):
        np.testing.assert_allclose(
            float(tloss.kd_loss(torch.from_numpy(s), torch.from_numpy(t), temp)),
            float(jloss.kd_loss(jnp.asarray(s), jnp.asarray(t), temp)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tloss.combined_kd_loss(torch.from_numpy(s), torch.from_numpy(labels),
                                     torch.from_numpy(t), 0.3, 0.7, 2.0)),
        float(jloss.combined_kd_loss(jnp.asarray(s), jnp.asarray(labels), jnp.asarray(t),
                                     0.3, 0.7, 2.0)), rtol=1e-6)


@pytest.mark.parametrize("epochs,start", [(1, 0), (2, 0), (10, 0), (100, 30), (150, 0), (400, 0)])
def test_milestones_match_tpuseg(epochs, start):
    assert toptim.milestones_for_epochs(epochs, start) == joptim.milestones_for_epochs(epochs,
                                                                                      start)


@pytest.mark.parametrize("kind", ["multistep", "multistep_at_0", "poly", "step30"])
def test_schedules_equal_tpuseg(kind):
    """Each schedule equals tpuseg's (optax's float32) at every step of a
    short run."""
    if kind == "multistep":
        args, n = (0.01, [2, 3, 5], 0.1, 3), 24
    elif kind == "multistep_at_0":  # --epochs 1: milestones [0, 0] count once
        args, n = (0.01, [0, 0], 0.1, 2), 6
    elif kind == "poly":
        args, n = (0.01, 17, 0.9), 20
    else:
        args, n = (0.1, 2), 130
    make = {"multistep": "multistep_schedule", "multistep_at_0": "multistep_schedule",
            "poly": "poly_schedule", "step30": "step30_schedule"}[kind]
    js, ts = getattr(joptim, make)(*args), getattr(toptim, make)(*args)
    for count in range(n):
        want = float(np.asarray(js(jnp.asarray(count, jnp.int32))))
        np.testing.assert_allclose(ts(count), want, rtol=1e-6, err_msg=str(count))


def _sgd_problem(rng):
    params = {
        "a.weight": rng.normal(size=(3, 3, 8, 16)).astype(np.float32),
        "a.bias": rng.normal(size=(16,)).astype(np.float32),
        "up.weight": rng.normal(size=(16, 16)).astype(np.float32),
    }
    mask = (rng.random((3, 3, 8, 16)) < 0.5).astype(np.float32)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    return params, {"a.weight": mask}, grads


def _oihw(d):
    return from_jax_params(d)[0]


@pytest.mark.parametrize("momentum,wd,schedule", [
    (0.9, 1e-4, True), (0.9, 0.0, True), (0.0, 1e-4, True), (0.9, 1e-4, False)])
def test_sgd_matches_optax_chain(momentum, wd, schedule):
    """Five updates through make_sgd + the trainer's update (frozen
    up.weight, masked a.weight) against tpuseg's optax chain: params, the
    momentum trace and the count, rtol 1e-6; the state has the chain's
    links."""
    rng = np.random.default_rng(3)
    params, masks, grads = _sgd_problem(rng)
    lr = (lambda c: 0.05 * (0.5 ** (c // 2))) if schedule else 0.05
    jlr = ((lambda c: 0.05 * (0.5 ** (c // 2))) if schedule else 0.05)
    jtx = joptim.make_sgd(jlr, momentum, wd)
    ttx = toptim.make_sgd(lr, momentum, wd)
    js = jtrainer.create_train_state(params, {}, jtx, masks)
    ts = ttrainer.create_train_state(_oihw(params), {}, ttx, _oihw(masks))
    assert len(ts.opt_state) == len(js.opt_state)
    frozen = ("up.weight",)
    for g in grads:
        # the frozen gradient is zeroed before the update, as tpuseg's train step does
        g = {k: (np.zeros_like(v) if k in frozen else v) for k, v in g.items()}
        jp, jopt = jtrainer._sgd_update(jtx, {k: jnp.asarray(v) for k, v in g.items()}, js,
                                        frozen)
        js = jtrainer.TrainState(params=jp, bn_state={}, opt_state=jopt, masks=js.masks,
                                 step=js.step + 1)
        tg = _oihw(g)
        tp, topt = ttrainer._sgd_update(ttx, tg, ts, frozen)
        ts = ttrainer.TrainState(params=tp, bn_state={}, opt_state=topt, masks=ts.masks,
                                 step=ts.step + 1)
    want = from_jax_params({k: np.asarray(v) for k, v in js.params.items()})[0]
    for k in want:
        np.testing.assert_allclose(ts.params[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert float((ts.params["a.weight"] * (1 - _oihw(masks)["a.weight"])).abs().max()) == 0.0
    assert torch.equal(ts.params["up.weight"], torch.from_numpy(params["up.weight"]))
    if momentum:
        jtrace = next(s.trace for s in js.opt_state if isinstance(s, optax.TraceState))
        ttrace = next(s["trace"] for s in ts.opt_state if "trace" in s)
        for k, v in from_jax_params({k: np.asarray(v) for k, v in jtrace.items()})[0].items():
            # the frozen param's trace takes wd * p, as tpuseg's does
            np.testing.assert_allclose(ttrace[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7)
    if schedule:
        assert int(ts.opt_state[-1]["count"]) == int(js.opt_state[-1].count) == 5


def test_train_batch_norm_matches_tpuseg():
    """Train-mode BN: the normalized output and the running-stat updates in
    f32, rtol 1e-5; eval mode reads the running stats."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 6, 5, 16)) * 2 + 0.5).astype(np.float32)
    params = {"bn.weight": rng.normal(size=16).astype(np.float32),
              "bn.bias": rng.normal(size=16).astype(np.float32)}
    state = {"bn.running_mean": rng.normal(size=16).astype(np.float32),
             "bn.running_var": rng.random(16).astype(np.float32) + 0.5}
    tp, ts = from_jax_params(params, state)
    for train in (True, False):
        jup, tup = {}, ({} if train else None)
        want = jdrn.batch_norm(jnp.asarray(x), params, state, jup, "bn", train)
        got = tdrn.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), tp, ts, "bn",
                              updates=tup)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        if train:
            assert sorted(tup) == sorted(jup)
            for k in jup:
                np.testing.assert_allclose(tup[k].numpy(), np.asarray(jup[k]), rtol=1e-5)


def test_train_forward_matches_tpuseg():
    """drnseg_forward(train=True) on DRN-D-22 at 64x64, f32: log-probs and
    every BN update against tpuseg's."""
    rng = np.random.default_rng(5)
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    jp, js, jspec = j_init(0, "drn_d_22", 19)
    jlogp, _, jup = j_drnseg_forward(jp, js, jnp.asarray(x), jspec, train=True)
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    logp, _, up = drnseg_forward(tp, ts, torch.from_numpy(x), tspec, train=True)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=1e-4, atol=1e-4)
    assert sorted(up) == sorted(jup) and len(up) == 2 * 25  # 25 BNs in DRN-D-22
    for k in jup:
        np.testing.assert_allclose(up[k].numpy(), np.asarray(jup[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _pil_pair(seed, h=37, w=53):
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    lbl = rng.integers(0, 19, size=(h, w), dtype=np.uint8)
    return Image.fromarray(img), Image.fromarray(lbl)


def _pipeline(T, seed):
    rng = np.random.default_rng(seed)
    return T.Compose([
        T.RandomRotate(10, rng), T.RandomScale(1.5, rng), T.RandomCrop(48, rng),
        T.RandomHorizontalFlip(rng), T.Pad(3, fill=-1), T.ToArray(),
        T.Normalize([0.29, 0.33, 0.29], [0.18, 0.19, 0.18]),
    ])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transforms_bit_equal(seed):
    """The paired transforms draw and compute as tpuseg's from one seed."""
    jt, tt = _pipeline(JT, seed), _pipeline(TT, seed)
    for i in range(3):
        want = jt(*_pil_pair(10 * seed + i))
        got = tt(*_pil_pair(10 * seed + i))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    a = np.random.default_rng(seed).random((5, 7, 3)).astype(np.float32)
    assert np.array_equal(TT.pad_reflection(a, 6, 2, 9, 1), JT.pad_reflection(a, 6, 2, 9, 1))


class _Samples:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return rng.random((4, 4, 3), dtype=np.float32), rng.integers(0, 5, (4, 4)), f"s{i}"


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, drop_last=True, epoch=3), dict(), dict(shuffle=True, epoch=1),
    dict(shuffle=True, drop_last=True, num_shards=2, shard_index=1)])
def test_batch_iterator_equal(kw):
    ds = _Samples(11)
    got, want = list(batch_iterator(ds, 3, **kw)), list(j_batch_iterator(ds, 3, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]) and g[2] == w[2]


def test_prefetch_moves_batches_and_reraises():
    ds = _Samples(6)
    out = list(prefetch_to_device(batch_iterator(ds, 2), "cpu"))
    ref = list(batch_iterator(ds, 2))
    assert len(out) == 3
    for o, r in zip(out, ref):
        assert isinstance(o[0], torch.Tensor) and torch.equal(o[0], torch.from_numpy(r[0]))
        assert o[2] == r[2]

    def broken():
        yield next(batch_iterator(ds, 2))
        raise OSError("corrupt sample")

    it = prefetch_to_device(broken(), "cpu")
    next(it)
    with pytest.raises(OSError, match="corrupt sample"):
        next(it)


def test_metrics_bit_equal():
    rng = np.random.default_rng(6)
    pred = rng.integers(0, 19, size=20000)
    label = rng.integers(0, 19, size=20000)
    label[::9] = 255
    h = tmetrics.fast_hist(pred, label, 19)
    assert np.array_equal(h, jmetrics.fast_hist(pred, label, 19))
    assert tmetrics.miou_from_hist(h) == jmetrics.miou_from_hist(h)
    assert np.array_equal(tmetrics.per_class_iu(h), jmetrics.per_class_iu(h))
    assert tmetrics.pixel_accuracy(pred, label) == jmetrics.pixel_accuracy(pred, label)
    logits = rng.normal(size=(50, 10))
    lab = rng.integers(0, 10, 50)
    assert tmetrics.top_k_accuracy(logits, lab, (1, 5)) == jmetrics.top_k_accuracy(logits, lab,
                                                                                  (1, 5))
    m = AverageMeter("loss")
    for v, n in ((2.0, 2), (5.0, 1)):
        m.update(v, n)
    assert m.avg == 3.0 and m.count == 3


def test_runlog_writes_jsonl(tmp_path):
    with RunLogger(str(tmp_path), run_name="r", hparams={"lr": 0.01}, tensorboard=False) as log:
        log.log(0, {"train_loss": 1.5})
        log.log(1, {"train_loss": 1.25}, note="x")
    assert read_run(str(tmp_path / "r")) == [{"step": 0, "train_loss": 1.5},
                                            {"step": 1, "train_loss": 1.25, "note": "x"}]
    with RunLogger(str(tmp_path), run_name="q", tensorboard=False) as log:
        log.log(0, {"train_loss": 1.0})
    from tpuseg.metrics.runlog import compare_runs as j_compare
    from tpuseg_torch.metrics.runlog import compare_runs

    runs = [str(tmp_path / "r"), str(tmp_path / "q")]
    for mode in ("max", "min"):
        assert compare_runs(runs, "train_loss", mode) == j_compare(runs, "train_loss", mode)


def _conv_params(seed):
    rng = np.random.default_rng(seed)
    return {"a.weight": rng.normal(size=(3, 3, 16, 24)).astype(np.float32),
            "b.weight": rng.normal(size=(1, 1, 24, 8)).astype(np.float32),
            "b.bias": rng.normal(size=(8,)).astype(np.float32),
            "up.weight": rng.normal(size=(16, 16, 1, 4)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["magnitude", "random"])
def test_unstructured_masks_equal_tpuseg(kind):
    """The unstructured masks (drawn on the HWIO view, as tpuseg draws
    them) and the global sparsity they give, equal to tpuseg's."""
    from tpuseg.train import unstructured as junst
    from tpuseg_torch.train import unstructured as tunst

    jp = _conv_params(8)
    tp = from_jax_params(jp)[0]
    if kind == "magnitude":
        jm = junst.magnitude_unstructured_masks(jp, 0.6)
        tm = tunst.magnitude_unstructured_masks(tp, 0.6)
    else:
        jm = junst.random_unstructured_masks(jp, 0.4, np.random.default_rng(3))
        tm = tunst.random_unstructured_masks(tp, 0.4, np.random.default_rng(3))
    assert sorted(tm) == sorted(jm) == ["a.weight", "b.weight"]
    for k, v in from_jax_params(jm)[0].items():
        assert torch.equal(tm[k], v), k
    assert tunst.measure_global_sparsity(tp, tm) == junst.measure_global_sparsity(jp, jm)


def test_rejig_equal_tpuseg():
    """Sparsity-aware re-initialization draws the same values into the same
    positions as tpuseg's from one seed."""
    from tpuseg.train.rejig import sparsity_aware_reinit as j_reinit
    from tpuseg_torch.train.rejig import sparsity_aware_reinit as t_reinit

    jp = _conv_params(9)
    rng = np.random.default_rng(10)
    jm = {k: (rng.random(jp[k].shape) < 0.3).astype(np.float32) for k in ("a.weight",
                                                                         "b.weight")}
    want = j_reinit(jp, jm, np.random.default_rng(11))
    got = t_reinit(from_jax_params(jp)[0], from_jax_params(jm)[0], np.random.default_rng(11))
    for k, v in from_jax_params(want)[0].items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("front,argv", [
    ("semseg_baseline", ["train", "--batch-size", "2", "--sparse-type", "unstructured",
                         "--sparsity", "0.3", "--mc-pruning", "--pr-config-path", "x.json"]),
    ("semseg_baseline", ["--epochs", "3", "-s", "256"]),
    ("semseg_unstructured", ["test", "--sparsity", "0.7", "--arch", "drn_d_38"]),
    ("semseg_unstructured", ["--epochs", "2"])])
def test_front_ends_forward_as_tpuseg(monkeypatch, front, argv):
    """The thin front ends hand semantic_seg the arguments tpuseg's hand
    its own."""
    import importlib

    seen = {}
    for pkg in ("tpuseg", "tpuseg_torch"):
        seg = importlib.import_module(f"{pkg}.cli.semantic_seg")
        monkeypatch.setattr(seg, "main", lambda a, pkg=pkg: seen.setdefault(pkg, list(a)))
        importlib.import_module(f"{pkg}.cli.{front}").main(list(argv))
    assert seen["tpuseg_torch"] == seen["tpuseg"]
