"""Port parity for the classifier arm's data and weight import:
``tpuseg_torch.data.classification`` (CIFAR/MNIST readers on files the
tests write, the augmenting datasets, the synthetic set, the image-folder
reader), ``tpuseg_torch.data.recipes`` (ADE20K/VOC lists and palettes, as
``tests/test_data.py`` checks ``tpuseg``'s) and
``tpuseg_torch.models.torch_import`` (``.pth`` files the tests write, read
by both packages; the state-dict round trips; a local-path pretrained
backbone).  Everything is compared bit for bit."""

import gzip
import pickle

import numpy as np
import pytest
import torch

from tpuseg.data import classification as jcls
from tpuseg.models import torch_import as jti
from tpuseg_torch.data import classification as tcls
from tpuseg_torch.models import torch_import as tti
from tpuseg_torch.models.drn import build_drn_spec, init_drn
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.models.weights import to_jax_params


def _write_cifar(root, dataset):
    rng = np.random.default_rng(0)
    if dataset == "cifar10":
        base = root / "cifar-10-batches-py"
        names, key = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"], b"labels"
    else:
        base = root / "cifar-100-python"
        names, key = ["train", "test"], b"fine_labels"
    base.mkdir(parents=True)
    for name in names:
        blob = {b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                key: rng.integers(0, 10, 4).tolist()}
        with open(base / name, "wb") as fh:
            pickle.dump(blob, fh)


def _write_mnist(root, gz):
    rng = np.random.default_rng(1)
    for kind, n in (("train", 5), ("t10k", 3)):
        imgs = b"\0" * 16 + rng.integers(0, 256, n * 784, dtype=np.uint8).tobytes()
        lbls = b"\0" * 8 + rng.integers(0, 10, n, dtype=np.uint8).tobytes()
        for name, data in ((f"{kind}-images-idx3-ubyte", imgs), (f"{kind}-labels-idx1-ubyte", lbls)):
            if gz:
                with gzip.open(root / (name + ".gz"), "wb") as fh:
                    fh.write(data)
            else:
                (root / name).write_bytes(data)


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100"])
def test_load_cifar_matches_tpuseg(tmp_path, dataset):
    _write_cifar(tmp_path, dataset)
    for train in (True, False):
        tx, ty = tcls.load_cifar(str(tmp_path), dataset, train)
        jx, jy = jcls.load_cifar(str(tmp_path), dataset, train)
        assert tx.shape == (20 if train and dataset == "cifar10" else 4, 32, 32, 3)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    t_tr, t_va = tcls.make_class_datasets(dataset, str(tmp_path), seed=3)
    j_tr, j_va = jcls.make_class_datasets(dataset, str(tmp_path), seed=3)
    for t_ds, j_ds in ((t_tr, j_tr), (t_va, j_va)):
        assert len(t_ds) == len(j_ds)
        for i in range(len(t_ds)):  # the same augmentation draws, in order
            (ta, tl), (ja, jl) = t_ds[i], j_ds[i]
            np.testing.assert_array_equal(ta, ja)
            assert tl == jl


@pytest.mark.parametrize("gz", [False, True])
def test_load_mnist_matches_tpuseg(tmp_path, gz):
    _write_mnist(tmp_path, gz)
    for train in (True, False):
        tx, ty = tcls.load_mnist(str(tmp_path), train)
        jx, jy = jcls.load_mnist(str(tmp_path), train)
        assert tx.shape == ((5 if train else 3), 28, 28, 1) and ty.dtype == np.int32
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    t_tr, _ = tcls.make_class_datasets("mnist", str(tmp_path), seed=1)
    j_tr, _ = jcls.make_class_datasets("mnist", str(tmp_path), seed=1)
    np.testing.assert_array_equal(t_tr[2][0], j_tr[2][0])


def test_synthetic_dataset_matches_tpuseg():
    t = tcls.SyntheticClassDataset(6, 32, 3, 10, seed=4)
    j = jcls.SyntheticClassDataset(6, 32, 3, 10, seed=4)
    assert len(t) == len(j) == 6
    for i in range(6):
        np.testing.assert_array_equal(t[i][0], j[i][0])
        assert t[i][1] == j[i][1]


def test_image_folder_matches_tpuseg(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    for c in ("ant", "bee"):
        (tmp_path / c).mkdir()
        for i, size in enumerate(((40, 30), (20, 90))):
            Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(
                tmp_path / c / f"{i}.png")
    for train in (True, False):
        t = tcls.ImageFolderDataset(str(tmp_path), train=train, size=16,
                                    rng=np.random.default_rng(5))
        j = jcls.ImageFolderDataset(str(tmp_path), train=train, size=16,
                                    rng=np.random.default_rng(5))
        assert t.class_to_idx == j.class_to_idx == {"ant": 0, "bee": 1}
        for i in range(len(j)):
            np.testing.assert_array_equal(t[i][0], j[i][0])
            assert t[i][1] == j[i][1]


def test_ade20k_recipe(tmp_path):
    from PIL import Image

    from tpuseg.data.recipes import prepare_ade20k_lists as j_prepare
    from tpuseg_torch.data.cityscapes import SegList, load_info
    from tpuseg_torch.data.recipes import ade20k_remap_labels, prepare_ade20k_lists

    root = tmp_path / "ade"
    for split in ("training", "validation"):
        (root / "images" / split).mkdir(parents=True)
        (root / "annotations" / split).mkdir(parents=True)
        for i in range(3 if split == "training" else 2):
            Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(
                root / "images" / split / f"ADE_{i:08d}.jpg")
            Image.fromarray(np.full((16, 16), i + 1, np.uint8)).save(
                root / "annotations" / split / f"ADE_{i:08d}.png")
    counts = prepare_ade20k_lists(str(root), str(tmp_path / "t"))
    assert counts == j_prepare(str(root), str(tmp_path / "j")) == {"train": 3, "val": 2}
    for name in ("train_images.txt", "train_labels.txt", "val_images.txt", "info.json"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    assert prepare_ade20k_lists(str(root)) == counts
    info = load_info(str(root))
    assert len(info["mean"]) == 3
    ds = SegList(str(root), "train", lambda im, lb: (np.asarray(im), lb))
    assert len(ds) == 3
    assert ade20k_remap_labels(np.array([[0, 1], [150, 7]], np.uint8)).tolist() == \
        [[255, 0], [149, 6]]


def test_voc_recipe_and_palette(tmp_path):
    from PIL import Image

    from tpuseg.data.recipes import prepare_voc_lists as j_prepare
    from tpuseg.data.recipes import voc_palette as j_palette
    from tpuseg_torch.data.recipes import prepare_voc_lists, voc_palette

    root = tmp_path / "voc"
    (root / "JPEGImages").mkdir(parents=True)
    (root / "SegmentationClass").mkdir()
    (root / "ImageSets" / "Segmentation").mkdir(parents=True)
    ids = ["2007_000001", "2007_000002"]
    for i in ids:
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(root / "JPEGImages" / f"{i}.jpg")
        Image.fromarray(np.zeros((8, 8), np.uint8)).save(root / "SegmentationClass" / f"{i}.png")
    (root / "ImageSets" / "Segmentation" / "train.txt").write_text("\n".join(ids) + "\n")
    (root / "ImageSets" / "Segmentation" / "val.txt").write_text(ids[0] + "\n")
    counts = prepare_voc_lists(str(root), str(tmp_path / "t"))
    assert counts == j_prepare(str(root), str(tmp_path / "j")) == {"train": 2, "val": 1}
    lines = (tmp_path / "t" / "train_images.txt").read_text().strip().split("\n")
    assert len(lines) == 2 and lines[0].startswith("JPEGImages/")
    assert (tmp_path / "t" / "val_labels.txt").read_text() == \
        (tmp_path / "j" / "val_labels.txt").read_text()
    pal = voc_palette()
    np.testing.assert_array_equal(pal, j_palette())
    assert pal[1].tolist() == [128, 0, 0] and pal[15].tolist() == [192, 128, 128]


def _reference_sd(params, state):
    """A reference DRNSeg state_dict: DataParallel's ``module.``, the
    ``base.`` backbone, the (C, 1, 16, 16) upsampler, BN counters."""
    sd = {}
    for k, v in {**params, **state}.items():
        key = "base." + k[len("layer."):] if k.startswith("layer.") else k
        sd["module." + key] = v
    c = params["seg.weight"].shape[0]
    sd["module.up.weight"] = params["up.weight"].expand(c, 1, 16, 16).clone()
    sd["module.base.0.1.num_batches_tracked"] = torch.tensor(3)
    return sd


@pytest.mark.parametrize("envelope", [False, True])
def test_load_pth_matches_tpuseg(tmp_path, envelope):
    params, state, _ = init_drnseg(2, "drn_d_22", 19)
    sd = _reference_sd(params, state)
    path = str(tmp_path / "m.pth")
    torch.save({"state_dict": sd, "epoch": 9, "best_prec1": 61.5} if envelope else sd, path)
    tp, ts, tmeta = tti.load_pth(path)
    jp, js, jmeta = jti.load_pth(path)
    assert tmeta == jmeta == ({"epoch": 9, "best_prec1": 61.5} if envelope else {})
    bp, bs = to_jax_params(tp, ts)
    assert sorted(bp) == sorted(jp) and sorted(bs) == sorted(js)
    for k in jp:
        np.testing.assert_array_equal(bp[k], np.asarray(jp[k]), err_msg=k)
    for k in js:
        np.testing.assert_array_equal(bs[k], np.asarray(js[k]), err_msg=k)
    for k, v in params.items():
        assert torch.equal(tp[k], v), k
    assert tp["up.weight"].shape == (16, 16)


def test_state_dict_round_trips():
    """``export_state_dict`` -> ``convert_state_dict`` gives the params
    back (but the upsampler, which torch rebuilds); the export equals
    ``tpuseg``'s export of the same weights; keys normalize as in
    ``tpuseg``."""
    params, state, _ = init_drnseg(1, "drn_d_22", 5)
    sd = tti.export_state_dict(params, state)
    jp, js = to_jax_params(params, state)
    jsd = jti.export_state_dict(jp, js)
    assert sorted(sd) == sorted(jsd) and "up.weight" not in sd
    for k in jsd:
        np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
    p2, s2 = tti.convert_state_dict(sd)
    for k, v in params.items():
        if k != "up.weight":
            assert torch.equal(p2[k], v), k
    for k, v in state.items():
        assert torch.equal(s2[k], v), k
    p3, _ = tti.convert_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                   dtype=torch.bfloat16)
    assert p3["seg.weight"].dtype == torch.bfloat16
    for key in ("module.base.3.0.conv1.weight", "base.0.0.weight", "fc.weight", "module.fc.bias"):
        assert tti.normalize_key(key) == jti.normalize_key(key)


def test_load_pretrained_backbone_local_path(tmp_path):
    """A DRN-D-22 classifier ``.pth`` (classifier keys ``layer3...``, an
    ImageNet fc) fills a DRNSeg's backbone, the head kept, as
    ``tpuseg``'s; a checkpoint of another arch raises; ``auto`` resolves
    to the published URL and a local path passes through (no download)."""
    spec = build_drn_spec("drn_d_22", num_classes=1000, naming="cls")
    cp, cs = init_drn(9, spec)
    path = str(tmp_path / "drn_d_22.pth")
    torch.save({**cp, **cs}, path)
    params, state, _ = init_drnseg(0, "drn_d_22", 19)
    tp, ts, n = tti.load_pretrained_backbone("drn_d_22", path, params, state)
    jp0, js0 = to_jax_params(params, state)
    jp, js, jn = jti.load_pretrained_backbone("drn_d_22", path, jp0, js0)
    assert n == jn == len(cp) - 2 + len(cs)
    bp, bs = to_jax_params(tp, ts)
    for k in jp:
        np.testing.assert_array_equal(bp[k], np.asarray(jp[k]), err_msg=k)
    for k in js:
        np.testing.assert_array_equal(bs[k], np.asarray(js[k]), err_msg=k)
    assert torch.equal(tp["layer.3.0.conv1.weight"], cp["layer3.0.conv1.weight"])
    assert torch.equal(tp["seg.weight"], params["seg.weight"])
    other, other_s = init_drn(0, build_drn_spec("drn_d_38", num_classes=1000))
    bad = str(tmp_path / "drn_d_38.pth")
    torch.save({**other, **other_s}, bad)
    with pytest.raises(KeyError, match="no slot"):
        tti.load_pretrained_backbone("drn_d_22", bad, params, state)
    assert tti.resolve_backbone_source("auto", "drn_d_22") == \
        jti.resolve_backbone_source("auto", "drn_d_22")
    assert tti.fetch_backbone(path) == path
    with pytest.raises(ValueError, match="no published"):
        tti.resolve_backbone_source("auto", "drn_a_50")
