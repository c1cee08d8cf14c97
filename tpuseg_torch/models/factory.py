"""Model factory: dataset/arch dispatch (counterpart of
``tpuseg/models/factory.py``; the reference's ``create_model``,
utils.py:153-213, with classes per dataset at utils.py:164-174)."""

from __future__ import annotations

from tpuseg_torch.models import drn as drn_lib
from tpuseg_torch.models import drnseg as drnseg_lib

DATASET_CLASSES = {
    "imagenet": 1000,
    "cifar10": 10,
    "cifar100": 100,
    "mnist": 10,
    "cityscapes": 19,
    "ade20k": 150,
    "voc": 21,
}


def num_classes_for_dataset(dataset: str) -> int:
    return DATASET_CLASSES[dataset.lower()]


def create_model(key, dataset: str, arch: str):
    """``(params, state, spec, apply_kwargs)`` for a (dataset, arch) pair:
    a DRNSeg assembly for the segmentation datasets, the DRN classifier or a
    CIFAR-zoo model for the classification ones.  ``key`` is an int seed or
    a key's data (``models.drn.jax_key``: ``tpuseg``'s
    ``jax.random.key(seed)``)."""
    dataset = dataset.lower()
    classes = num_classes_for_dataset(dataset)
    if dataset in ("cityscapes", "ade20k", "voc"):
        params, state, spec = drnseg_lib.init_drnseg(key, arch, classes)
        return params, state, spec, {"kind": "seg", "classes": classes}
    if arch in drn_lib.DRN_ARCHS:
        spec = drn_lib.build_drn_spec(arch, num_classes=classes, naming="cls")
        params, state = drn_lib.init_drn(key, spec)
        return params, state, spec, {"kind": "cls", "classes": classes}
    from tpuseg_torch.models import cifar as cifar_lib

    params, state, spec = cifar_lib.create_cifar_model(key, arch, classes)
    return params, state, spec, {"kind": "cls", "classes": classes}
