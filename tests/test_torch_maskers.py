"""Port parity for the masker copy: tpuseg_torch.sparsity's masks equal
tpuseg.sparsity's bit for bit for every pruner type, from the same seed on
DRN-D-22 weights; and the port's pruned and bench paths import no jax,
jaxlib or tpuseg module."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuseg.sparsity import create_masker as j_create_masker
from tpuseg.sparsity.block import BlockConfig as JBlockConfig
from tpuseg.sparsity.block import prune_as_block as j_prune_as_block
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.models.weights import to_jax_params
from tpuseg_torch.sparsity import create_masker
from tpuseg_torch.sparsity.block import BlockConfig, prune_as_block

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "optimal_configs", "drn_d_22")
LAYERS = ["layer.4.0.conv2.weight", "layer.5.0.conv1.weight", "layer.6.1.conv2.weight",
          "layer.7.0.weight"]
_BLOCKLETS = [{"bh": 4, "bw": 4, "count": 1}, {"bh": 2, "bw": 2, "count": 2}]

# the four pruner types the repo ships no DRN-D-22 config for, in the form
# tests/test_sparsity.py writes them
WRITTEN = {
    "hb": {"pruner_type": "hb", "configs": [{"layer_set": LAYERS, "levels": [
        {"sparsity": 0.5, "block_height": 16, "block_width": 16, "sub_rows": -1,
         "sub_cols": -1, "collapse_tensor": True},
        {"sparsity": 0.875, "block_height": 1, "block_width": 1, "sub_rows": -1,
         "sub_cols": -1, "collapse_tensor": True}]}]},
    "grouping": {"pruner_type": "grouping", "configs": [
        {"layer_set": LAYERS[:2], "num_groups": 4},
        {"layer_set": LAYERS[2:], "num_groups": 8}]},
    "rmb": {"pruner_type": "rmb", "configs": [{"layer_set": LAYERS[:2], "global_bh": 16,
                                               "global_bw": 16, "global_sp": 0.5,
                                               "blocklets": _BLOCKLETS}]},
    "rmcdb": {"pruner_type": "rmcdb", "configs": [{"layer_set": LAYERS, "global_bh": 16,
                                                   "global_bw": 16, "global_sp": 0.5,
                                                   "blocklets": _BLOCKLETS}]},
}
SHIPPED = {
    "block": "drn_d_22_block128_87.50.json",
    "block_regular": "drn_d_22_block128reg_75.00.json",
    "srmbrep": "drn_d_22_1024X768_0.00_87.50.json",
}


@functools.cache
def _params():
    params, _, _ = init_drnseg(0, "drn_d_22", 19)
    return params, to_jax_params(params)[0]


def _hwio(t):
    return np.ascontiguousarray(t.numpy().transpose(2, 3, 1, 0))


@pytest.mark.parametrize("ptype", list(SHIPPED) + list(WRITTEN))
def test_masks_bit_equal_every_pruner_type(ptype):
    """Same config, seed and DRN-D-22 weights: the copy's masks equal
    tpuseg's bit for bit (after the HWIO -> OIHW transpose), for each of the
    seven pruner types."""
    if ptype in SHIPPED:
        with open(os.path.join(CONFIGS, SHIPPED[ptype])) as fh:
            config = json.load(fh)
    else:
        config = WRITTEN[ptype]
    assert config["pruner_type"] == ptype
    tparams, jparams = _params()
    tmasks = create_masker(config, seed=3).generate_masks(tparams)
    jmasks = j_create_masker(config, seed=3).generate_masks(jparams, is_static=True)
    assert list(tmasks) == list(jmasks) and tmasks
    for k, m in tmasks.items():
        assert m.dtype == torch.float32 and m.shape == tparams[k].shape
        np.testing.assert_array_equal(_hwio(m), jmasks[k])
    # a real mask: neither all ones nor all zeros
    density = np.mean([float(m.mean()) for m in tmasks.values()])
    assert 0.0 < density < 1.0


@pytest.mark.parametrize("sparsity", [0.5, 0.75, 0.875])
def test_prune_as_block_bit_equal(sparsity):
    """The bench's magnitude BlockPruner masks (OIHW, 128x128 blocks, not
    collapsed) from the copy equal tpuseg's."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(512, 512, 3, 3)) * 0.05).astype(np.float32)
    got = prune_as_block(w, BlockConfig(sparsity, 128, 128, -1, -1, collapse_tensor=False))
    want = j_prune_as_block(w, JBlockConfig(sparsity, 128, 128, -1, -1, collapse_tensor=False))
    np.testing.assert_array_equal(got, want)
    assert got.mean() == pytest.approx(1 - sparsity, abs=0.02)


def test_port_modules_load_no_jax_or_tpuseg():
    """In a fresh interpreter: import every module of the port, make masks
    with the copy and build the pruned plan set of block128reg_87.50; no
    jax, jaxlib or tpuseg module is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpuseg_torch\n"
        "for m in pkgutil.walk_packages(tpuseg_torch.__path__, 'tpuseg_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from tpuseg_torch.models.drnseg import init_drnseg\n"
        "from tpuseg_torch.models.sparse_exec import build_sparse_plans\n"
        "from tpuseg_torch.ops.fold_bn import fold_bn\n"
        "from tpuseg_torch.sparsity import apply_masks, create_masker\n"
        "p, s, spec = init_drnseg(0, 'drn_d_22', 19)\n"
        f"masks = create_masker({os.path.join(CONFIGS, 'drn_d_22_block128reg_87.50.json')!r},"
        " seed=0).generate_masks(p)\n"
        "plans, report = build_sparse_plans(fold_bn(apply_masks(p, masks), s, spec), masks,"
        " spec, lowering='pallas')\n"
        "assert len(plans) == 10, report\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpuseg'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
