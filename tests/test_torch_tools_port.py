"""The port's remaining tools against ``tpuseg``'s on the same inputs:
``tools/stats.py`` (per-layer sparsity, GEMM shapes), ``tools/visualize.py``
(the files written, from an npz checkpoint), ``tools/imagenet_prep.py``
(the directory tree made) and ``tools/gen_configs.py`` (all 23 files of
``optimal_configs/`` byte for byte, in an interpreter that loads no jax or
tpuseg module)."""

import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

from tpuseg_torch.models.weights import to_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "optimal_configs", "drn_d_22", "drn_d_22_block128_75.00.json")


@pytest.fixture(scope="module")
def masked_params():
    """DRN-D-22 DRNSeg (seed 0) with block128_75.00's masks applied, in the
    port's OIHW layout, plus a zero filter, a zero input channel and a
    zero Linear row so every statistic is exercised."""
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.sparsity import apply_masks, create_masker

    params, _, _ = init_drnseg(0, "drn_d_22", 19)
    masks = create_masker(CONFIG, seed=0).generate_masks(params, is_static=False)
    params = apply_masks(params, masks)
    params["layer.0.0.weight"] = params["layer.0.0.weight"].clone()
    params["layer.0.0.weight"][3] = 0
    params["layer.1.0.weight"] = params["layer.1.0.weight"].clone()
    params["layer.1.0.weight"][:, 5] = 0
    fc = torch.from_numpy(np.random.default_rng(1).normal(size=(10, 32)).astype(np.float32))
    fc[2] = 0
    params["fc.weight"] = fc
    return params


@pytest.mark.parametrize("block", [None, (128, 128), (8, 16)])
def test_sparsity_stats_equal_tpuseg(masked_params, block):
    from tpuseg.tools import get_sparsity_stats as jstats
    from tpuseg_torch.tools import get_sparsity_stats

    got = get_sparsity_stats(masked_params, block=block)
    want = jstats(to_jax_params(masked_params)[0], block=block)
    assert got == want
    assert "up.weight" not in got and "fc.weight" in got
    assert got["layer.6.0.conv1.weight"]["overall_sparsity"] > 0.5
    if block == (128, 128):
        assert got["layer.6.0.conv1.weight"]["block_occupancy"] < 0.5


@pytest.mark.parametrize("arch", ["drn_d_22", "drn_d_38", "drn_d_54"])
@pytest.mark.parametrize("hw", [(512, 512), (96, 160)])
def test_matrix_shapes_equal_tpuseg(arch, hw):
    from tpuseg.models.drn import build_drn_spec as jspec
    from tpuseg.tools import get_matrix_shapes as jshapes
    from tpuseg_torch.models.drn import build_drn_spec
    from tpuseg_torch.tools import get_matrix_shapes

    got = get_matrix_shapes(build_drn_spec(arch, num_classes=0, naming="seg"), hw)
    want = jshapes(jspec(arch, num_classes=0, naming="seg"), hw)
    assert got == want and len(got) > 20
    with pytest.raises(TypeError, match="DrnSpec"):
        get_matrix_shapes(None)


def test_visualize_same_files(tmp_path, masked_params):
    pytest.importorskip("matplotlib")
    from tpuseg.sparsity import apply_masks as japply
    from tpuseg.tools.visualize import visualize_layer_masks as jvis
    from tpuseg_torch.tools import visualize
    from tpuseg_torch.train.checkpoint import save_checkpoint

    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.sparsity import create_masker

    params, state, _ = init_drnseg(0, "drn_d_22", 19)
    masks = create_masker(CONFIG, seed=0).generate_masks(params, is_static=False)
    ckpt = str(tmp_path / "ck.npz")
    save_checkpoint(ckpt, params, state, masks=masks, meta={"epoch": 1})
    paths = visualize.main([ckpt, "--out-dir", str(tmp_path / "t"), "--max-layers", "4"])
    hwio, _ = to_jax_params(params)
    jmasks, _ = to_jax_params(masks)
    want = jvis(japply(hwio, jmasks), str(tmp_path / "j"), 4)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in want]
    assert len(paths) == 4 and all(os.path.getsize(p) > 0 for p in paths)
    # every sparse layer without a limit; dense layers and up.weight skipped
    got = visualize.visualize_layer_masks(masked_params, str(tmp_path / "all"))
    names = {os.path.basename(p) for p in got}
    assert "layer.6.0.conv1.weight.png" in names and "up.weight.png" not in names
    assert "layer.2.0.weight.png" not in names


def _imagenet_layout(root):
    """Two class archives and three val images (one unmapped, one line
    malformed) under ``root``."""
    train = root / "train"
    val = root / "val"
    train.mkdir(parents=True)
    val.mkdir()
    for synset in ("n01440764", "n01443537"):
        src = root / f"{synset}_src"
        src.mkdir()
        for i in range(2):
            (src / f"{synset}_{i}.JPEG").write_bytes(f"{synset}{i}".encode())
        with tarfile.open(train / f"{synset}.tar", "w") as tf:
            for f in sorted(src.iterdir()):
                tf.add(f, arcname=f.name)
    (train / "notes.txt").write_text("not an archive")
    for i in range(1, 4):
        (val / f"ILSVRC2012_val_{i:08d}.JPEG").write_bytes(bytes([i]))
    mapping = root / "map.txt"
    mapping.write_text("ILSVRC2012_val_00000001.JPEG n01440764\n"
                       "ILSVRC2012_val_00000002.JPEG n01443537\n"
                       "malformed line here\n"
                       "ILSVRC2012_val_00000009.JPEG n01440764\n")
    return train, val, mapping


def _tree(root) -> dict:
    """Every file under ``root`` but the archives (their headers carry
    times) -> its bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".tar"):
                continue
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_imagenet_prep_same_tree(tmp_path, capsys):
    from tpuseg.tools import imagenet_prep as jprep
    from tpuseg_torch.tools import imagenet_prep

    t_train, t_val, t_map = _imagenet_layout(tmp_path / "t")
    j_train, j_val, j_map = _imagenet_layout(tmp_path / "j")
    assert imagenet_prep.main(["train", str(t_train)]) == 2
    assert imagenet_prep.main(["val", str(t_val), str(t_map)]) == 2
    jprep.main(["train", str(j_train)])
    jprep.main(["val", str(j_val), str(j_map)])
    got, want = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert got == want
    assert "train/n01440764/n01440764_1.JPEG" in got
    assert "val/n01443537/ILSVRC2012_val_00000002.JPEG" in got
    assert "val/ILSVRC2012_val_00000003.JPEG" in got  # unmapped: left in place
    assert "extracted 2 class archives" in capsys.readouterr().out


def test_gen_configs_reproduces_optimal_configs(tmp_path):
    """``python -m tpuseg_torch.tools.gen_configs --out <tmp>`` writes the
    23 vendored files byte for byte, loading no jax, jaxlib or tpuseg
    module."""
    code = (
        "import json, sys\n"
        "from tpuseg_torch.tools import gen_configs\n"
        f"paths = gen_configs.main(['--out', {str(tmp_path)!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpuseg'))\n"
        "print(json.dumps({'paths': paths, 'bad': bad}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    vendored = sorted(os.path.relpath(os.path.join(d, f), os.path.join(REPO, "optimal_configs"))
                      for d, _, fs in os.walk(os.path.join(REPO, "optimal_configs"))
                      for f in fs if f.endswith(".json"))
    written = sorted(os.path.relpath(p, tmp_path) for p in out["paths"])
    assert written == vendored and len(written) == 23
    for rel in vendored:
        with open(tmp_path / rel, "rb") as a, open(
                os.path.join(REPO, "optimal_configs", rel), "rb") as b:
            assert a.read() == b.read(), rel
