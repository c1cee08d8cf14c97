"""The port's `semantic_seg test` (single-scale and `--ms`, with
`--save-vis`) against `tpuseg`'s on a fabricated list-file dataset, f32 on
the CPU: SegList, SegListMS, the eval transforms, the multi-scale resize
and the prediction dumps."""

import contextlib
import io
import json

import numpy as np
import pytest


@pytest.fixture(scope="module")
def mini_cityscapes(tmp_path_factory):
    """Two val images (32x48) with labels and an info.json, in the
    list-file layout SegList reads."""
    from PIL import Image

    root = tmp_path_factory.mktemp("mini")
    rng = np.random.default_rng(0)
    (root / "img").mkdir()
    names_i, names_l = [], []
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)).save(
            root / "img" / f"v{i}.png")
        lbl = rng.integers(0, 19, (32, 48)).astype(np.uint8)
        lbl[:3] = 255
        Image.fromarray(lbl).save(root / "img" / f"v{i}_l.png")
        names_i.append(f"img/v{i}.png")
        names_l.append(f"img/v{i}_l.png")
    (root / "val_images.txt").write_text("\n".join(names_i))
    (root / "val_labels.txt").write_text("\n".join(names_l))
    (root / "info.json").write_text(json.dumps({"mean": [0.29, 0.33, 0.29],
                                                "std": [0.18, 0.19, 0.18]}))
    return root


@pytest.mark.parametrize("ms", [False, True], ids=["single_scale", "multi_scale"])
def test_test_cmd_matches_tpuseg(mini_cityscapes, tmp_path, ms):
    """`test` (and `test --ms`) over files through SegList / SegListMS, f32:
    the per-class IoU line and the mIoU line equal to tpuseg's, and
    --save-vis writes the same prediction files."""
    from tpuseg.cli.semantic_seg import main as j_main
    from tpuseg_torch.cli.semantic_seg import main

    base = ["test", "-d", str(mini_cityscapes), "--batch-size", "1", "--dtype", "float32",
            "--save-vis"] + (["--ms", "--scales", "0.5,1.5"] if ms else [])
    out = {}
    for name, fn, extra in (("j", j_main, []), ("t", main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(base + extra + ["--save-dir", str(tmp_path / name)])
        out[name] = buf.getvalue().strip().splitlines()[-2:]
    assert out["t"] == out["j"] and json.loads(out["t"][-1])["miou"] > 0
    for sub in ("pred", "pred_color"):
        names = sorted(p.name for p in (tmp_path / "j" / sub / "img").iterdir())
        assert sorted(p.name for p in (tmp_path / "t" / sub / "img").iterdir()) == names
        assert names == ["v0.png", "v1.png"]
