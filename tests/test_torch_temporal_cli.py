"""The port's ``seg_video`` with this slice's flags, in a fresh interpreter,
against ``tpuseg``'s CLI on the same arguments (f32, CPU, shapes video):
the sequential adaptive mode, interval with nearest and warped reuse, the
yuv420 transport with packed ids and device outputs saved as overlays, and
autotuning.  The port's run also shows that none of the new modules loads
``jax``, ``jaxlib`` or ``tpuseg``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--video", "shapes", "--size", "128x128", "--frames", "8", "--batch", "4",
        "--dtype", "float32"]
CASES = {
    "sequential": ["--temporal-thresh", "3.0"],
    "interval": ["--temporal", "4", "--temporal-nearest", "--temporal-warp"],
    "transport": ["--transport", "yuv420", "--ids-pack", "5", "--device-outputs", "--overlay",
                  "--save-dir", "{dir}"],
    "autotune": ["--temporal-autotune", "0.9", "--autotune-frames", "8"],
}


def _lines(text):
    return [json.loads(ln) for ln in text.strip().splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case through the port's CLI in one fresh interpreter, which
    then lists the jax, jaxlib or tpuseg modules it loaded."""
    root = tmp_path_factory.mktemp("port")
    argvs = {name: [a.format(dir=root / name) for a in ["--device", "cpu", *BASE, *flags]]
             for name, flags in CASES.items()}
    code = (
        "import json, sys\n"
        "import tpuseg_torch.video.flow, tpuseg_torch.video.yuv, tpuseg_torch.video.live\n"
        "import tpuseg_torch.video.autotune, tpuseg_torch.ops.idpack\n"
        "from tpuseg_torch.cli import seg_video\n"
        f"for name, argv in {argvs!r}.items():\n"
        "    print('@@' + name, flush=True)\n"
        "    seg_video.main(argv)\n"
        "print('@@loaded ' + json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'tpuseg'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=600, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    parts = proc.stdout.split("@@")[1:]
    runs = {p.split("\n", 1)[0]: _lines(p.split("\n", 1)[1]) for p in parts[:-1]}
    return runs, json.loads(parts[-1].split(" ", 1)[1]), root


def _tpuseg_run(capsys, flags, root):
    from tpuseg.cli import seg_video

    seg_video.main([a.format(dir=root) for a in [*BASE, *flags]])
    return _lines(capsys.readouterr().out)


def test_new_modules_load_no_jax(port_runs):
    _, loaded, _ = port_runs
    assert loaded == []


@pytest.mark.parametrize("name", list(CASES))
def test_cli_matches_tpuseg(port_runs, capsys, tmp_path, name):
    """The result line has tpuseg's keys (and the port's ``device``) and the
    same frames, temporal fields, promotion rate and autotune choice; the
    events (ids_pack_auto, temporal_autotune with its table) are equal; the
    saved overlays are the same images."""
    runs, _, root = port_runs
    got = runs[name]
    want = _tpuseg_run(capsys, CASES[name], tmp_path / name)
    events = [ln for ln in got if "event" in ln]
    assert events == [ln for ln in want if "event" in ln]
    line, ref = got[-1], want[-1]
    assert set(line) == set(ref) | {"device"} and line["device"] == "cpu"
    timing = {"seconds", "fps", "device"}
    assert {k: v for k, v in line.items() if k not in timing} == \
        {k: v for k, v in ref.items() if k not in timing}
    if name == "sequential":
        assert 0 < line["promotion_rate"] <= 1 and "temporal_budget" not in line
    if name == "autotune":
        assert events[-1]["event"] == "temporal_autotune" and line["autotune_target"] == 0.9
    if name == "transport":
        from PIL import Image

        saved = sorted(os.listdir(root / name))
        assert saved == sorted(os.listdir(tmp_path / name)) and len(saved) == 8
        for f in saved:
            a = np.asarray(Image.open(root / name / f))
            b = np.asarray(Image.open(tmp_path / name / f))
            assert a.shape == (128, 128, 3)
            np.testing.assert_array_equal(a, b)
