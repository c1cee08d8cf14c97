"""What the benchmark loads: neither the harness nor the program it drives
loads JAX or the JAX package (top-level module names compared whole: the
port's name begins with the JAX package's), and the plain reference loads
nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tpuseg"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import h100bench.reference.drn, h100bench.work")
    assert not mods & (FORBIDDEN | {"tpuseg_torch"}), mods & (FORBIDDEN | {"tpuseg_torch"})


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import time\n"
        "from h100bench import harness, control, run, trace\n"
        "spec = harness.with_waiting(harness.bench_spec())\n"
        "for name in ('d22_b875_int8.clips30', 'd22.train512'):\n"
        "    over = ({'traffic': {'crop': [64, 64], 'batch': 2, 'ring': 4}} if 'train' in name\n"
        "            else {'config': {'frame': [64, 128]}, 'traffic': {'pool_frames': 8,\n"
        "                  'frames_per_call': 8, 'warm_frames': 4, 'batch': 4, 'check_frames': 2}})\n"
        "    cell = harness.cell_for(spec, name, 5, 'cpu', overrides=over)\n"
        "    harness.run_cell(spec, cell, 0.2, False, time.perf_counter())\n"
        "assert not harness.forbidden_modules()\n"
    )
    mods = _loaded(code)
    assert "tpuseg_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN
