"""Regenerate the vendored config set ``optimal_configs/`` (the port's copy
of ``tpuseg/tools/gen_configs.py``).

Three families, each a JSON file per entry of its matrix, written with
``json.dump(indent=4)`` and a newline, byte-identical to the vendored files
(tests/test_torch_tools_port.py regenerates all 23):

- ``MATRIX``: the reference's srmbrep (RBGP) set,
  ``<arch>/<arch>_<H>X<W>_0.00_<isp%>.json``, from the sweeper's geometry
  policy (``tpuseg_torch.cli.expander_batch.generate_rbgp_config``:
  uniform 64x32 outer / 32x32 core / 2x2 inner blocks clamped per layer,
  RAMANUJAN patterns, osp 0).  The mask geometry does not depend on the
  resolution, so files of one arch and sparsity have the same content; the
  reference's names are kept.
- ``SERVING_MATRIX``: ``block`` configs, ``<arch>_block128_<sp%>.json``, 128x128
  BlockPruner blocks on every conv whose channels divide by 128 and that
  has at least two blocks (a single-block layer would be zeroed whole by
  BlockPruner's strict threshold).
- ``REGULAR_MATRIX``: ``block_regular`` configs, ``<arch>_block128reg_<sp%>.json``,
  on every conv whose channels divide by 128.

Layers are listed in the order of the port's param dict, drawn by
``init_drnseg(jax_key(0), arch, 19)`` (the weights ``tpuseg`` draws from
``jax.random.key(0)``); only their shapes matter.  Geometry only: it runs
on the CPU, with no card.

    python -m tpuseg_torch.tools.gen_configs [--out optimal_configs]
"""

from __future__ import annotations

import argparse
import json
import os

# (arch, "HxW" resolution tag, inner sparsity): the reference's shipped
# matrix, plus drn_d_38 (tpuseg/tools/gen_configs.py:46-64)
MATRIX: list[tuple[str, str, float]] = [
    ("drn_d_22", "64X128", 0.50),
    ("drn_d_22", "224X224", 0.50),
    ("drn_d_22", "512X256", 0.50),
    ("drn_d_22", "512X256", 0.75),
    ("drn_d_22", "512X512", 0.50),
    ("drn_d_22", "512X512", 0.75),
    ("drn_d_22", "1024X768", 0.50),
    ("drn_d_22", "1024X768", 0.75),
    ("drn_d_22", "1024X768", 0.875),
    ("drn_d_54", "512X512", 0.50),
    ("drn_d_54", "512X512", 0.75),
    ("drn_d_54", "1024X768", 0.50),
    ("drn_d_38", "512X512", 0.50),
]
SERVING_MATRIX: list[tuple[str, float]] = [
    ("drn_d_22", 0.50),
    ("drn_d_22", 0.75),
    ("drn_d_22", 0.875),
    ("drn_d_38", 0.875),
    ("drn_d_54", 0.875),
]
REGULAR_MATRIX: list[tuple[str, float]] = list(SERVING_MATRIX)
BLOCK = 128


def config_filename(arch: str, res: str, isp: float) -> str:
    """The reference's naming: <arch>_<H>X<W>_<osp%>_<isp%>.json, 2 decimals."""
    return f"{arch}_{res}_0.00_{100 * isp:.2f}.json"


class _Params:
    """The port's DRNSeg params per arch, drawn once."""

    def __init__(self):
        self._by_arch: dict[str, dict] = {}

    def __call__(self, arch: str) -> dict:
        if arch not in self._by_arch:
            from tpuseg_torch.models.drn import jax_key
            from tpuseg_torch.models.drnseg import init_drnseg

            self._by_arch[arch] = init_drnseg(jax_key(0), arch, 19)[0]
        return self._by_arch[arch]


def _block_layers(params: dict, min_blocks: int) -> list[str]:
    """Convs (OIHW) whose channels divide by 128, with at least
    ``min_blocks`` 128x128 blocks, in param order; ``up.weight`` excluded."""
    layers = []
    for name, w in params.items():
        if w.dim() != 4 or name == "up.weight":
            continue
        cout, cin = w.shape[:2]
        if cout % BLOCK or cin % BLOCK or (cout // BLOCK) * (cin // BLOCK) < min_blocks:
            continue
        layers.append(name)
    return layers


def _write(out_root: str, arch: str, fname: str, cfg: dict) -> str:
    d = os.path.join(out_root, arch)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, fname)
    with open(path, "w") as fh:
        json.dump(cfg, fh, indent=4)
        fh.write("\n")
    return path


def emit_optimal_configs(out_root: str, matrix=None, verbose: bool = True,
                         params=None) -> list[str]:
    """Write the srmbrep matrix under ``out_root/<arch>/``; returns the paths."""
    from tpuseg_torch.cli.expander_batch import generate_rbgp_config

    params = params or _Params()
    written = []
    for arch, res, isp in MATRIX if matrix is None else matrix:
        cfg = generate_rbgp_config(params(arch), arch, oblock=(64, 32), cblock=(32, 32),
                                   iblock=(2, 2), osp=0.0, isp=isp)
        path = _write(out_root, arch, config_filename(arch, res, isp), cfg)
        if verbose:
            print(f"wrote {path} ({len(cfg['configs'])} layers, isp={isp})")
        written.append(path)
    return written


def emit_serving_configs(out_root: str, matrix=None, verbose: bool = True,
                         params=None) -> list[str]:
    """Write the 128x128 ``block`` serving configs under ``out_root/<arch>/``."""
    params = params or _Params()
    written = []
    for arch, sp in SERVING_MATRIX if matrix is None else matrix:
        layers = _block_layers(params(arch), min_blocks=2)
        cfg = {"pruner_type": "block", "configs": [{
            "layer_set": layers, "sparsity": sp, "block_height": BLOCK,
            "block_width": BLOCK, "sub_rows": -1, "sub_cols": -1, "collapse_tensor": False}]}
        path = _write(out_root, arch, f"{arch}_block128_{100 * sp:.2f}.json", cfg)
        if verbose:
            print(f"wrote {path} ({len(layers)} layers, sparsity={sp})")
        written.append(path)
    return written


def emit_regular_configs(out_root: str, matrix=None, verbose: bool = True,
                         params=None) -> list[str]:
    """Write the block-regular (block-level N:M) serving configs."""
    params = params or _Params()
    written = []
    for arch, sp in REGULAR_MATRIX if matrix is None else matrix:
        layers = _block_layers(params(arch), min_blocks=1)
        cfg = {"pruner_type": "block_regular", "configs": [{
            "layer_set": layers, "sparsity": sp, "block_height": BLOCK,
            "block_width": BLOCK}]}
        path = _write(out_root, arch, f"{arch}_block128reg_{100 * sp:.2f}.json", cfg)
        if verbose:
            print(f"wrote {path} ({len(layers)} layers, sparsity={sp})")
        written.append(path)
    return written


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(prog="python -m tpuseg_torch.tools.gen_configs",
                                description="regenerate the vendored optimal_configs/ set")
    p.add_argument("--out", default="optimal_configs")
    args = p.parse_args(argv)
    params = _Params()
    return (emit_optimal_configs(args.out, params=params)
            + emit_serving_configs(args.out, params=params)
            + emit_regular_configs(args.out, params=params))


if __name__ == "__main__":
    main()
