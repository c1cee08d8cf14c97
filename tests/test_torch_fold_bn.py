"""Port parity: tpuseg_torch.ops.fold_bn against tpuseg.ops.fold_bn, with
non-trivial BN statistics drawn from a seed."""

import numpy as np
import pytest
import torch

from tpuseg.models import drnseg as jseg
from tpuseg.ops.fold_bn import fold_bn as jfold
from tpuseg_torch.models import drn as tdrn
from tpuseg_torch.models.weights import from_jax_params, to_jax_params
from tpuseg_torch.ops.fold_bn import fold_bn as tfold

torch.set_num_threads(2)


def _bn_world(arch, seed):
    rng = np.random.default_rng(seed)
    params, state, spec = jseg.init_drnseg(0, arch, 19)
    params = dict(params)
    state = {k: (rng.normal(0, 0.2, v.shape) if k.endswith("mean")
                 else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
             for k, v in state.items()}
    for k in list(params):
        stem = k.rsplit(".", 1)[0]
        if f"{stem}.running_var" in state:
            base = 1.0 if k.endswith(".weight") else 0.0
            params[k] = (base + rng.normal(0, 0.1, params[k].shape)).astype(np.float32)
    return params, state, spec


@pytest.mark.parametrize("arch", ["drn_d_22", "drn_d_54"])
def test_fold_bn_matches_jax(arch):
    params, state, spec = _bn_world(arch, 1)
    ref = jfold(params, state, spec)
    tp, ts = from_jax_params(params, state)
    out, _ = to_jax_params(tfold(tp, ts, tdrn.build_drn_spec(arch, 0, naming="seg")))
    assert sorted(out) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(out[k], np.asarray(v, np.float32), err_msg=k)


def test_folded_forward_matches_unfolded():
    params, state, _ = _bn_world("drn_d_22", 2)
    tp, ts = from_jax_params(params, state)
    spec = tdrn.build_drn_spec("drn_d_22", 0, naming="seg")
    x = torch.from_numpy(
        np.random.default_rng(3).normal(size=(2, 48, 40, 3)).astype(np.float32))
    ref, _ = tdrn.drn_forward(tp, ts, x, spec)
    out, _ = tdrn.drn_forward(tfold(tp, ts, spec), {}, x, spec)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4 * ref.abs().max().item())
