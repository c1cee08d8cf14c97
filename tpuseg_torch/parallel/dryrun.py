"""A multi-rank dry run of the port's trainer (counterpart of
``__graft_entry__.dryrun_multichip``): ``n`` ranks, one masked DRN-D-22
train step with stage rematerialization on tiny shapes, over a data x
spatial mesh when ``n`` is even (the batch split over ``data``, the image
rows over ``spatial``).

    python -m tpuseg_torch.parallel.dryrun 2                 # one rank a card
    python -m tpuseg_torch.parallel.dryrun 4 --device cpu    # gloo ranks on the CPU
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

CONFIG = "optimal_configs/drn_d_22/drn_d_22_512X512_0.00_50.00.json"


def _step(n: int, device: str) -> dict:
    import torch

    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.parallel import make_mesh, shard_batch, shard_train_step
    from tpuseg_torch.sparsity import create_masker
    from tpuseg_torch.train import create_train_state, make_seg_train_step, make_sgd

    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    cfg = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), CONFIG)
    masks = create_masker(cfg, seed=0).generate_masks(params)
    sp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // sp
    mesh = make_mesh(data=dp, spatial=sp)
    dev = mesh.device
    tx = make_sgd(0.01)
    on = lambda d: {k: v.to(dev) for k, v in d.items()}  # noqa: E731
    ts = create_train_state(on(params), on(state), tx, on(masks))
    step = shard_train_step(make_seg_train_step(spec, tx, compute_dtype=None, remat=True),
                            mesh, spatial=sp > 1)
    rng = np.random.default_rng(0)
    images = rng.random((dp, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 19, size=(dp, 32, 32))
    axis = ("data", "spatial") if sp > 1 else "data"
    x, y = (torch.from_numpy(a).to(dev) for a in shard_batch(mesh, [images, labels], axis))
    ts2, metrics = step(ts, x, y)
    loss = float(metrics["loss"])
    assert math.isfinite(loss), f"non-finite loss {loss}"
    assert ts2.step == ts.step + 1
    return {"ranks": n, "data": dp, "spatial": sp, "loss": loss}


def dryrun_multichip(n: int, device: str = "cuda") -> dict:
    """``n`` ranks (one a card, or gloo ranks on the CPU when
    ``device="cpu"``), one masked train step with remat; returns rank 0's
    summary and prints it.  Raises when there are fewer cards than ranks."""
    import torch

    from tpuseg_torch.parallel.mesh import spawn_ranks

    if torch.device(device).type == "cuda" and torch.cuda.device_count() < n:
        raise SystemExit(f"dryrun_multichip({n}) needs {n} CUDA devices, "
                         f"found {torch.cuda.device_count()}; pass --device cpu for gloo ranks")

    out = spawn_ranks(_step, n, device, args=(n, device))[0]
    print(f"dryrun_multichip({n}): ok, mesh=data{out['data']}xspatial{out['spatial']}, "
          f"remat+masks, loss={out['loss']:.4f}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int)
    p.add_argument("--device", default="cuda", help="cuda (one rank a card) or cpu (gloo ranks)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
