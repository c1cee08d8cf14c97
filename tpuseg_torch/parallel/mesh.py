"""Device-mesh parallelism (counterpart of ``tpuseg/parallel/mesh.py``).

``tpuseg`` runs one jitted program over a ``jax.sharding.Mesh`` and lets XLA
insert the collectives; its semantics are those of the unsharded program
over the global batch.  The port keeps those semantics with PyTorch's own
idiom for each axis:

- training's ``data`` axis: one process (rank) per device under
  ``torch.distributed`` (NCCL between cards, gloo on the CPU).  The train
  step takes train-mode BatchNorm statistics over the global batch (count,
  mean and M2 gathered and combined, Chan's method, through collectives
  that carry the gradient back), divides each rank's summed loss by the
  GLOBAL count of valid pixels, and sums the gradients with one flat
  all-reduce before the optimizer (``Ranks``).  A plain DDP wrap would
  average per-rank means and take per-rank BN statistics: both differ from
  the global batch;
- serving's ``data`` axis: replicas in one process, one per device of the
  mesh, no collective (``tpuseg_torch.video.pipeline.VideoSegmenter``);
- the ``spatial`` axis: ranks of a spatial subgroup, each holding a strip
  of image rows, with the convolutions' halos exchanged explicitly
  (``tpuseg_torch.parallel.halo``).

A ``Mesh`` here is the (data, spatial) grid of ``torch.device``s plus, when
a process group is up, this rank's place in it and the groups the step
reduces over.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Sequence

import numpy as np
import torch


def _dist():
    import torch.distributed as dist

    return dist


def _world() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: torch.device | str | None = None,
) -> None:
    """Join a process group of ``num_processes`` ranks (replaces
    ``dist.init_process_group``, rmbsnn_main.py:169-170).  No-op for one
    process or fewer.

    ``coordinator_address`` is ``host:port`` (a TCP store on rank 0) or a
    ``file://`` URL.  The backend is NCCL for a CUDA ``device`` (with gloo
    beside it for CPU tensors, which asynchronous checkpoints need) and gloo
    for the CPU; ``backend`` overrides it, e.g. gloo for ranks that share
    one card, which NCCL refuses."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a process group needs a coordinator address and a process id")
    dist = _dist()
    device = torch.device(device) if device is not None else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend=backend, init_method=init, world_size=num_processes,
                            rank=process_id)


def data_parallel_size(batch_size: int, n_devices: int) -> int:
    """Largest device count ≤ ``n_devices`` that divides ``batch_size``."""
    d = max(1, min(batch_size, n_devices))
    while batch_size % d:
        d -= 1
    return d


def local_ranks(batch_size: int, mesh_devices: int, device: torch.device | str) -> int:
    """How many local ranks ``--mesh-devices`` starts in one invocation:
    ``tpuseg``'s rule (the largest divisor of the batch among at most
    ``mesh_devices`` available devices, 0 meaning all of them), with the
    available devices the visible cards for CUDA and, on the CPU, as many
    gloo ranks as asked for (one without ``--mesh-devices``)."""
    device = torch.device(device)
    avail = (torch.cuda.device_count() if device.type == "cuda"
             else max(1, mesh_devices or 1))
    cap = mesh_devices if mesh_devices and mesh_devices > 0 else avail
    return data_parallel_size(batch_size, min(cap, avail))


def rank_device(device: torch.device | str, rank: int) -> torch.device:
    """The device of local rank ``rank``: ``cuda:rank`` for a CUDA run (one
    rank per card), the CPU for a CPU run."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, spatial) grid of devices.

    ``rank`` is None when one process drives every device (serving
    replicas); otherwise it is this process's rank in the default process
    group, which covers the grid in row-major order, and ``spatial_group``
    the subgroup of the ranks that share this rank's data index."""

    devices: np.ndarray  # (data, spatial) object array of torch.device
    rank: int | None = None
    spatial_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.devices.shape[0], "spatial": self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """This rank's device (the first device for a one-process mesh)."""
        return self.devices.flat[self.rank or 0]

    @property
    def data_index(self) -> int:
        return (self.rank or 0) // self.devices.shape[1]

    @property
    def spatial_index(self) -> int:
        return (self.rank or 0) % self.devices.shape[1]

    @property
    def is_main(self) -> bool:
        return not self.rank

    def ranks(self, spatial: bool = False) -> "Ranks | None":
        """The reduction context a step of this rank runs with (None for a
        one-rank mesh: the step then runs exactly as without a mesh)."""
        if self.rank is None or self.size == 1:
            return None
        halo = None
        if spatial and self.devices.shape[1] > 1:
            from tpuseg_torch.parallel.halo import Halo

            halo = Halo(self.spatial_group, self.spatial_index, self.devices.shape[1])
        return Ranks(group=None, size=self.size, rank=self.rank, halo=halo)


def make_mesh(
    data: int | None = None,
    spatial: int = 1,
    devices: Sequence[torch.device] | None = None,
) -> Mesh:
    """Build a (data, spatial) mesh.

    With a process group of more than one rank up, the mesh covers its
    ranks (``data * spatial`` must equal the world size) and ``devices``
    lists each rank's device (by default this rank's device everywhere:
    a rank only drives its own); the spatial subgroups are created here,
    so every rank must call this with the same shape.  Without one, the
    mesh is ``devices`` (by default the visible cards) driven by this
    process."""
    world = _world()
    if world > 1:
        dist = _dist()
        rank = dist.get_rank()
        if devices is None:
            here = (torch.device("cuda", torch.cuda.current_device())
                    if torch.cuda.is_available() and dist.get_backend() != "gloo"
                    else torch.device("cpu"))
            devices = [here] * world
        devices = [torch.device(d) for d in devices]
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for a process group of {world} ranks")
        if data is None:
            data = world // spatial
        if data * spatial != world:
            raise ValueError(f"mesh {data}x{spatial} != {world} ranks")
        spatial_group = None
        if spatial > 1:
            for d in range(data):  # every rank creates every subgroup, in order
                g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
                if d == rank // spatial:
                    spatial_group = g
        grid = np.empty((data, spatial), dtype=object)
        grid.flat[:] = devices
        return Mesh(grid, rank=rank, spatial_group=spatial_group)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data is None:
        data = n // spatial
    if data * spatial != n or n == 0:
        raise ValueError(f"mesh {data}x{spatial} != {n} devices")
    if spatial > 1:
        raise ValueError("a spatial axis needs one rank per device (a process group)")
    grid = np.empty((data, spatial), dtype=object)
    grid.flat[:] = devices
    return Mesh(grid)


def setup_data_parallel(batch_size: int, mesh_devices: int = 0, device="cpu"):
    """The training mesh of this rank and its local batch size
    (``tpuseg``'s ``setup_data_parallel`` without the shardings, which the
    port does not have): ``(mesh, local_batch_size)``.

    In a process group of several ranks the batch is GLOBAL and must divide
    by the world size (one device a rank: rank r on ``rank_device(device,
    r)``); each rank feeds batch ÷ world samples.  A single process trains
    on ``device`` with the whole batch (``local_ranks`` says how many ranks
    a launcher starts for ``mesh_devices``)."""
    del mesh_devices  # the launcher applied it (local_ranks)
    world = _world()
    if world > 1:
        if batch_size % world:
            raise SystemExit(
                f"--batch-size {batch_size} must be divisible by the global "
                f"device count {world} in multi-process mode"
            )
        devices = [rank_device(device, r) for r in range(world)]
        return make_mesh(data=world, spatial=1, devices=devices), batch_size // world
    return make_mesh(data=1, spatial=1, devices=[torch.device(device)]), batch_size


def sum_over_ranks(mesh: Mesh, a: np.ndarray) -> np.ndarray:
    """``a`` summed over the mesh's ranks, exactly (int64 stays int64; a
    one-process mesh returns ``a``)."""
    if mesh.rank is None or mesh.size == 1:
        return a
    t = torch.from_numpy(np.array(a))
    _dist().all_reduce(t)
    return t.numpy()


def gather_over_ranks(mesh: Mesh, a: np.ndarray) -> np.ndarray:
    """(ranks, *a.shape): every rank's equal-shape ``a``, in rank order."""
    if mesh.rank is None or mesh.size == 1:
        return a[None]
    t = torch.from_numpy(np.array(a))
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    _dist().all_gather(out, t)
    return torch.stack(out).numpy()


def _tree_map(fn: Callable, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def replicate(mesh: Mesh, tree):
    """Copy a tree of tensors (dicts, tuples, a ``TrainState``) to the
    mesh: to this rank's device for a rank mesh, else a list with one copy
    for each device (serving replicas; one copy per distinct device)."""
    if mesh.rank is not None or mesh.size == 1:
        return _tree_map(lambda t: t.to(mesh.device), tree)
    copies = {}
    for d in mesh.devices.flat:
        if d not in copies:
            copies[d] = _tree_map(lambda t, d=d: t.to(d), tree)
    return [copies[d] for d in mesh.devices.flat]


def _part(x, index: int, count: int, dim: int):
    n = x.shape[dim]
    if n % count:
        raise ValueError(f"dim {dim} of size {n} does not divide over {count} ranks")
    size = n // count
    return x.narrow(dim, index * size, size) if isinstance(x, torch.Tensor) else \
        np.take(x, np.arange(index * size, (index + 1) * size), axis=dim)


def shard_batch(mesh: Mesh, batch, axis: str | tuple[str, ...] = "data"):
    """This rank's part of array(s) of the global batch: the leading (batch)
    dim split over the data axis, and with ``axis=("data", "spatial")`` the
    H dim (dim 1) split over the spatial axis too, contiguous parts in rank
    order.  A one-process mesh returns the batch as it is."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)

    def one(x):
        if mesh.rank is None:
            return x
        x = _part(x, mesh.data_index, mesh.shape["data"], 0)
        if "spatial" in axes:
            check_spatial_height(x.shape[1], mesh.shape["spatial"])
            x = _part(x, mesh.spatial_index, mesh.shape["spatial"], 1)
        return x

    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return one(batch)
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    return type(batch)(shard_batch(mesh, v, axis) for v in batch)


def put_global_batch(mesh: Mesh, x):
    """One per-rank batch array (numpy or a tensor) onto this rank's device:
    in a process group the array IS this rank's slice of the global batch,
    which the step's collectives make global (``tpuseg``'s
    ``make_array_from_process_local_data``)."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return t.to(mesh.device, non_blocking=True)


def check_spatial_height(h: int, spatial: int) -> None:
    """Strips of a spatially sharded DRN must stay whole rows at every
    output stride down to 8 (the ×8 upsampler's input grid)."""
    if h % (spatial * 8):
        raise ValueError(f"image height {h} must divide by spatial*8 = {spatial * 8} "
                         "to shard H over the spatial axis")


def shard_train_step(
    train_step: Callable,
    mesh: Mesh,
    spatial: bool = False,
) -> Callable:
    """Wrap a port train step (``make_seg_train_step``/``make_cls_train_step``)
    for data parallelism over ``mesh``: each rank calls the wrapped step
    with its own part of the batch (``shard_batch``) and its replica of the
    state, and the step reduces BN statistics, the loss's count and the
    gradients over every rank of the mesh, so every replica takes the
    update of the unsharded step over the global batch.

    ``spatial=True`` takes each rank's part as a strip of rows of its data
    shard (``shard_batch(..., axis=("data", "spatial"))``): the convolutions
    exchange halos over the spatial subgroup and the reductions still span
    the whole (data x spatial) world."""
    ranks = mesh.ranks(spatial=spatial)

    def step(state, images, labels):
        if ranks is not None and ranks.halo is not None:
            # strips are whole rows at every stride down to 8
            check_spatial_height(images.shape[1] * ranks.halo.count, ranks.halo.count)
        return train_step(state, images, labels, ranks=ranks)

    return step


def spatial_forward(forward: Callable, mesh: Mesh) -> Callable:
    """A forward ``(params, state, x, ranks=...) -> (N, H, W, C)`` with the
    activations sharded over H (NHWC dim 1) across the mesh's spatial
    ranks: each rank takes its strip of rows of the FULL input ``x``, the
    convolutions and the ×8 upsampler exchange halos, and the strips of
    the output are gathered, so every rank returns the full output (for
    frames whose activations exceed one card's memory)."""
    ranks = mesh.ranks(spatial=True)
    if ranks is None or ranks.halo is None:
        raise ValueError("spatial_forward needs a mesh with a spatial axis of ranks")

    def run(params, state, x):
        check_spatial_height(x.shape[1], mesh.shape["spatial"])
        strip = _part(x, mesh.spatial_index, mesh.shape["spatial"], 1)
        with torch.no_grad():
            out = forward(params, state, strip, ranks=ranks)
            return ranks.halo.gather_rows(out)

    return run


class _GatherSlabs(torch.autograd.Function):
    """``all_gather`` of equal-size tensors, stacked, whose backward sums
    every rank's gradient for each slab back onto its owner (one
    ``all_reduce`` of the stacked gradients, then this rank's slab).  Both
    NCCL and gloo take these two collectives on CUDA tensors."""

    @staticmethod
    def forward(ctx, t, group, index):
        dist = _dist()
        ctx.group, ctx.index = group, index
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, t, group=group)
        return torch.stack(out)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _dist().all_reduce(grad, group=ctx.group)
        return grad[ctx.index], None, None


def gather(t: torch.Tensor, group, index: int) -> torch.Tensor:
    """(R, *t.shape): every rank's ``t``, in rank order, with the gradient
    flowing back to each owner."""
    return _GatherSlabs.apply(t, group, index)


@dataclasses.dataclass(frozen=True)
class Ranks:
    """The reduction context of one rank's train step: the ``size`` ranks
    of ``group`` (None: the default group) hold equal parts of the global
    batch; ``halo`` (a ``tpuseg_torch.parallel.halo.Halo``) when the parts
    are strips of rows.  Passed explicitly down the forward
    (``drn_forward(ranks=...)``), the losses and the step."""

    group: Any
    size: int
    rank: int
    halo: Any = None

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Autograd-aware gather of ``t`` from every rank: (size, *t.shape)."""
        return gather(t, self.group, self.rank)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (no gradient): a new tensor."""
        t = t.detach().clone()
        _dist().all_reduce(t, group=self.group)
        return t

    def sum_grads(self, grads: dict) -> dict:
        """Every gradient summed over the ranks with ONE flat all-reduce."""
        keys = list(grads)
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        _dist().all_reduce(flat, group=self.group)
        out, at = {}, 0
        for k in keys:
            n = grads[k].numel()
            out[k] = flat[at:at + n].view_as(grads[k])
            at += n
        return out


def launch(fn: Callable, args, batch_size: int, spawn: bool = True, requires: str = ""):
    """A trainer CLI's entry (``args`` with ``device``, ``mesh_devices``,
    ``num_processes``, ``coordinator``, ``process_id``): with
    ``--num-processes P`` > 1 join the P-process group as
    ``--process-id`` and run ``fn(args)`` (``requires`` ends the message
    when the coordinator or the id is missing); else, when ``spawn`` and
    ``local_ranks`` says so, start that many local ranks running
    ``fn(args)`` and return rank 0's result; else run ``fn(args)`` here."""
    device = torch.device(args.device)
    if args.num_processes and args.num_processes > 1:
        if args.coordinator is None or args.process_id is None:
            raise SystemExit("--num-processes > 1 requires --coordinator host:port and "
                             "--process-id" + requires)
        from tpuseg_torch.device import resolve_device

        initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                               device=rank_device(resolve_device(device), args.process_id))
        return fn(args)
    if spawn and device.type == "cuda" and not torch.cuda.is_available():
        spawn = False  # fn raises for the missing card, as one process does
    n = local_ranks(batch_size, args.mesh_devices, device) if spawn else 1
    if n > 1:
        return spawn_ranks(fn, n, args.device, args=(args,))[0]
    return fn(args)


def _rank_main(index, n, init, device, backend, result_dir, blocked, fn, args):
    """One rank started by ``spawn_ranks``: join the group, run ``fn``,
    leave its return value in ``result_dir``."""
    import pickle
    import sys

    for name in blocked:
        sys.modules[name] = None
    if index:
        sys.stdout = open(os.devnull, "w")  # one result stream: rank 0's
    dev = rank_device(device, index)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize_distributed(init, n, index, backend=backend, device=dev)
    try:
        out = fn(*args)
        with open(os.path.join(result_dir, f"result{index}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        if _dist().is_initialized():
            _dist().destroy_process_group()


def spawn_ranks(fn: Callable, n: int, device, args: tuple = (), backend: str | None = None,
                timeout: float | None = None) -> list:
    """Run ``fn(*args)`` in ``n`` local ranks started with
    ``torch.multiprocessing`` (one a card, or ``n`` gloo ranks on the CPU),
    joined through a file store in a fresh temporary directory; returns
    every rank's return value, in rank order.  A rank that fails fails the
    call; past ``timeout`` seconds every rank is killed and the call
    raises ``TimeoutError`` (a deadlocked collective never hangs the
    caller).  A module the caller blocked (None in ``sys.modules``) stays
    blocked in the ranks, as a forked child would see it."""
    import pickle
    import sys
    import time

    import torch.multiprocessing as mp

    blocked = [k for k, v in sys.modules.items() if v is None]
    with tempfile.TemporaryDirectory(prefix="tpuseg_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(n, init, str(device), backend, tmp, blocked, fn, args),
            nprocs=n, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{n} ranks still running after {timeout} s")
        out = []
        for i in range(n):
            with open(os.path.join(tmp, f"result{i}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
