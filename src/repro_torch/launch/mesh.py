"""Process meshes (port of ``src/repro/launch/mesh.py`` and
``src/repro/launch/train.py parse_mesh``).

A mesh is a tuple of (axis name, size) pairs, outermost first, as
``comm.DistComm`` takes it; its product is the world size, one rank per
process. The helpers here name meshes and touch no device state.
``init_process`` starts one rank's process group: NCCL for a CUDA device,
gloo for the CPU. ``spawn`` runs a function once per rank in processes of
its own and collects what each returns.
"""
from __future__ import annotations

import datetime
import math
import os
import pathlib
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import rank_device

# init_process_group's and every sub-group's timeout
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


def parse_mesh(s: str | None):
    """``"4"`` -> (("data", 4),); ``"2x2"`` -> (("data", 2), ("model", 2));
    three dims -> pod, data, model. None or "" -> None (no mesh)."""
    if not s:
        return None
    dims = [int(x) for x in s.split("x")]
    names = ("data", "model")[:len(dims)] if len(dims) <= 2 else ("pod", "data", "model")
    if len(dims) > len(names):
        raise ValueError(f"mesh {s!r} has more than three dims")
    return tuple(zip(names, dims))


def make_production_axes(*, multi_pod: bool = False):
    """The reference's production meshes: 16 x 16 (data, model), or 2 x 16 x
    16 (pod, data, model)."""
    return (("pod", 2), ("data", 16), ("model", 16)) if multi_pod else \
        (("data", 16), ("model", 16))


def make_test_axes(shape=(2, 2), axes=("data", "model")):
    return tuple(zip(axes, shape))


def world_size(axes) -> int:
    return math.prod(s for _, s in axes)


def init_process(axes, device=None, init_method: str | None = None, *,
                 rank: int | None = None, world: int | None = None,
                 local_rank: int | None = None, backend: str | None = None,
                 timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the default process group as one rank of ``axes`` and return
    the rank's device. ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, when set
    (``torchrun`` sets them), win over the arguments; the device is
    ``cuda:{local rank}`` unless ``device`` says otherwise. A CUDA device
    takes NCCL and the CPU gloo, unless ``backend`` names one (gloo takes
    CUDA tensors too, through the host: the way to put several ranks on one
    card, which NCCL refuses); ``init_method`` defaults to ``env://``."""
    rank = int(os.environ.get("RANK", rank if rank is not None else 0))
    world = int(os.environ.get("WORLD_SIZE", world if world is not None else world_size(axes)))
    if world != world_size(axes):
        raise ValueError(f"the mesh {axes} holds {world_size(axes)} ranks, the "
                         f"world has {world}")
    dev = rank_device(device, local_rank if local_rank is not None else rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world, timeout=timeout,
                            device_id=dev if backend == "nccl" else None)
    return dev


def _run(rank: int, fn, world: int, init_method: str, out_dir: str, args) -> None:
    """One spawned rank: ``fn``'s result pickled into ``out_dir``, and its
    process group destroyed whatever happens."""
    try:
        result = fn(rank, world, init_method, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def spawn(fn, world: int, *args, timeout: float = 600.0, workdir=None) -> list:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` spawned
    processes (``init_method`` a ``file://`` rendezvous in a fresh temporary
    directory, under ``workdir`` if given) and return their results in rank
    order. A process that raises fails the call and the others are killed;
    so are all of them when ``timeout`` seconds pass first. ``fn`` must be
    importable by name in a fresh process, and so must its arguments."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_", dir=workdir) as d:
        ctx = mp.start_processes(_run, args=(fn, world, f"file://{d}/rendezvous", d, args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} did not end "
                                       f"within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world):
            with open(pathlib.Path(d) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
