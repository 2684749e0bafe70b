#!/usr/bin/env python3
"""What this torch's process groups do on the cards, before the port uses
them.

    python3 tools/nccl_probe.py

1. NCCL at world = the card count, one spawned process per card: an
   all-to-all of bf16, an all-gather of int32 and an all-reduce of f32,
   eagerly, then the three captured in one CUDA graph (after an eager
   warm-up that makes NCCL's communicator) and replayed; prints whether
   each result is right and the times of a replay and of an eager
   all-to-all (host wall clock over 100 calls). Also whether
   ``torch.distributed.all_gather_single`` exists.
2. gloo with two processes sharing card 0: whether ``all_to_all_single``,
   ``all_gather_into_tensor`` and ``all_reduce`` take CUDA tensors of
   bf16, f32, int32 and uint8, and give the right sums.
"""
from __future__ import annotations

import datetime
import pathlib
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.mesh import init_process, spawn  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=60)


def nccl_rank(rank: int, world: int, init_method: str) -> dict:
    dev = init_process((("data", world),), None, init_method, rank=rank, world=world,
                       timeout=TIMEOUT)
    x = (torch.arange(world * 4 * 8, device=dev) + 1000 * rank).to(torch.bfloat16)
    x = x.view(world, 4, 8)
    xi = (torch.arange(32, dtype=torch.int32, device=dev) + rank).view(4, 8)
    xf = torch.full((8,), float(rank + 1), device=dev)

    def collectives(scale):
        a = torch.empty_like(x)
        dist.all_to_all_single(a, x * scale)
        g = torch.empty((world * 4, 8), dtype=torch.int32, device=dev)
        dist.all_gather_into_tensor(g, xi * scale)
        r = (xf * scale).clone()
        dist.all_reduce(r)
        return a, g, r

    want = collectives(1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        collectives(2)                              # the warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = collectives(2)
    graph.replay()
    torch.cuda.synchronize()
    ok = [torch.equal(g, w * 2) for g, w in zip(got, want)]
    t0 = time.perf_counter()
    for _ in range(100):
        graph.replay()
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 10
    t0 = time.perf_counter()
    for _ in range(100):
        collectives(1)
    torch.cuda.synchronize()
    return dict(captured_right=ok, replay_ms=replay_ms,
                eager_three_ms=(time.perf_counter() - t0) * 10,
                nccl=".".join(map(str, torch.cuda.nccl.version())))


def gloo_rank(rank: int, world: int, init_method: str) -> dict:
    dev = init_process((("data", world),), "cuda:0", init_method, rank=rank, world=world,
                       backend="gloo", timeout=TIMEOUT)
    out = {}
    for dt in (torch.bfloat16, torch.float32, torch.int32, torch.uint8):
        x = (torch.arange(world * 4, device=dev) % 7 + rank).to(dt).view(world, 4)
        a = torch.empty_like(x)
        dist.all_to_all_single(a, x)
        g = torch.empty((world * 4,), dtype=dt, device=dev)
        dist.all_gather_into_tensor(g, x[0])
        r = torch.ones(4, device=dev).to(dt)
        dist.all_reduce(r)
        out[str(dt)] = bool(r.float().sum() == 4 * world and a.is_cuda and g.is_cuda)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("nccl_probe: no CUDA device", file=sys.stderr)
        return 1
    world = torch.cuda.device_count()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {world} x "
          f"{torch.cuda.get_device_name(0)}; all_gather_single: "
          f"{hasattr(dist, 'all_gather_single')}")
    for r, res in enumerate(spawn(nccl_rank, world, timeout=300)):
        print(f"nccl rank {r} of {world} (NCCL {res['nccl']}): captured all_to_all, "
              f"all_gather, all_reduce right {res['captured_right']}; a replay of the "
              f"three {res['replay_ms']:.4f} ms, eagerly {res['eager_three_ms']:.4f} ms")
    for r, res in enumerate(spawn(gloo_rank, 2, timeout=300)):
        print(f"gloo rank {r} of 2 on cuda:0: CUDA tensors taken and summed right {res}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
