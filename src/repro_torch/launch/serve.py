"""Serving launcher: batched greedy decode through the LL EP path, one EP
rank per process (port of ``src/repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b --smoke \\
      --batch 8 --prompt-len 16 --gen 32 --mesh 4 --device cpu

``--mesh`` spawns one process per mesh rank (``launch/mesh.py spawn``), each
serving its rows of the batch over a ``DistComm`` (gloo on the CPU, NCCL on
the cards, one card per rank: NCCL refuses two ranks on one card). Under
``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) the process is one rank of
that mesh and spawns nothing:

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch dbrx-132b \\
      --smoke --mesh 4

Without ``--mesh`` one process serves the whole batch, the MoE layers on
the dense path. Rank 0 prints the reference's metric line, on its own clock.
``--arch`` takes every id of ``repro_torch.configs.ARCH_IDS``: the ``lm``
configs, ``gemma3-27b`` and ``phi-3-vision-4.2b`` (the new families are not
held over a ``DistComm`` yet, ROADMAP A12a-train).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.comm import DistComm
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch.mesh import init_process, parse_mesh, spawn, world_size
from repro_torch.runtime.server import DecodeServer


def _config(args):
    return get_smoke(args.arch) if args.smoke else get_config(args.arch, "decode_32k")


def _prompts(args, vocab: int) -> np.ndarray:
    return np.random.RandomState(0).randint(
        0, vocab, (args.batch, args.prompt_len)).astype(np.int32)


def _line(m) -> str:
    return (f"output_tok_s={m.output_tok_s:.1f} ttft_ms={m.ttft_s*1e3:.1f} "
            f"itl_mean_ms={m.itl_mean_s*1e3:.2f} itl_p99_ms={m.itl_p99_s*1e3:.2f}")


def serve_rank(rank: int, world: int, init_method: str | None, args) -> dict:
    """One rank of the mesh: its process group, its DistComm over the
    config's EP axes, its server; returns its metrics and the global token
    stream."""
    axes = parse_mesh(args.mesh)
    cfg = _config(args)
    dev = init_process(axes, args.device, init_method, rank=rank, world=world)
    if dev.type == "cpu":
        torch.set_num_threads(1)          # as torchrun sets OMP_NUM_THREADS
    comm = DistComm(axes, ep_axes=cfg.moe.ep_axis if cfg.moe else None)
    srv = DecodeServer(cfg, batch=args.batch, max_len=args.prompt_len + args.gen + 8,
                       comm=comm, device=dev)
    m = srv.serve(_prompts(args, cfg.vocab), gen_steps=args.gen)
    if rank == 0:
        print(_line(m), flush=True)
    return dict(metrics=m.as_dict(), tokens=srv.last_tokens)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mesh", default=None, help="e.g. 4 -> (data,), 2x2 -> (data, model)")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device; default cuda:{local rank}")
    return ap


def main(argv=None) -> list | dict:
    """Serve once; returns the metrics and tokens (of every rank, with a
    spawned mesh)."""
    args = parser().parse_args(argv)
    axes = parse_mesh(args.mesh)
    if axes is None:
        cfg = _config(args)
        srv = DecodeServer(cfg, batch=args.batch, max_len=args.prompt_len + args.gen + 8,
                           device=args.device)
        m = srv.serve(_prompts(args, cfg.vocab), gen_steps=args.gen)
        print(_line(m), flush=True)
        return dict(metrics=m.as_dict(), tokens=srv.last_tokens)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:       # under torchrun
        return serve_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), None, args)
    return spawn(serve_rank, world_size(axes), args)


if __name__ == "__main__":
    main()
