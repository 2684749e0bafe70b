"""Training launcher (port of ``src/repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b --smoke \\
      --steps 100 --global-batch 8 --seq 128 --ep 4 --device cpu --ckpt /tmp/ckpt

--smoke uses the reduced config (CPU-runnable); without it the published
config's ``train_4k`` preset. ``--ep N`` hosts N EP ranks in this process
(``LocalComm(N)``); without it or ``--mesh`` the MoE layers take the dense
path. ``--device`` defaults to the card. A checkpoint directory that holds
a step resumes from it (the preemption/restart path).

``--mesh`` trains with one EP rank per process, as the reference's
``--mesh`` does over a device mesh: ``4`` is (data 4), ``2x2`` is (data 2,
model 2), where ``model`` carries expert tensor parallelism unless the
config's EP axes name it (then it splits the sequence inside the MoE
layers). It spawns one process per mesh rank (``launch/mesh.py spawn``),
each stepping its rows of every batch over a ``DistComm`` (gloo on the CPU,
NCCL on the cards, one card per rank); under ``torchrun`` (``RANK`` and
``WORLD_SIZE`` set) the process is one rank of that mesh and spawns
nothing:

  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b --smoke \\
      --steps 20 --global-batch 8 --seq 32 --mesh 4 --device cpu
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch dbrx-132b \\
      --smoke --mesh 4

Rank 0 prints the reference's metric lines. A checkpoint over a mesh is
refused (ROADMAP A10d). ``--arch`` takes every id of
``repro_torch.configs.ARCH_IDS``: the ``lm`` configs, ``gemma3-27b`` and
``phi-3-vision-4.2b`` (the new families are not held over a ``DistComm``
yet, ROADMAP A12a-train).
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.comm import DistComm, LocalComm
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch.mesh import init_process, parse_mesh, spawn, world_size
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ep", type=int, default=None,
                    help="EP ranks hosted in this process (LocalComm)")
    ap.add_argument("--mesh", default=None,
                    help="one EP rank per process: 4 -> (data,), 2x2 -> (data, model)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device; default the card (cuda:{local rank})")
    return ap


def _config(args):
    return get_smoke(args.arch) if args.smoke else get_config(args.arch, "train_4k")


def _trainer(args, cfg, comm, device) -> Trainer:
    return Trainer(cfg, TrainerConfig(steps=args.steps, global_batch=args.global_batch,
                                      seq_len=args.seq, ckpt_dir=args.ckpt),
                   comm=comm,
                   opt_cfg=AdamWConfig(lr=args.lr, total_steps=args.steps,
                                       warmup_steps=max(args.steps // 20, 1)),
                   device=device)


def train_rank(rank: int, world: int, init_method: str | None, args) -> dict:
    """One rank of the mesh: its process group, its DistComm over the
    config's EP axes, its Trainer; returns its logged metrics."""
    axes = parse_mesh(args.mesh)
    dev = init_process(axes, args.device, init_method, rank=rank, world=world)
    if dev.type == "cpu":
        torch.set_num_threads(1)          # as torchrun sets OMP_NUM_THREADS
    cfg = _config(args)
    comm = DistComm(axes, ep_axes=cfg.moe.ep_axis if cfg.moe else None)
    t = _trainer(args, cfg, comm, dev)
    t.run()
    return dict(metrics=t.metrics_log, step=t.data.step)


def main(argv=None):
    """Train once; returns the Trainer, or with ``--mesh`` each rank's
    logged metrics (a spawned mesh) or this rank's (under torchrun)."""
    args = parser().parse_args(argv)
    axes = parse_mesh(args.mesh)
    if axes is None:
        t = _trainer(args, _config(args), LocalComm(args.ep) if args.ep else None,
                     args.device)
        t.run()
        return t
    if args.ep:
        raise ValueError("--ep hosts EP ranks in one process, --mesh one per process: "
                         "give one of them")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:       # under torchrun
        return train_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), None, args)
    return spawn(train_rank, world_size(axes), args)


if __name__ == "__main__":
    main()
