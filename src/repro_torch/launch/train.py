"""Training launcher (port of ``src/repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b --smoke \\
      --steps 100 --global-batch 8 --seq 128 --ep 4 --device cpu --ckpt /tmp/ckpt

--smoke uses the reduced config (CPU-runnable); without it the published
config's ``train_4k`` preset. ``--ep N`` hosts N EP ranks in this process
(``LocalComm(N)``, the port's counterpart of the reference's ``--mesh``);
without it the MoE layers take the dense path. ``--device`` defaults to
the card. A checkpoint directory that holds a step resumes from it (the
preemption/restart path)."""
from __future__ import annotations

import argparse

from repro_torch.comm import LocalComm
from repro_torch.configs import get_config, get_smoke
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ep", type=int, default=None,
                    help="EP ranks hosted in this process (LocalComm)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch, "train_4k")
    t = Trainer(cfg, TrainerConfig(steps=args.steps, global_batch=args.global_batch,
                                   seq_len=args.seq, ckpt_dir=args.ckpt),
                comm=LocalComm(args.ep) if args.ep else None,
                opt_cfg=AdamWConfig(lr=args.lr, total_steps=args.steps,
                                    warmup_steps=max(args.steps // 20, 1)),
                device=args.device)
    t.run()
    return t


if __name__ == "__main__":
    main()
