#!/usr/bin/env python3
"""The training sub-phases of ``chip_smoke.py``'s one-rank-per-process phase
alone, on the card.

    python3 tools/dist_train_card.py gloo   # two gloo processes on card 0
    python3 tools/dist_train_card.py nccl   # one NCCL process a card

Builds the kernels and spawns the children, each of which runs
``chip_smoke.dist_train_phase``: ``dist_train_check`` (one DBRX-132B
``train_4k`` train step over ``DistComm`` against the same step over
``LocalComm`` on card 0) and, at four cards over NCCL,
``dist_train_full`` (the ``Trainer`` at EP 4, seq 4096, its peak probed at
1 layer first, one micro-batch traced), then the check in the
hierarchical (two pods of two), ``deepep`` and baseline layouts, the
hierarchical ``Trainer`` and DeepSeek-V3-671B's four-card ``Trainer``
(``ds_train_full``), printing the same lines as ``chip_smoke.py``. Exits non-zero
without a card or when a child fails.
"""
import datetime
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.comm import DistComm  # noqa: E402
from repro_torch.device import disable_tf32  # noqa: E402
from repro_torch.launch.mesh import init_process, spawn  # noqa: E402


def child(rank: int, world: int, init_method: str, backend: str, card: str) -> dict:
    sys.stdout.reconfigure(line_buffering=True)
    tmo = datetime.timedelta(seconds=C.dist_timeout(world))
    axes = (("data", world),)
    dev = init_process(axes, None if backend == "nccl" else "cuda:0", init_method, rank=rank,
                       world=world, backend=backend, timeout=tmo)
    disable_tf32()
    comm = DistComm(axes, timeout=tmo)
    hcomm = DistComm(C.DIST_HIER_AXES, timeout=tmo) if world == 4 else None
    out = dict(rank=rank, device=str(dev), backend=comm.backend)
    C.dist_train_phase(out, comm, hcomm, dev, rank, world, backend, time.perf_counter())
    C.dist_train_lines(out, C.dist_who(out, world), backend, card, backend == "gloo")
    return {}


def main(argv) -> int:
    if len(argv) != 1 or argv[0] not in ("gloo", "nccl"):
        print("usage: dist_train_card.py gloo|nccl", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("dist_train_card: no CUDA device", file=sys.stderr)
        return 1
    backend = argv[0]
    card = C.card_line()
    print(card, flush=True)
    C.build()
    world = 2 if backend == "gloo" else torch.cuda.device_count()
    t = time.perf_counter()
    spawn(child, world, backend, card, timeout=C.dist_timeout(world),
          workdir=C._build.BUILD_DIR.parent)
    print(f"{backend} at world {world}: {time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
