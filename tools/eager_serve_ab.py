#!/usr/bin/env python3
"""The fixed-batch server's ITL, two versions of the port on one card.

    python3 tools/eager_serve_ab.py --old DIR [--new DIR] [--serves N]

DIR is the ``src`` directory of a checkout (``--new`` defaults to this
one's), for example an older commit unpacked with ``git archive`` into the
ignored ``build/``. Each version runs in its own process (its kernels built
from its own ``csrc/`` into its own ``build/``), in the order old, new, new,
old. A process serves ``chip_smoke.py``'s fixed-batch cell: DBRX-132B
``decode_32k`` at full width cut to 4 layers, random weights from seed 0,
8 EP ranks on the card, 128 prompts of 8 tokens and 16 generated, in the
LL ``nccl_ep``, LL ``deepep`` + fp8 and baseline layouts. Each layout is
served once through the captured step and ``--serves`` times through the
uncompiled step (the eager path, whose host time every layer's Python
reaches), every stream bitwise equal to the captured serve's. The parent
prints every run and each version's mean ITL by layout and mode. Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYOUTS = {"nccl_ep": {}, "deepep_fp8": dict(ll_layout="deepep", quantize_dispatch=True),
           "baseline": dict(ep_mode="baseline")}
RANKS, BATCH, PROMPT, GEN, LAYERS = 8, 128, 8, 16, 4


def child(serves: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs.dbrx_132b import full_config
    from repro_torch.runtime.server import DecodeServer
    from repro_torch.weights import init_params

    cfg = dataclasses.replace(full_config("decode_32k"), num_layers=LAYERS)
    params = init_params(cfg, 0, "cuda")
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2))
    out = {}
    for path, kw in LAYOUTS.items():
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))
        runs, want = {"captured": [], "eager": []}, None
        for mode in ["captured"] + ["eager"] * serves:
            srv = DecodeServer(c, BATCH, PROMPT + GEN + 2, ep_size=RANKS, params=params)
            if mode == "eager":
                srv._serve_step = srv._step_factory()
            m = srv.serve(prompts, GEN)
            if want is None:
                want = srv.last_tokens
            if not np.array_equal(srv.last_tokens, want):
                raise RuntimeError(f"{path}: the {mode} serve's tokens differ")
            runs[mode].append(m.itl_mean_s)
            srv.close()
            del srv
            torch.cuda.empty_cache()
        out[path] = runs
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old")
    ap.add_argument("--new", default=str(ROOT / "src"))
    ap.add_argument("--serves", type=int, default=3)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.serves)))
        return 0
    if not args.old:
        ap.error("--old DIR is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    results = {"old": [], "new": []}
    for label in ("old", "new", "new", "old"):
        src = str(pathlib.Path(getattr(args, label)).resolve())
        proc = subprocess.run([sys.executable, __file__, "--child", "--serves", str(args.serves)],
                              capture_output=True, text=True, cwd=str(pathlib.Path(src).parent),
                              env={**os.environ, "PYTHONPATH": src})
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        results[label].append(run)
        print(f"{label} ({src}): {json.dumps(run)}")
    for label, runs in results.items():
        for path in LAYOUTS:
            for mode in ("captured", "eager"):
                vals = [v for r in runs for v in r[path][mode]]
                print(f"{label} {path} {mode}: ITL mean {sum(vals) / len(vals):.5f} s over "
                      f"{len(vals)} serves")
    return 0


if __name__ == "__main__":
    sys.exit(main())
