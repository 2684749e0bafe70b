#!/usr/bin/env python3
"""DeepSeek-V3's four-card sub-phases of ``chip_smoke.py`` alone, with the
first step's routing of the continuous serve recorded.

    python3 tools/ds_dist_routes.py        # on a machine with four cards

Spawns one NCCL rank a card and runs ``chip_smoke.ds_dist_phase`` (the
fixed-batch serve, the forward with MTP, the deep serve, the continuous
serve), each rank printing its lines. While the continuous serve's step-0
logits are computed, over ``DistComm`` in every rank and over
``LocalComm(4)`` in rank 0's reference, every ``route`` call records the
experts it picked for the last row of its tokens (an idle row at step 0)
with their scores (sigmoid plus the selection bias) and the twelve best
scores; each rank prints them on stderr as ``ROUTE`` lines. The
first-step-logits check is reported there instead of raised, so the run
ends with every line printed. Exits non-zero without four cards.
"""
import datetime
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

RECORDS, RECORDING = [], [False]
_route = cs.moe_mod.route


def recording_route(logits, rcfg, bias=None):
    r = _route(logits, rcfg, bias)
    if RECORDING[0]:
        score = torch.sigmoid(logits[-1].float())
        if bias is not None:
            score = score + bias.float()
        top = torch.topk(score, 12)
        RECORDS.append(dict(
            picked=[(int(e), round(float(score[e]), 7)) for e in sorted(r.topk_idx[-1].tolist())],
            best12=[(int(e), round(float(v), 7)) for v, e in zip(top.values, top.indices)]))
    return r


_step0 = cs.continuous_step0_logits


def recorded_step0(cfg, params, comm, dev, reqs, table):
    RECORDS.clear()
    RECORDING[0] = True
    out = _step0(cfg, params, comm, dev, reqs, table)
    RECORDING[0] = False
    print(f"ROUTE {type(comm).__name__} rank {torch.distributed.get_rank()}: "
          f"{json.dumps(RECORDS)}", file=sys.stderr, flush=True)
    return out


_check = cs.check


def reporting_check(ok, msg):
    if not ok and msg.startswith("the DistComm continuous server's first-step logits"):
        print(f"check failed (reported): {msg}", file=sys.stderr, flush=True)
        return
    _check(ok, msg)


cs.moe_mod.route = recording_route
cs.continuous_step0_logits = recorded_step0
cs.check = reporting_check


def child(rank: int, world: int, init_method: str, card: str) -> dict:
    sys.stdout.reconfigure(line_buffering=True)
    t0 = time.perf_counter()
    axes = (("data", world),)
    tmo = datetime.timedelta(seconds=cs.DS_DIST_TIMEOUT_S)
    dev = cs.init_process(axes, None, init_method, rank=rank, world=world, backend="nccl",
                          timeout=tmo)
    cs.disable_tf32()
    comm = cs.DistComm(axes, timeout=tmo)
    out = cs.ds_dist_phase(comm, dev, rank, f"rank {rank} of {world}, nccl on {dev}", "routes",
                           card)
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < cs.DS_DIST_WORLD:
        print(f"ds_dist_routes: needs {cs.DS_DIST_WORLD} cards", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    cs.build()
    t = time.perf_counter()
    res = cs.spawn(child, cs.DS_DIST_WORLD, card, timeout=cs.DS_DIST_TIMEOUT_S,
                   workdir=cs._build.BUILD_DIR.parent)
    logs = [r["continuous"]["admissions"] for r in res]
    print(f"every rank's continuous admission log equal: {all(x == logs[0] for x in logs)}; "
          f"DeepSeek-V3's sub-phases {max(r['seconds'] for r in res):.1f} s a rank, "
          f"{time.perf_counter() - t:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
