#!/usr/bin/env python3
"""B3 ``grouped_gemm``, two versions of the port on one card, at the shapes
of the port's paths, by ``chip_smoke.py``'s own yardstick.

    python3 tools/grouped_gemm_ab.py --old DIR [--new DIR] [--seg-max N,N,...]

DIR is the ``src`` directory of a checkout (``--new`` defaults to this
one's), for example an older commit unpacked with ``git archive`` into the
ignored ``build/``. Each version runs in its own process (its kernels built
from its own ``csrc/`` into its own ``build/``), in the order old, new, new,
old, on the same inputs made from fixed seeds. Each shape goes through
``chip_smoke.py``'s ``gemm_case``, taken from the script's source (its
imports would load this checkout's package, so it is not imported): the
checks against the plain version, the bound, and the device times of the
kernel, the plain version and ``torch.bmm`` are the script's. Each process
also records whether the first two experts' rows at L = 3 are bitwise
those at L = 2 (the slots a rank holds without EPLB and with 8 redundant
slots over 8 ranks). ``--seg-max`` times the newer version once for each
value of its ``SEG_MAX`` (the longest stream segment). The parent prints every
run and each version's mean of its two. Needs one CUDA card.

The shapes: DBRX-132B's decode gate [L, 128, 6144] @ [L, 6144, 10752] and
down [L, 128, 10752] @ [L, 10752, 6144] at L = 2 and 3, at the serve's
counts (30, 40, 97) and at full counts; DeepSeek-V3's decode gate and down
at L = 32 ([32, 128, 7168] @ [32, 7168, 2048] and back, 1 to 9 live rows an
expert); and DBRX's HT gate over [2, 10240] regions (counts 8272, 7995: the
compute schedule, which no version splits).
"""
from __future__ import annotations

import argparse
import ast
import json
import pathlib
import subprocess
import sys
import time
from collections import Counter

ROOT = pathlib.Path(__file__).resolve().parents[1]
# name -> (L, A, H, F, counts)
SHAPES = {
    "DBRX decode gate, L 2": (2, 128, 6144, 10752, [30, 40]),
    "DBRX decode gate, L 3": (3, 128, 6144, 10752, [30, 40, 97]),
    "DBRX decode down, L 2": (2, 128, 10752, 6144, [30, 40]),
    "DBRX decode down, L 3": (3, 128, 10752, 6144, [30, 40, 97]),
    "DBRX decode gate, L 2, full": (2, 128, 6144, 10752, [128, 128]),
    "DBRX decode gate, L 3, full": (3, 128, 6144, 10752, [128, 128, 128]),
    "DBRX decode down, L 2, full": (2, 128, 10752, 6144, [128, 128]),
    "DBRX decode down, L 3, full": (3, 128, 10752, 6144, [128, 128, 128]),
    "DeepSeek-V3 decode gate, L 32": (32, 128, 7168, 2048, None),
    "DeepSeek-V3 decode down, L 32": (32, 128, 2048, 7168, None),
    "DBRX HT gate, L 2": (2, 10240, 6144, 10752, [8272, 7995]),
}
# chip_smoke.py's definitions that gemm_case reaches
SMOKE_NAMES = {"HBM_BYTES_S", "BF16_OPS_S", "SPIN_CYCLES_S", "LEAD_SPINS", "TOL", "GEMM_REL",
               "HEAD_RANGE", "MLA_RANGE", "RANGES", "check", "is_range", "device_intervals",
               "busy_us", "queued_ms", "device_ms", "bound", "nbytes", "flash_errors",
               "gemm_case"}


def smoke(gg_mod, ref) -> dict:
    """chip_smoke.py's definitions of SMOKE_NAMES, executed from its source
    with ``gg_mod`` and ``ref`` the version under test's modules."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())

    def wanted(node) -> bool:
        if isinstance(node, ast.FunctionDef):
            return node.name in SMOKE_NAMES
        return isinstance(node, ast.Assign) and any(
            isinstance(n, ast.Name) and n.id in SMOKE_NAMES
            for t in node.targets for n in ast.walk(t))

    body = [n for n in tree.body if wanted(n)]
    ns = {"torch": torch, "profile": profile, "ProfilerActivity": ProfilerActivity,
          "Counter": Counter, "time": time, "gg_mod": gg_mod, "ref": ref}
    exec(compile(ast.Module(body=body, type_ignores=[]), "chip_smoke.py", "exec"), ns)
    missing = SMOKE_NAMES - ns.keys()
    if missing:
        raise RuntimeError(f"chip_smoke.py no longer defines {sorted(missing)}")
    return ns


def measure(src: str, seg_max: list[int]) -> dict:
    """Every measurement of one version (the package under ``src``)."""
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    import torch
    import repro_torch
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import ref

    cs = smoke(gg, ref)
    out = {"package": str(pathlib.Path(repro_torch.__file__).resolve().parent)}
    gen = torch.Generator(device="cuda").manual_seed(31)
    made = {}
    for key in {(H, F, A, 32 if L == 32 else 3) for L, A, H, F, _ in SHAPES.values()}:
        H, F, A, n = key
        made[key] = ((torch.randn((n, A, H), generator=gen, device="cuda") * 0.5)
                     .to(torch.bfloat16),
                     (torch.randn((n, H, F), generator=gen, device="cuda") * H ** -0.5)
                     .to(torch.bfloat16))
    for value in seg_max or [None]:
        if value is not None:
            gg.SEG_MAX = value
            gg.plan.cache_clear()
        runs, prev2 = {}, {}
        for name, (L, A, H, F, counts) in SHAPES.items():
            x, w = (t[:L].contiguous() for t in made[(H, F, A, 32 if L == 32 else 3)])
            if counts is None:
                counts = [1 + (7 * i) % 9 for i in range(L)]
            c = torch.tensor(counts, dtype=torch.int32, device="cuda")
            err, ms, plain_ms, bnd, bmm_ms = cs["gemm_case"](
                name, x, w, c, 20 if A <= 128 else 3, 5 if A <= 128 else 1)
            p = gg.plan(L, A, H, F)
            runs[name] = dict(ms=ms, plain_ms=plain_ms, bmm_ms=bmm_ms, bound_ms=bnd[0],
                              max_abs_err=err, seg=getattr(p, "seg", 0))
            if L == 2:
                prev2[(H, F, tuple(counts))] = gg.grouped_gemm(x, w, c)
            elif L == 3:
                two = prev2[(H, F, tuple(counts[:2]))]
                runs[name]["rows_as_L2"] = bool(torch.equal(gg.grouped_gemm(x, w, c)[:2], two))
            del x, w
        out["default" if value is None else f"SEG_MAX {value}"] = runs
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="src directory of the older version")
    ap.add_argument("--new", default=str(ROOT / "src"), help="src directory of the newer one")
    ap.add_argument("--seg-max", default="", help="SEG_MAX values to time the newer one at")
    ap.add_argument("--measure", help=argparse.SUPPRESS)     # the child's entry
    args = ap.parse_args()
    seg_max = [int(v) for v in args.seg_max.split(",") if v]
    if args.measure:
        print("AB " + json.dumps(measure(args.measure, seg_max)), flush=True)
        return 0
    if not args.old:
        ap.error("--old is required")
    import torch
    if not torch.cuda.is_available():
        print("grouped_gemm_ab: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    runs = []
    for label, src in (("old", args.old), ("new", args.new), ("new", args.new),
                       ("old", args.old)):
        cmd = [sys.executable, __file__, "--measure", src]
        if label == "new" and seg_max:
            cmd += ["--seg-max", args.seg_max]
        p = subprocess.run(cmd, capture_output=True, text=True)
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode != 0 or not line:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            print(f"grouped_gemm_ab: the {label} run failed", file=sys.stderr)
            return 1
        runs.append((label, json.loads(line[0][3:])))
        print(f"{label} run ({runs[-1][1]['package']}): "
              + json.dumps({k: v for k, v in runs[-1][1].items() if k != "package"}))
    old = [r["default"] for lab, r in runs if lab == "old"]
    variants = [k for k in runs[1][1] if k != "package"]
    print(f"means of two runs each, ms of device time, {card}:")
    for key in SHAPES:
        om = sum(r[key]["ms"] for r in old) / 2
        parts = []
        for v in variants:
            new = [r[v][key] for lab, r in runs if lab == "new"]
            nm = sum(r["ms"] for r in new) / 2
            same = f", rows at L 3 as at L 2: {new[0]['rows_as_L2']}" \
                if "rows_as_L2" in new[0] else ""
            parts.append(f"{v} (seg {new[0]['seg']}) {nm:.5f} (x{nm / om:.3f}{same})")
        same = f", rows at L 3 as at L 2: {old[0][key]['rows_as_L2']}" \
            if "rows_as_L2" in old[0][key] else ""
        print(f"  {key}: old {om:.5f}{same}; " + "; ".join(parts)
              + f"; bound {old[0][key]['bound_ms']:.5f}, torch.bmm {old[0][key]['bmm_ms']:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
