#!/usr/bin/env python3
"""B6 ``paged_decode_attention`` and B1 ``dispatch_pack``, two versions of
the port on one card, at the shapes of the port's paths.

    python3 tools/paged_pack_ab.py --old DIR [--new DIR]

DIR is the ``src`` directory of a checkout (``--new`` defaults to this
one's), for example an older commit unpacked with ``git archive`` into the
ignored ``build/``. Each version runs in its own process (its kernels built
from its own ``csrc/`` into its own ``build/``), in the order old, new, new,
old, on the same inputs made from fixed seeds. Each process checks its
kernels against its plain versions (B1 bitwise, B6 within 1e-4), times each
call on the card with the profiler's device intervals (``chip_smoke.device_ms``)
and the host's time for one call of the small shapes (``host_ms``: wall time
of back-to-back calls, the card synchronised outside the loop), and prints
one JSON line. The parent prints every run and the mean of each
version's two, beside the bound of each shape (``chip_smoke.bound``) and the
library yardstick: ``torch.index_select`` over the token rows padded with
one zero row (the padding made outside the timed call), which computes B1's
copy mode. Needs one CUDA card.

The shapes: B6 at the continuous serve's (q [128, 48, 128] bf16, pools of
513 pages of 16, table [128, 4], 4 splits, lengths 0 to 64) and at 32k
tokens (table [128, 2048], mean length 16,650), the inputs of
``chip_smoke.paged_main_shape_phase`` and ``paged_kernel_phase``; B1 in copy
mode at the decode dispatch send ([16, 6144] -> [8, 16, 6144]), the decode
combine send ([256, 6144] -> [8, 32, 6144]) and the HT combine send
([20480, 6144] -> [8, 2560, 6144]), and in fp8 mode at the HT dispatch
send ([4096, 6144] -> [8, 2560, 6144] + scales), with the slot maps of the
DBRX-132B presets' plans (``decode_32k``, ``train_4k``) over 8 ranks.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 8


def _plan(cfg, tokens: int, seed: int):
    """Rank 0's plan and x, and its group, for a seeded routing of
    ``tokens`` tokens per rank."""
    import torch
    from repro_torch.comm import LocalComm
    from repro_torch.core import ep_create_handle, route
    from repro_torch.models.moe import ep_group, router_config
    d = cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    router = torch.randn((d, cfg.moe.num_experts), generator=gen, device="cuda") * d ** -0.5
    group = ep_group(cfg, LocalComm(RANKS), tokens)
    xs = [torch.randn((tokens, d), generator=gen, device="cuda").to(cfg.dtype)
          for _ in range(RANKS)]
    rs = [route(x.float() @ router, router_config(cfg.moe)) for x in xs]
    hs = ep_create_handle(group, [r.topk_idx for r in rs], [r.topk_weights for r in rs])
    return group, hs[0].plan, xs[0], gen


def host_ms(fn, iters: int = 200, reps: int = 7) -> float:
    """The host's time for one call: the median over ``reps`` of the mean
    wall time of ``iters`` calls, the card left to catch up outside the
    timed loop (every call here takes the card less time than the host)."""
    import time
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) / iters * 1e3)
        torch.cuda.synchronize()
    return float(np.median(times))


def measure(src: str) -> dict:
    """Every measurement of one version (the package under ``src``)."""
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    import numpy as np
    import torch
    import repro_torch
    # chip_smoke's helpers; its own imports of repro_torch resolve to the
    # package imported above
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs.dbrx_132b import full_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dispatch_pack as dp
    from repro_torch.kernels import ref

    out = {"package": str(pathlib.Path(repro_torch.__file__).resolve().parent)}
    cfg = full_config("decode_32k")
    a = cfg.attn
    Hq, Hkv, d = cfg.padded_heads(), a.n_kv, a.head_dim

    def paged(label, rng, max_pages, lens, num_pages, iters, chunk):
        S = 4
        q, kp, vp, tbl, lt, _ = cs.paged_case(rng, cs.BATCH, Hq, Hkv, d, d, max_pages,
                                              lens, False, num_pages=num_pages)
        kw = dict(scale=d ** -0.5, num_kv_splits=S)

        def fn():
            return da.paged_decode_attention(q, kp, vp, tbl, lt, **kw)
        got = fn()
        c = slice(0, chunk)
        want = ref.paged_decode_attention(q[c], kp, vp, tbl[c], lt[c], **kw)
        cs.check(torch.allclose(got[c], want, rtol=cs.PAGED_TOL, atol=cs.PAGED_TOL),
                 f"B6 {label} off its plain version")
        cs.check(torch.equal(fn(), got), f"B6 {label}: two calls differ")
        bnd, _ = cs.paged_bound(lens, q, lt, got, Hkv, d, d, kp.element_size())
        out[f"B6 {label}"] = dict(ms=cs.device_ms(fn, iters), bound_ms=bnd[0])
        if iters >= 50:
            out[f"B6 {label}"]["host_ms"] = host_ms(fn)
        del q, kp, vp, got
        torch.cuda.empty_cache()

    # the continuous serve's shapes (chip_smoke.paged_main_shape_phase)
    rng = np.random.default_rng(7)
    mp = 4
    lens = rng.integers(1, mp * cs.PAGE + 1, cs.BATCH)
    lens[:8] = 0
    lens[8:8 + mp] = np.arange(1, mp + 1) * cs.PAGE
    lens[8 + mp:16 + mp] = rng.integers(0, mp, 8) * cs.PAGE + rng.integers(1, cs.PAGE, 8)
    paged("main path", rng, mp, lens, 512, 50, cs.BATCH)
    # 32k tokens (chip_smoke.paged_kernel_phase)
    rng = np.random.default_rng(6)
    mp = cs.KV_PAGES
    lens = rng.integers(1, mp * cs.PAGE + 1, cs.BATCH)
    lens[:3] = 0
    lens[3] = mp * cs.PAGE
    lens[4:8] = rng.integers(1, mp, 4) * cs.PAGE
    lens[8:12] = rng.integers(1, mp - 1, 4) * cs.PAGE + rng.integers(1, cs.PAGE, 4)
    paged("32k", rng, mp, lens, None, 10, 16)

    def pack(label, x, gmap, iters, quant=None):
        def fn():
            return dp.dispatch_pack(x, gmap, quant_block=quant,
                                    out_dtype=None if quant else x.dtype)
        got, sc = fn()
        want, wsc = ref.dispatch_pack(x, gmap, quant, None if quant else x.dtype)
        same = (torch.equal(got.view(torch.uint8), want.view(torch.uint8))
                and (sc is None or torch.equal(sc, wsc)))
        cs.check(same, f"B1 {label} differs from its plain version")
        live = int((gmap < x.shape[0]).sum())
        nb = cs.nbytes(x, live) + cs.nbytes(got) + cs.nbytes(gmap)
        ops = 0
        if quant:
            nb += cs.nbytes(sc)
            ops = 3 * live * x.shape[1]
        rec = dict(ms=cs.device_ms(fn, iters), bound_ms=cs.bound(nb, ops, cs.F32_OPS_S)[0])
        if x.shape[0] <= 256:
            rec["host_ms"] = host_ms(fn)
        if quant is None:
            xp = torch.cat([x, torch.zeros_like(x[:1])])
            idx = gmap.flatten().long()
            rec["library_ms"] = cs.device_ms(lambda: torch.index_select(xp, 0, idx), iters)
        out[f"B1 {label}"] = rec

    group, pl, x0, gen = _plan(cfg, cs.BATCH // RANKS, 1)
    pack("copy, decode dispatch send", x0, pl.disp_send_gmap, 50)
    L, A = group.local_experts, group.ll_expert_cap
    y = torch.randn((L * A, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype)
    pack("copy, decode combine send", y, pl.comb_send_gmap, 50)
    pcfg = full_config("train_4k")
    group, pl, x0, gen = _plan(pcfg, cs.PF_SEQ, 12)
    pack("fp8, HT dispatch send", x0, pl.disp_send_gmap, 20, group.cfg.quant_block)
    y = torch.randn((group.local_experts * group.ht_expert_cap, pcfg.d_model),
                    generator=gen, device="cuda").to(pcfg.dtype)
    pack("copy, HT combine send", y, pl.comb_send_gmap, 20)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="src directory of the older version")
    ap.add_argument("--new", default=str(ROOT / "src"), help="src directory of the newer one")
    ap.add_argument("--measure", help=argparse.SUPPRESS)     # the child's entry
    args = ap.parse_args()
    if args.measure:
        print("AB " + json.dumps(measure(args.measure)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("paged_pack_ab: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    runs = []
    for label, src in (("old", args.old), ("new", args.new), ("new", args.new),
                       ("old", args.old)):
        p = subprocess.run([sys.executable, __file__, "--measure", src],
                           capture_output=True, text=True)
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode != 0 or not line:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            print(f"paged_pack_ab: the {label} run failed", file=sys.stderr)
            return 1
        runs.append((label, json.loads(line[0][3:])))
        print(f"{label} run ({runs[-1][1]['package']}): "
              + json.dumps({k: v for k, v in runs[-1][1].items() if k != "package"}))
    print(f"means of two runs each, ms (device time; host time of one call where "
          f"given), {card}:")
    for key in (k for k in runs[0][1] if k != "package"):
        row = {}
        for label in ("old", "new"):
            recs = [r[key] for lab, r in runs if lab == label]
            row[label] = {m: sum(r[m] for r in recs) / len(recs) for m in recs[0]}
        o, n = row["old"], row["new"]
        extra = "".join(f", {m} {o[m]:.5f} -> {n[m]:.5f}" for m in ("host_ms", "library_ms")
                        if m in n)
        print(f"  {key}: {o['ms']:.5f} -> {n['ms']:.5f} (x{o['ms'] / n['ms']:.2f}), "
              f"bound {n['bound_ms']:.5f}, {n['ms'] / n['bound_ms']:.2f}x the bound{extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
