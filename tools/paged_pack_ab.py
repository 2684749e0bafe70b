#!/usr/bin/env python3
"""B1 ``dispatch_pack``, B2 ``recv_unpack``, B4 ``combine_gather_reduce``, B5
``quantize_fp8`` and ``dequantize_fp8``, B6 ``paged_decode_attention`` and B8
``combine_reduce``, two versions of the port on one card, at the shapes of
the port's paths and of ``chip_smoke.py``'s kernel phases.

    python3 tools/paged_pack_ab.py --old DIR [--new DIR]

DIR is the ``src`` directory of a checkout (``--new`` defaults to this
one's), for example an older commit unpacked with ``git archive`` into the
ignored ``build/``. Each version runs in its own process (its kernels built
from its own ``csrc/`` into its own ``build/``), in the order old, new, new,
old, on the same inputs made from fixed seeds. Each process checks its
kernels against its plain versions (B1, B2 and B5 bitwise, B5's quantize
also between two calls, B4 and B8 within 2e-2 in bf16 (B8 1e-5 in f32) and
bitwise between two calls, B6 within 1e-4), times each call on the card
with the profiler's device intervals (``chip_smoke.device_ms``) and the
host's time for one call of the small shapes (``host_ms``: wall time of
back-to-back calls, the card synchronised outside the loop), and prints one
JSON line. The parent prints every run and the mean of each version's two,
beside the bound of each shape (``chip_smoke.bound``) and the library
yardstick: ``torch.index_select`` over the rows padded with one zero row
(the padding made outside the timed call), which computes B1's and B2's
copy mode, ``embedding_bag`` for B4 where no row is a sentinel, and
``torch.bmm(w.unsqueeze(1), y)`` on f32 copies (made outside the timed
call) for B8. Needs one CUDA card.

The shapes: B6 at the continuous serve's (q [128, 48, 128] bf16, pools of
513 pages of 16, table [128, 4], 4 splits, lengths 0 to 64) and at 32k
tokens (table [128, 2048], mean length 16,650), the inputs of
``chip_smoke.paged_main_shape_phase`` and ``paged_kernel_phase``, and in
its shared-pool mode at DeepSeek-V3's widths (q [128, 128, 576], values
the rows' first 512 columns) at the continuous serve's shapes and at 32k,
as ``chip_smoke.ds_kernel_phase`` draws them; B1 in copy
mode at the decode dispatch send ([16, 6144] -> [8, 16, 6144]), the decode
combine send ([256, 6144] -> [8, 32, 6144]) and the HT combine send
([20480, 6144] -> [8, 2560, 6144]), and in fp8 mode at the HT dispatch
send ([4096, 6144] -> [8, 2560, 6144] + scales); B2 in copy mode at the
decode dispatch recv ([128, 6144] -> [2, 128, 6144]) and in fp8 mode at
the HT dispatch recv ([20480, 6144] fp8 + [20480, 48] scales -> [2, 10240,
6144] bf16); B4 at the decode combine recv (recv [256, 6144], rows [16, 4])
and at HT's (recv [20480, 6144], rows [4096, 4]); with the slot maps of the
DBRX-132B presets' plans (``decode_32k``, ``train_4k``) over 8 ranks, the
received buffers made by the plain pack and the all-to-all of
``chip_smoke.kernel_phase`` and ``ht_kernel_phase``; B5's quantize at x
[16, 6144] bf16 block 128 (a rank's decode tokens) and [4096, 6144] (a
rank's prefill tokens) in bf16 block 128, f32 block 128 and bf16 block 64,
each x with one all-zero block (and the decode x also without one), and
its dequantize at one rank's ``deepep`` recv ([2, 128, 6144] fp8 with
[2, 128, 48] scales, to bf16; random payload and scales, whose values do
not change the work); B8 at y [16, 4, 6144] bf16 and [4096, 4, 6144] bf16
and f32 with f32 weights, the shapes of ``chip_smoke.combine_reduce_phase``.
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
    """The group, every rank's handle and x, and the generator, for a
    seeded routing of ``tokens`` tokens per rank."""
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
    return group, hs, xs, gen


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
    import torch.nn.functional as F
    from repro_torch.comm import LocalComm
    from repro_torch.configs.dbrx_132b import full_config
    from repro_torch.kernels import combine_gather_reduce as cg
    from repro_torch.kernels import combine_reduce as cr
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dispatch_pack as dp
    from repro_torch.kernels import fp8
    from repro_torch.kernels import recv_unpack as ru
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

    def mla(label, rng, max_pages, lens, num_pages, iters):
        # the shared pool at DeepSeek-V3's absorbed-MLA widths
        Hq, dk, dv = 128, 576, 512
        q, kp, _, tbl, lt, _ = cs.paged_case(rng, cs.BATCH, Hq, 1, dk, dv, max_pages, lens,
                                             True, num_pages=num_pages)
        kw = dict(scale=192 ** -0.5, num_kv_splits=4, dv=dv)

        def fn():
            return da.paged_decode_attention(q, kp, None, tbl, lt, **kw)
        got = fn()
        want = ref.paged_decode_attention(q[:16], kp, None, tbl[:16], lt[:16], **kw)
        cs.check(torch.allclose(got[:16], want, rtol=cs.PAGED_TOL, atol=cs.PAGED_TOL),
                 f"B6 share_kv {label} off its plain version")
        cs.check(torch.equal(fn(), got), f"B6 share_kv {label}: two calls differ")
        nb = (int(lens.sum()) * dk * 2 + cs.nbytes(q) + cs.nbytes(lt)
              + int((-(-lens // cs.PAGE)).sum()) * 4 + cs.nbytes(got))
        out[f"B6 share_kv {label}"] = dict(
            ms=cs.device_ms(fn, iters),
            bound_ms=cs.bound(nb, 2 * int(lens.sum()) * Hq * (dk + dv), cs.BF16_OPS_S)[0])
        del q, kp, got
        torch.cuda.empty_cache()

    # DeepSeek-V3's shared pool at the continuous serve's shapes and at 32k
    # (chip_smoke.ds_kernel_phase)
    rng = np.random.default_rng(25)
    lens = rng.integers(1, 4 * cs.PAGE + 1, cs.BATCH)
    lens[:8] = 0
    lens[8:12] = np.arange(1, 5) * cs.PAGE
    mla("serve shapes", rng, 4, lens, 512, 50)
    lens = rng.integers(1, cs.DS_KV_PAGES * cs.PAGE + 1, cs.BATCH)
    lens[:3] = 0
    lens[3] = cs.DS_KV_PAGES * cs.PAGE
    mla("32k", rng, cs.DS_KV_PAGES, lens, None, 5)

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

    def unpack(label, recv, gmap, iters, scales=None):
        dt = None if scales is None else cfg.dtype

        def fn():
            return ru.recv_unpack(recv, gmap, scales, out_dtype=dt)
        got = fn()
        cs.check(torch.equal(got, ref.recv_unpack(recv, gmap, scales, dt)),
                 f"B2 {label} differs from its plain version")
        live = int((gmap < recv.shape[0]).sum())
        nb = cs.nbytes(recv, live) + cs.nbytes(got) + cs.nbytes(gmap)
        ops = 0
        if scales is not None:
            nb += cs.nbytes(scales, live)
            ops = live * recv.shape[1]
        rec = dict(ms=cs.device_ms(fn, iters), bound_ms=cs.bound(nb, ops, cs.F32_OPS_S)[0])
        if scales is None:
            rec["host_ms"] = host_ms(fn)
            rec["library_ms"] = cs.device_ms(cs.padded_gather(recv, gmap), iters)
        out[f"B2 {label}"] = rec

    def reduce(label, recv, rows, w, iters):
        def fn():
            return cg.combine_gather_reduce(recv, rows, w)
        got = fn()
        want = ref.combine_gather_reduce(recv, rows, w)
        cs.check(torch.allclose(got.float(), want.float(), rtol=cs.TOL, atol=cs.TOL),
                 f"B4 {label} off its plain version beyond 2e-2")
        cs.check(torch.equal(fn(), got), f"B4 {label}: two calls differ")
        valid = int((rows < recv.shape[0]).sum())
        nb = cs.nbytes(recv, valid) + cs.nbytes(rows) + cs.nbytes(w) + cs.nbytes(got)
        rec = dict(ms=cs.device_ms(fn, iters),
                   bound_ms=cs.bound(nb, 2 * valid * recv.shape[1], cs.F32_OPS_S)[0])
        if rows.shape[0] <= 256:
            rec["host_ms"] = host_ms(fn)
        if valid == rows.numel():      # no sentinel: embedding_bag is the same sum
            idx, wb = rows.long(), w.to(recv.dtype)
            rec["library_ms"] = cs.device_ms(lambda: F.embedding_bag(
                idx, recv, per_sample_weights=wb, mode="sum"), iters)
        out[f"B4 {label}"] = rec

    comm = LocalComm(RANKS)
    group, hs, xs, gen = _plan(cfg, cs.BATCH // RANKS, 1)
    pl, d, dt = hs[0].plan, cfg.d_model, cfg.dtype
    pack("copy, decode dispatch send", xs[0], pl.disp_send_gmap, 50)
    recv0 = comm.all_to_all([ref.dispatch_pack(x, h.plan.disp_send_gmap, None, dt)[0]
                             for x, h in zip(xs, hs)])[0].reshape(-1, d)
    unpack("copy, decode dispatch recv", recv0, pl.disp_recv_gmap, 50)
    L, A = group.local_experts, group.ll_expert_cap
    ys = [torch.randn((L * A, d), generator=gen, device="cuda").to(dt) for _ in range(RANKS)]
    pack("copy, decode combine send", ys[0], pl.comb_send_gmap, 50)
    crecv = comm.all_to_all([ref.dispatch_pack(y, h.plan.comb_send_gmap, None, dt)[0]
                             for y, h in zip(ys, hs)])[0].reshape(-1, d)
    reduce("decode combine recv", crecv, pl.comb_recv_rows, hs[0].topk_weights, 50)
    del recv0, ys, crecv
    pcfg = full_config("train_4k")
    group, hs, xs, gen = _plan(pcfg, cs.PF_SEQ, 12)
    pl, qb = hs[0].plan, group.cfg.quant_block
    pack("fp8, HT dispatch send", xs[0], pl.disp_send_gmap, 20, qb)
    packs = [ref.dispatch_pack(x, h.plan.disp_send_gmap, qb) for x, h in zip(xs, hs)]
    qrecv = comm.all_to_all([a for a, _ in packs])[0].reshape(-1, d)
    srecv = comm.all_to_all([b for _, b in packs])[0].reshape(qrecv.shape[0], -1)
    del packs
    unpack("fp8, HT dispatch recv", qrecv, pl.disp_recv_gmap, 20, srecv)
    del qrecv, srecv
    y = torch.randn((group.local_experts * group.ht_expert_cap, pcfg.d_model),
                    generator=gen, device="cuda").to(pcfg.dtype)
    pack("copy, HT combine send", y, pl.comb_send_gmap, 20)
    crecv = torch.randn((RANKS * group.ht_pair_cap, d), generator=gen,
                        device="cuda").to(pcfg.dtype)
    reduce("HT combine recv", crecv, pl.comb_recv_rows, hs[0].topk_weights, 20)
    del y, crecv

    def quant(label, x, block, iters):
        def fn():
            return fp8.quantize_fp8(x, block)
        q, s = fn()
        wq, ws = ref.quantize_fp8(x, block)
        cs.check(torch.equal(q.view(torch.uint8), wq.view(torch.uint8)) and torch.equal(s, ws),
                 f"B5 quantize {label} differs from its plain version")
        q2, s2 = fn()
        cs.check(torch.equal(q2.view(torch.uint8), q.view(torch.uint8)) and torch.equal(s2, s),
                 f"B5 quantize {label}: two calls differ")
        nb = cs.nbytes(x) + cs.nbytes(q) + cs.nbytes(s)
        rec = dict(ms=cs.device_ms(fn, iters),
                   bound_ms=cs.bound(nb, 2 * x.numel(), cs.F32_OPS_S)[0])
        if x.shape[0] <= 256:
            rec["host_ms"] = host_ms(fn)
        out[f"B5 quantize {label}"] = rec

    # each x has one all-zero block (scale 1), as chip_smoke's; the decode
    # shape also without it, where no dividend is zero
    for rows, xdt, block, zero in ((cs.BATCH // RANKS, dt, 128, True),
                                   (cs.BATCH // RANKS, dt, 128, False),
                                   (cs.PF_SEQ, dt, 128, True),
                                   (cs.PF_SEQ, torch.float32, 128, True),
                                   (cs.PF_SEQ, dt, 64, True)):
        x = (torch.randn((rows, d), generator=gen, device="cuda") * 30).to(xdt)
        if zero:
            x[1, :block] = 0.0
        name = str(xdt).removeprefix("torch.") + ("" if zero else ", no zero block")
        quant(f"[{rows}, {d}] {name} block {block}", x, block, 50 if rows <= 256 else 20)
        del x

    L = group.local_experts
    q = (torch.randn((L, cs.BATCH, d), generator=gen, device="cuda") * 100).clamp(
        -448, 448).to(torch.float8_e4m3fn)            # torch's cast makes NaN past 448
    sc = torch.rand((L, cs.BATCH, d // 128), generator=gen, device="cuda")

    def dequant():
        return fp8.dequantize_fp8(q, sc, dt)
    got = dequant()
    cs.check(torch.equal(got, ref.dequantize_fp8(q, sc, dt)),
             "B5 dequantize differs from its plain version")
    nb = cs.nbytes(q) + cs.nbytes(sc) + cs.nbytes(got)
    out["B5 dequantize, deepep recv"] = dict(
        ms=cs.device_ms(dequant, 50), bound_ms=cs.bound(nb, q.numel(), cs.F32_OPS_S)[0],
        host_ms=host_ms(dequant))
    del q, sc, got

    for rows, ydt, tol in ((cs.BATCH // RANKS, dt, cs.TOL), (cs.PF_SEQ, dt, cs.TOL),
                           (cs.PF_SEQ, torch.float32, 1e-5)):
        y = torch.randn((rows, 4, d), generator=gen, device="cuda").to(ydt)
        w = torch.rand((rows, 4), generator=gen, device="cuda")

        def fn():
            return cr.combine_reduce(y, w)
        got = fn()
        name = str(ydt).removeprefix("torch.")
        cs.check(torch.allclose(got.float(), ref.combine_reduce(y, w).float(), rtol=tol,
                                atol=tol), f"B8 [{rows}, 4, {d}] {name} off its plain version")
        cs.check(torch.equal(fn(), got), f"B8 [{rows}, 4, {d}] {name}: two calls differ")
        iters = 50 if rows <= 256 else 10
        nb = cs.nbytes(y) + cs.nbytes(w) + cs.nbytes(got)
        yf, wf = y.float(), w.unsqueeze(1)
        rec = dict(ms=cs.device_ms(fn, iters),
                   bound_ms=cs.bound(nb, 2 * y.numel(), cs.F32_OPS_S)[0],
                   library_ms=cs.device_ms(lambda: torch.bmm(wf, yf), iters))
        if rows <= 256:
            rec["host_ms"] = host_ms(fn)
        out[f"B8 [{rows}, 4, {d}] {name}"] = rec
        del y, w, yf, wf, got
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
