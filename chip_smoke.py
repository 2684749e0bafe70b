#!/usr/bin/env python3
"""Smoke run of the PyTorch/Hopper port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Builds the four hand-written EP kernels from ``src/repro_torch/csrc`` with
   nvcc for sm_90a (at first use, into ``build/repro_torch/``).
2. Serves DBRX-132B at full width, its 40 layers cut to 4 to fit one card,
   through ``DecodeServer`` over 8 EP ranks hosted on the card: batch 128,
   prompt 8, 16 generated tokens. Each kernel's launch count over that run
   must equal the count the path implies. Then traces one more decode step
   with the profiler: the card's busy share and its time by kernel.
3. Holds each kernel against its plain PyTorch version on the inputs one EP
   rank gets in one MoE layer of that slice (8 ranks, 16 tokens each):
   bitwise for the two gathers, in copy and in fp8 mode; within 2e-2 for
   the bf16 GEMM and reduce. Times on the card the kernel, the plain version
   and, where one PyTorch call computes the same function, that call.
4. Holds each MoE layer's EP output against the dense fallback on the same
   input (every capacity is zero-drop here): relative error <= 2e-2. Reports
   the greedy-token agreement of the EP server with a dense one.

Exits non-zero, printing no result, without a CUDA device or without the
repository beside it. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.comm import LocalComm  # noqa: E402
from repro_torch.configs.dbrx_132b import full_config  # noqa: E402
from repro_torch.core import ep_create_handle, route  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import combine_gather_reduce as cg_mod  # noqa: E402
from repro_torch.kernels import dispatch_pack as dp_mod  # noqa: E402
from repro_torch.kernels import grouped_gemm as gg_mod  # noqa: E402
from repro_torch.kernels import recv_unpack as ru_mod  # noqa: E402
from repro_torch.models.moe import (_moe_dense_fallback, ep_group,  # noqa: E402
                                    moe_block, router_config)
from repro_torch.runtime.server import DecodeServer  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12            # f32 outside the tensor cores

RANKS, BATCH, PROMPT, GEN, LAYERS = 8, 128, 8, 16, 4
TOL = 2e-2                   # bf16 tolerance (tests/test_kernels.py tol())

# name -> (wrapper module, source, TPU kernel it replaces, launches per MoE
# layer per hosted rank in one decode step)
KERNELS = {
    "dispatch_pack": (dp_mod, "src/repro_torch/csrc/dispatch_pack.cu",
                      "src/repro/kernels/dispatch_pack.py:42", 2),
    "recv_unpack": (ru_mod, "src/repro_torch/csrc/recv_unpack.cu",
                    "src/repro/kernels/recv_unpack.py:43", 1),
    "grouped_gemm": (gg_mod, "src/repro_torch/csrc/grouped_gemm.cu",
                     "src/repro/kernels/grouped_gemm.py:53", 3),
    "combine_gather_reduce": (cg_mod, "src/repro_torch/csrc/combine_gather_reduce.cu",
                              "src/repro/kernels/combine_gather_reduce.py:44", 1),
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def call_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls
    (CUDA events, after one warm-up call). For a small kernel this is the
    host's launch rate, not the kernel's time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def device_intervals(prof) -> list[tuple[float, float, str]]:
    """(start_us, end_us, name) of every kernel, copy and set the profiler
    saw on the card, in start order."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def busy_us(iv) -> float:
    """Time the card spent running something: the union of the intervals."""
    total, reach = 0.0, float("-inf")
    for s, e, _ in iv:
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def device_ms(fn, iters: int) -> float:
    """Mean device time of one call: the card's busy time over ``iters``
    calls, from the profiler's CUDA trace, so host launch cost is left out."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    iv = device_intervals(prof)
    check(len(iv) >= iters, f"the profiler saw {len(iv)} device events for {iters} calls")
    return busy_us(iv) / iters / 1e3


def bound(nbytes: int, ops: int, ops_rate: float) -> tuple[float, str]:
    """Least time in ms for the work: the larger of bytes over the memory rate
    and operations over the peak rate for their type."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / ops_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(t: torch.Tensor, rows: int | None = None) -> int:
    """Bytes of ``t``, or of ``rows`` of its rows (those the data needs)."""
    if rows is None:
        return t.numel() * t.element_size()
    return rows * (t.numel() // t.shape[0]) * t.element_size()


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build() -> None:
    t0 = time.perf_counter()
    _build.library()
    how = ("built" if _build.build_seconds is not None
           else "loaded an existing build of the same sources")
    print(f"kernels: {how} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc -gencode arch=compute_90a,code=sm_90a, one process per source)")
    fn = None
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "Used" in line and fn is not None:
            print(f"  ptxas {fn}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line and " 0 bytes spill stores" not in line:
            print(f"  ptxas {fn}: {line.strip()}")


def kernel_phase(cfg, params) -> dict:
    """Each kernel and its plain version on what rank 0 gets in MoE layer 0."""
    dev, dt, d = torch.device("cuda"), cfg.dtype, cfg.d_model
    p = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    comm = LocalComm(RANKS)
    T = BATCH // RANKS
    group = ep_group(cfg, comm, T)
    L, A = group.local_experts, group.ll_expert_cap
    gen = torch.Generator(device=dev).manual_seed(1)
    xs = [torch.randn((T, d), generator=gen, device=dev).to(dt) for _ in range(RANKS)]
    rs = [route(x.float() @ p["router"], router_config(cfg.moe)) for x in xs]
    hs = ep_create_handle(group, [r.topk_idx for r in rs], [r.topk_weights for r in rs])
    plans = [h.plan for h in hs]
    pl = plans[0]
    print(f"capacities: ll_disp_cap {group.ll_disp_cap}, ll_comb_cap "
          f"{group.ll_comb_cap}, ll_expert_cap {A}; rank 0 expert counts "
          f"{pl.disp_counts.tolist()}")
    out = {}

    def record(name, err, kernel, plain, bnd, library, shape, iters=50):
        """Time the kernel, its plain version and the library call on the
        card; keep the kernel's line for the JSON."""
        ms, plain_ms = device_ms(kernel, iters), device_ms(plain, iters)
        library_ms = None if library is None else device_ms(library, iters)
        out[name] = dict(name=name, route="cuda", source=KERNELS[name][1],
                         replaces=KERNELS[name][2], launches=None,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bnd[0], bound_by=bnd[1], library_ms=library_ms)
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        print(f"{name} {shape}: max_abs_err {err:.3g}, kernel {ms:.4f} ms on the "
              f"card ({call_ms(kernel, iters):.4f} ms per call from the host), "
              f"plain {plain_ms:.4f} ms{lib}, bound {bnd[0]:.4f} ms ({bnd[1]})")

    # ---- dispatch_pack: rank 0's dispatch send, copy mode (the main path)
    x0, g0 = xs[0], pl.disp_send_gmap
    got, _ = dp_mod.dispatch_pack(x0, g0, out_dtype=dt)
    want, _ = ref.dispatch_pack(x0, g0, None, dt)
    check(torch.equal(got, want), "dispatch_pack (copy) differs from its plain version")
    q, s = dp_mod.dispatch_pack(x0, g0, quant_block=128)
    wq, ws = ref.dispatch_pack(x0, g0, 128)
    check(torch.equal(q.view(torch.uint8), wq.view(torch.uint8)) and torch.equal(s, ws),
          "dispatch_pack (fp8) differs from its plain version")
    live = int((g0 < T).sum())
    record("dispatch_pack", max_err(got, want),
           lambda: dp_mod.dispatch_pack(x0, g0, out_dtype=dt),
           lambda: ref.dispatch_pack(x0, g0, None, dt),
           bound(nbytes(x0, live) + nbytes(got) + nbytes(g0), 0, F32_OPS_S), None,
           f"[{T},{d}] -> {list(got.shape)}")
    fp8_ms = device_ms(lambda: dp_mod.dispatch_pack(x0, g0, quant_block=128), 50)
    fp8_bnd = bound(nbytes(x0, live) + nbytes(q) + nbytes(s) + nbytes(g0),
                    3 * live * d, F32_OPS_S)
    print(f"dispatch_pack fp8 mode: kernel {fp8_ms:.4f} ms, plain "
          f"{device_ms(lambda: ref.dispatch_pack(x0, g0, 128), 50):.4f} ms, "
          f"bound {fp8_bnd[0]:.4f} ms ({fp8_bnd[1]})")

    # ---- recv_unpack: rank 0's dispatch recv into [L, A, H]
    recv0 = comm.all_to_all([ref.dispatch_pack(x, pn.disp_send_gmap, None, dt)[0]
                             for x, pn in zip(xs, plans)])[0].reshape(-1, d)
    gr = pl.disp_recv_gmap
    y3d = ru_mod.recv_unpack(recv0, gr)
    want = ref.recv_unpack(recv0, gr)
    check(torch.equal(y3d, want), "recv_unpack (copy) differs from its plain version")
    qs = [ref.dispatch_pack(x, pn.disp_send_gmap, 128) for x, pn in zip(xs, plans)]
    qrecv = comm.all_to_all([a for a, _ in qs])[0].reshape(-1, d)
    srecv = comm.all_to_all([b for _, b in qs])[0].reshape(qrecv.shape[0], -1)
    check(torch.equal(ru_mod.recv_unpack(qrecv, gr, srecv, out_dtype=dt),
                      ref.recv_unpack(qrecv, gr, srecv, dt)),
          "recv_unpack (fp8 dequant) differs from its plain version")
    live = int((gr < recv0.shape[0]).sum())
    record("recv_unpack", max_err(y3d, want),
           lambda: ru_mod.recv_unpack(recv0, gr),
           lambda: ref.recv_unpack(recv0, gr),
           bound(nbytes(recv0, live) + nbytes(y3d) + nbytes(gr), 0, F32_OPS_S), None,
           f"{list(recv0.shape)} -> {list(y3d.shape)}")

    # ---- grouped_gemm: rank 0's gate projection (up is the same shape) and
    # its down projection, with the ragged counts of this routing
    counts = pl.disp_counts
    w1, w3, w2 = p["w_gate"][:L], p["w_up"][:L], p["w_down"][:L]
    got = gg_mod.grouped_gemm(y3d, w1, counts)
    want = ref.grouped_gemm(y3d, w1, counts)
    check(torch.allclose(got.float(), want.float(), rtol=TOL, atol=TOL),
          "grouped_gemm (gate) differs from its plain version beyond 2e-2")
    hmid = (F.silu(want.float()) * ref.grouped_gemm(y3d, w3, counts).float()).to(dt)
    got_d = gg_mod.grouped_gemm(hmid, w2, counts)
    want_d = ref.grouped_gemm(hmid, w2, counts)
    check(torch.allclose(got_d.float(), want_d.float(), rtol=TOL, atol=TOL),
          "grouped_gemm (down) differs from its plain version beyond 2e-2")
    c = counts.clamp(max=A)
    rows, live_e = int(c.sum()), int((c > 0).sum())

    def gemm_bound(x, w, o):
        return bound(live_e * nbytes(w[0]) + nbytes(x[0], rows) + nbytes(o) + nbytes(counts),
                     2 * rows * x.shape[2] * w.shape[2], BF16_OPS_S)

    # rows past the count are zero in y3d and hmid, so bmm computes the same
    record("grouped_gemm", max(max_err(got, want), max_err(got_d, want_d)),
           lambda: gg_mod.grouped_gemm(y3d, w1, counts),
           lambda: ref.grouped_gemm(y3d, w1, counts),
           gemm_bound(y3d, w1, got), lambda: torch.bmm(y3d, w1),
           f"{list(y3d.shape)} @ {list(w1.shape)}", iters=10)
    dbnd = gemm_bound(hmid, w2, got_d)
    print(f"grouped_gemm down {list(hmid.shape)} @ {list(w2.shape)}: kernel "
          f"{device_ms(lambda: gg_mod.grouped_gemm(hmid, w2, counts), 10):.4f} ms, "
          f"plain {device_ms(lambda: ref.grouped_gemm(hmid, w2, counts), 10):.4f} ms, "
          f"library {device_ms(lambda: torch.bmm(hmid, w2), 10):.4f} ms, "
          f"bound {dbnd[0]:.4f} ms ({dbnd[1]})")

    # ---- combine_gather_reduce: rank 0's combine recv
    y3ds = [torch.randn((L, A, d), generator=gen, device=dev).to(dt) for _ in range(RANKS)]
    crecv = comm.all_to_all([ref.dispatch_pack(y.reshape(-1, d), pn.comb_send_gmap, None, dt)[0]
                             for y, pn in zip(y3ds, plans)])[0].reshape(-1, d)
    crows, cw = pl.comb_recv_rows, hs[0].topk_weights
    got = cg_mod.combine_gather_reduce(crecv, crows, cw)
    want = ref.combine_gather_reduce(crecv, crows, cw)
    check(torch.allclose(got.float(), want.float(), rtol=TOL, atol=TOL),
          "combine_gather_reduce differs from its plain version beyond 2e-2")
    valid = int((crows < crecv.shape[0]).sum())
    library = None
    if valid == crows.numel():      # no sentinel: embedding_bag is the same sum
        idx, wb = crows.long(), cw.to(dt)   # it wants weights of the table's type

        def library():
            return F.embedding_bag(idx, crecv, per_sample_weights=wb, mode="sum")
    record("combine_gather_reduce", max_err(got, want),
           lambda: cg_mod.combine_gather_reduce(crecv, crows, cw),
           lambda: ref.combine_gather_reduce(crecv, crows, cw),
           bound(nbytes(crecv, valid) + nbytes(crows) + nbytes(cw) + nbytes(got),
                 2 * valid * d, F32_OPS_S), library,
           f"{list(crecv.shape)} rows {list(crows.shape)}")
    return out


def trace_phase(srv: DecodeServer, itl_s: float) -> None:
    """One more decode step of the EP server under the profiler: the card's
    busy time against the untraced step time ``itl_s``, and where the
    device time goes."""
    tok = torch.zeros((BATCH, 1), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.step(tok)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    iv = device_intervals(prof)
    busy = busy_us(iv)
    print(f"trace of one EP decode step: card busy {busy / 1e3:.2f} ms, "
          f"{len(iv)} device events; idle share {1 - busy / (itl_s * 1e6):.3f} of the "
          f"untraced step ({itl_s * 1e3:.2f} ms ITL mean), "
          f"{1 - busy / wall_us:.3f} of the traced one ({wall_us / 1e3:.2f} ms)")
    by_name: dict[str, list[float]] = {}
    for s, e, name in iv:
        by_name.setdefault(name, []).append(e - s)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    for name, ds in top:
        print(f"  {sum(ds) / 1e3:8.3f} ms  {len(ds):5d}x  {name[:100]}")


def serve_phase(srv: DecodeServer, card: str) -> tuple[dict, float]:
    """The main path: DecodeServer.serve, with every launch counter read."""
    cfg = srv.cfg
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2))
    for mod, *_ in KERNELS.values():
        mod.launches = 0
    metrics = srv.serve(prompts, GEN)
    launches = {name: k[0].launches for name, k in KERNELS.items()}
    steps = PROMPT + GEN
    for name, (_, _, _, per) in KERNELS.items():
        want = per * LAYERS * RANKS * steps
        check(launches[name] == want, f"{name} launched {launches[name]} times "
              f"on the main path, expected {want}")
    toks = srv.last_tokens
    check(toks.shape == (BATCH, GEN + 1) and toks.min() >= 0 and toks.max() < cfg.vocab,
          f"bad token stream {toks.shape}")
    m = metrics.as_dict()
    check(all(np.isfinite(v) and v > 0 for v in m.values()), f"bad metrics {m}")
    print(f"serve ({card}): ttft {m['ttft_s']:.4f} s, itl mean {m['itl_mean_s']:.4f} s, "
          f"itl p99 {m['itl_p99_s']:.4f} s, {m['output_tok_s']:.1f} output tok/s, "
          f"{m['total_tokens']} tokens; launches {launches}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    dense = DecodeServer(cfg, BATCH, PROMPT + GEN + 1, ep_size=1, params=srv.params)
    dm = dense.serve(prompts, GEN).as_dict()
    agree = dense.last_tokens == toks
    print(f"dense server (no EP, same weights): itl mean {dm['itl_mean_s']:.4f} s, "
          f"{dm['output_tok_s']:.1f} output tok/s; greedy tokens equal to the EP "
          f"run: {agree.mean():.4f} of all, {agree[:, 0].mean():.4f} of the first")
    return launches, m["itl_mean_s"]


def oracle_phase(cfg, params) -> None:
    """Each MoE layer's EP output against the dense fallback, same input."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    for i in range(LAYERS):
        p = {k: v[i] for k, v in params["moe_stack"]["moe"].items()}
        x = torch.randn((BATCH, 1, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype)
        ep, _ = moe_block(p, x, cfg, LocalComm(RANKS))
        dn = _moe_dense_fallback(p, x, cfg)
        check(ep.shape == dn.shape == x.shape and bool(torch.isfinite(ep).all()),
              f"MoE layer {i}: bad EP output")
        rel = float((ep.float() - dn.float()).norm() / dn.float().norm())
        print(f"oracle: MoE layer {i} EP vs dense relative error {rel:.3g} (limit {TOL})")
        check(rel <= TOL, f"MoE layer {i}: EP output off the dense fallback by {rel}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    build()
    full = full_config("decode_32k")
    cfg = dataclasses.replace(full, num_layers=LAYERS)
    m = cfg.moe
    print(f"DBRX-132B at full width: d_model {cfg.d_model}, {cfg.attn.n_heads}/"
          f"{cfg.attn.n_kv} heads of {cfg.attn.head_dim}, {m.num_experts} experts "
          f"top-{m.top_k}, d_ff_expert {m.d_ff_expert}, vocab {cfg.vocab}, {cfg.dtype}; "
          f"num_layers cut from {full.num_layers} to {LAYERS} for memory; "
          f"{RANKS} EP ranks on one card, batch {BATCH}, prompt {PROMPT}, {GEN} generated")
    t0 = time.perf_counter()
    # one cache slot beyond the served tokens, for the traced step
    srv = DecodeServer(cfg, BATCH, PROMPT + GEN + 1, ep_size=RANKS, seed=0)
    torch.cuda.synchronize()
    print(f"init: random weights on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    # the main path runs first, before any profiling touches the card
    launches, itl_s = serve_phase(srv, card)
    trace_phase(srv, itl_s)
    records = kernel_phase(cfg, srv.params)
    oracle_phase(cfg, srv.params)
    for name, n in launches.items():
        records[name]["launches"] = n
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
