"""The hand-written Hopper kernels against their plain versions, on the card.

Every test here needs an sm_90 card and skips elsewhere. The file imports
nothing of JAX, so it runs on a machine without it; ``tests/conftest.py``
imports JAX, hence the command (see README):

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_cuda.py

Data movement (pack, unpack, fp8 quantize and dequantize) must match bit for
bit; the GEMM and the reductions within 1e-5 (f32) or 2e-2 (bf16), since the
sums run in another order. The bf16 GEMM must also be deterministic and
row-invariant: a row's bits depend only on that row of x and its expert's
weights, which the decode layouts' bitwise checks in chip_smoke.py rely on.
Paged decode attention sums in f32 whatever the pool's type, so it is held
to 1e-4 in both, and must not change a bit when unreferenced pages change.
Flash attention is held to 1e-4 in f32 and 2e-2 in bf16 (5e-3 relative over
the output), where the kernel rounds the probabilities to bf16 for the PV
product, and two calls must give the same bits.

The compiled serve step (a CUDA graph captured once and replayed) must give
the same tokens bit for bit as the uncompiled step, in both engines and all
three EP layouts; the two-stream ``decode_loop`` must equal the naive step
bit for bit, eager and captured; B3 on two streams at once must give each
stream's single-stream result (its split-tile counters are per stream).
The training backward: ``grouped_gemm_dw`` within the GEMM's limits,
``combine_gather_reduce_bwd``'s row gradient bitwise and its weight
gradient within 1e-5, flash attention's LSE within 1e-4 and its dQ / dK-dV
pair within 1e-4 (f32) or 5e-3 (bf16) relative, each deterministic; MLA's
``MlaChunked`` at DeepSeek-V3's widths, its forward bitwise the plain
loop's, its gradients within 2e-2 of autograd through the loop at a third
of its peak memory or less; a kernel entry refuses a CUDA input that requires grad outside
``kernels/autograd.py``; ``moe_block``'s gradients through the kernels
within 1e-4 of the same layer on the plain versions; the EP round trip's
gradients in every layout (HT flat, ``deepep`` with and without fp8, the
baseline, hierarchical HT with and without fp8) within 1e-5 of the same
round trip on the CPU; the parameters a
``Trainer`` returns on the card served by the captured server as they are.
Over NCCL, in a spawned process per card: ``DistComm``'s primitives
against ``LocalComm``'s, one EP layer captured, and the continuous server
captured, every rank admitting alike (at world 1 its streams bitwise equal
to the dense-path server's).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.comm import LocalComm
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.device import disable_tf32
from repro_torch.kernels import combine_gather_reduce as cg
from repro_torch.kernels import combine_reduce as cr
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import dispatch_pack as dp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fp8
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels import recv_unpack as ru
from repro_torch.kernels import ref
from repro_torch.core import (ep_combine, ep_complete, ep_create_handle, ep_dispatch,
                              route)
from repro_torch.models.moe import (_expert_ffn, _moe_dense_fallback, ep_group,
                                    moe_block, router_config)
from repro_torch.runtime.decode import decode_loop, naive_decode_step, pipelined_decode_step
from repro_torch.runtime.prefill import _handle
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.server import ContinuousDecodeServer, DecodeServer
from repro_torch.runtime.steps import CompiledStep, capture_stream
from repro_torch.weights import init_params


def tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an NVIDIA sm_90 (Hopper) card")
    disable_tf32()
    return torch.device("cuda")


def _rand(shape, dtype, dev, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_dispatch_pack_and_recv_unpack_bitwise(hopper, dt):
    T, H, N, C = 40, 520, 8, 24                              # ragged on purpose
    x = _rand((T, H), dt, hopper, 30.0)
    x[5] = 0.0                                               # all-zero blocks: scale 1
    gmap = torch.randint(0, T + 1, (N, C), device=hopper, dtype=torch.int32)
    for od in (None, torch.bfloat16, torch.float32):
        got, _ = dp.dispatch_pack(x, gmap, out_dtype=od)
        want, _ = ref.dispatch_pack(x, gmap, out_dtype=od)
        assert torch.equal(got, want)
    for block in (8 * 13, 520):
        q, s = dp.dispatch_pack(x, gmap, quant_block=block)
        wq, ws = ref.dispatch_pack(x, gmap, quant_block=block)
        assert torch.equal(q.view(torch.uint8), wq.view(torch.uint8)) and torch.equal(s, ws)
    rg = torch.randint(0, N * C + 1, (3, 17), device=hopper, dtype=torch.int32)
    flat_q, flat_s = q.reshape(N * C, H), s.reshape(N * C, -1)
    for od in (torch.bfloat16, torch.float32):
        assert torch.equal(ru.recv_unpack(flat_q, rg, flat_s, out_dtype=od),
                           ref.recv_unpack(flat_q, rg, flat_s, od))
    for width in (H, 5):                                     # any row width
        rows = x[:, :width].contiguous()
        g2 = torch.randint(0, T + 1, (4, 9), device=hopper, dtype=torch.int32)
        assert torch.equal(ru.recv_unpack(rows, g2), ref.recv_unpack(rows, g2))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_grouped_gemm_and_combine(hopper, dt):
    L, A, H, F = 3, 136, 264, 200
    x = _rand((L, A, H), dt, hopper, 0.1, 1)
    w = _rand((L, H, F), dt, hopper, 0.1, 2)
    counts = torch.tensor([0, 65, 500], device=hopper, dtype=torch.int32)
    got = gg.grouped_gemm(x, w, counts)
    torch.testing.assert_close(got, ref.grouped_gemm(x, w, counts), **tol(dt))
    assert not got[0].any() and not got[1, 65:].any()
    R, T, K = 50, 16, 4
    recv = _rand((R, H), dt, hopper, 1.0, 3)
    rows = torch.randint(0, R + 1, (T, K), device=hopper, dtype=torch.int32)
    wts = torch.rand((T, K), device=hopper)
    torch.testing.assert_close(cg.combine_gather_reduce(recv, rows, wts),
                               ref.combine_gather_reduce(recv, rows, wts), **tol(dt))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("H,F", [(6144, 10752), (10752, 6144), (1024, 128 * 70)],
                         ids=["dbrx-gate", "dbrx-down", "h1024"])
def test_cuda_grouped_gemm_rows_do_not_depend_on_the_slot_count(hopper, H, F):
    """EPLB changes the experts a rank holds (L), so which tiles the stream
    schedule splits; the first two experts' rows at L = 3 must be bitwise
    those at L = 2 (the fixed segment fold)."""
    dt = torch.bfloat16
    x = _rand((3, 128, H), dt, hopper, 0.5, 21)
    w = _rand((3, H, F), dt, hopper, H ** -0.5, 22)
    counts = torch.tensor([128, 41, 97], device=hopper, dtype=torch.int32)
    out3 = gg.grouped_gemm(x, w, counts)
    out2 = gg.grouped_gemm(x[:2].contiguous(), w[:2].contiguous(), counts[:2].contiguous())
    assert gg.plan(2, 128, H, F).sk_tiles != gg.plan(3, 128, H, F).sk_tiles
    assert torch.equal(out3[:2], out2)
    torch.testing.assert_close(out3, ref.grouped_gemm(x, w, counts), **tol(dt))


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("A", [128, 136, 1000], ids=["stream", "compute-136", "compute-1000"])
def test_cuda_grouped_gemm_bf16_schedules(hopper, A, L):
    """Both bf16 schedules (A = 128 streams the weights with a K split; A >
    128 is the compute schedule) at H and F that are multiples of 8 but not
    of 64, counts on every tile edge: within tol of the plain version, rows
    past the count exactly zero whatever x holds there, two calls bitwise
    equal, rows below a count bitwise the same as with every row live, and
    with every row live a permutation of x's rows permutes the output
    bitwise."""
    H, F = 264, 200
    dt = torch.bfloat16
    x = _rand((L, A, H), dt, hopper, 1.0, 11) + 0.25          # no symmetry to hide a swap
    w = _rand((L, H, F), dt, hopper, 0.1, 12)
    w[:, :, :3] += 0.5
    edges = [0, 1, 63, 64, 65, 127, 128, A, A + 1]
    full = torch.full((L,), A, device=hopper, dtype=torch.int32)
    all_rows = gg.grouped_gemm(x, w, full)
    torch.testing.assert_close(all_rows, ref.grouped_gemm(x, w, full), **tol(dt))
    for i in range(len(edges)):
        counts = torch.tensor([edges[(i + l) % len(edges)] for l in range(L)],
                              device=hopper, dtype=torch.int32)
        before = gg.launches
        got = gg.grouped_gemm(x, w, counts)
        assert gg.launches == before + 1
        torch.testing.assert_close(got, ref.grouped_gemm(x, w, counts), **tol(dt))
        assert torch.equal(got, gg.grouped_gemm(x, w, counts))
        for l in range(L):
            c = min(int(counts[l]), A)
            assert not got[l, c:].any()
            assert torch.equal(got[l, :c], all_rows[l, :c])
    perm = torch.randperm(A, generator=torch.Generator().manual_seed(13)).to(hopper)
    assert torch.equal(gg.grouped_gemm(x[:, perm].contiguous(), w, full), all_rows[:, perm])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_moe_block_runs_the_kernels_and_matches_dense(hopper, dt):
    """The LL MoE layer over 8 hosted ranks launches each kernel and equals
    the dense fallback (every capacity of the smoke config is zero-drop)."""
    cfg = dataclasses.replace(smoke_config(), dtype=dt)
    params = init_params(cfg, seed=0, device=hopper)
    p = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    x = _rand((16, 2, cfg.d_model), dt, hopper, 1.0, 4)
    before = (dp.launches, ru.launches, gg.launches, cg.launches)
    y, _ = moe_block(p, x, cfg, LocalComm(8))
    grew = [a - b for a, b in zip((dp.launches, ru.launches, gg.launches, cg.launches),
                                  before)]
    assert grew == [16, 8, 24, 8]
    torch.testing.assert_close(y, _moe_dense_fallback(p, x, cfg), **tol(dt))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("share_kv", [False, True], ids=["gqa", "share_kv"])
def test_cuda_paged_decode_attention(hopper, dt, splits, share_kv):
    """Shuffled tables, ragged tails, full and idle rows, a page size that is
    not a multiple of the kernel's chunk: within 1e-4 of the plain version,
    idle rows exactly 0, bitwise unchanged under new garbage in every
    unreferenced page (the pad page included)."""
    if share_kv:                                  # absorbed MLA: head tiles of 16, 16, 8
        Hq, Hkv, dk, dv = 40, 1, 72, 64
    else:
        Hq, Hkv, dk, dv = 12, 4, 64, 64
    B, page, max_pages = 6, 12, 8
    lens = torch.tensor([1, 95, 0, 96, 37, 50], dtype=torch.int32)
    P = B * max_pages
    gen = torch.Generator().manual_seed(7)
    perm = torch.randperm(P, generator=gen)
    tbl = torch.full((B, max_pages), P, dtype=torch.int32)
    used = []
    for b in range(B):
        n = -(-int(lens[b]) // page)
        tbl[b, :n] = perm[b * max_pages:b * max_pages + n].int()
        used += tbl[b, :n].tolist()
    kp = _rand((P + 1, page, Hkv, dk), dt, hopper, 1.0, 8)
    vp = None if share_kv else _rand((P + 1, page, Hkv, dv), dt, hopper, 1.0, 9)
    q = _rand((B, Hq, dk), dt, hopper, 1.0, 10)
    tbl, lens = tbl.to(hopper), lens.to(hopper)
    kw = dict(scale=dk ** -0.5, num_kv_splits=splits, dv=dv if share_kv else None)
    before = (da.launches, da.stage2_launches)
    got = da.paged_decode_attention(q, kp, vp, tbl, lens, **kw)
    # stage 2 runs only when a request of the table's width could be split:
    # never at 96 tokens (the long-row test below takes that path)
    assert not da.splits_possible(splits, max_pages, page)
    assert (da.launches, da.stage2_launches) == (before[0] + 1, before[1])
    want = ref.paged_decode_attention(q, kp, vp, tbl, lens, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert not got[2].any()
    free = torch.ones(P + 1, dtype=torch.bool)
    free[used] = False
    free = free.to(hopper)
    kp[free] = _rand(kp[free].shape, dt, hopper, 50.0, 11)
    if vp is not None:
        vp[free] = _rand(vp[free].shape, dt, hopper, 50.0, 12)
    assert torch.equal(da.paged_decode_attention(q, kp, vp, tbl, lens, **kw), got)
    with pytest.raises(ValueError, match="divide by the split"):
        da.paged_decode_attention(q, kp, vp, tbl, lens, **dict(kw, num_kv_splits=3))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_paged_decode_attention_dbrx_long_rows(hopper, dt):
    """DBRX's head layout (48 query heads over 8 kv heads of 128, page 16)
    with rows of several thousand tokens, so that requests are cut into
    splits: within 1e-4 of the plain version, idle rows exactly 0, two calls
    bitwise equal, and each request bitwise the same alone as among its
    neighbours (the split depends only on its own length)."""
    Hq, Hkv, d, page, max_pages = 48, 8, 128, 16, 512
    lens = torch.tensor([5000, 0, 1, 16, 300, max_pages * page, 4097], dtype=torch.int32)
    B = lens.numel()
    gen = torch.Generator().manual_seed(23)
    pages = [-(-int(n) // page) for n in lens]
    P = sum(pages) + 64
    perm = torch.randperm(P, generator=gen)
    tbl = torch.full((B, max_pages), P, dtype=torch.int32)
    off = 0
    for b, n in enumerate(pages):
        tbl[b, :n] = perm[off:off + n].int()
        off += n
    kp = _rand((P + 1, page, Hkv, d), dt, hopper, 1.0, 20)
    vp = _rand((P + 1, page, Hkv, d), dt, hopper, 1.0, 21)
    q = _rand((B, Hq, d), dt, hopper, 1.0, 22)
    tbl, lens = tbl.to(hopper), lens.to(hopper)
    kw = dict(scale=d ** -0.5, num_kv_splits=4)
    before = (da.launches, da.stage2_launches)
    got = da.paged_decode_attention(q, kp, vp, tbl, lens, **kw)
    assert (da.launches, da.stage2_launches) == (before[0] + 1, before[1] + 1)
    want = torch.cat([ref.paged_decode_attention(q[b:b + 1], kp, vp, tbl[b:b + 1],
                                                 lens[b:b + 1], **kw) for b in range(B)])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert not got[1].any()
    assert torch.equal(da.paged_decode_attention(q, kp, vp, tbl, lens, **kw), got)
    for b in (0, 4, 5):
        alone = da.paged_decode_attention(q[b:b + 1].contiguous(), kp, vp,
                                          tbl[b:b + 1].contiguous(),
                                          lens[b:b + 1].contiguous(), **kw)
        assert torch.equal(alone[0], got[b])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_dispatch_pack_quant_mostly_sentinel(hopper, dt):
    """Quant mode at DBRX's width (H 6144, block 128) with more than half of
    the slots sentinel: bitwise equal to the plain version (zero rows with
    scale 1.0, an all-zero block's scale 1.0), and bitwise equal to
    quantize_fp8 on the live rows."""
    T, H, N, C = 48, 6144, 8, 40
    x = _rand((T, H), dt, hopper, 30.0, 24)
    x[7, 256:384] = 0.0
    gen = torch.Generator().manual_seed(25)
    gmap = torch.full((N, C), T, dtype=torch.int32)
    live = torch.rand((N, C), generator=gen) < 0.4
    gmap[live] = torch.randint(0, T, (int(live.sum()),), generator=gen, dtype=torch.int32)
    gmap[0, 0] = 7
    assert int((gmap == T).sum()) > N * C // 2
    gmap = gmap.to(hopper)
    q, s = dp.dispatch_pack(x, gmap, quant_block=128)
    wq, ws = ref.dispatch_pack(x, gmap, quant_block=128)
    assert torch.equal(q.view(torch.uint8), wq.view(torch.uint8)) and torch.equal(s, ws)
    assert s[0, 0, 2].item() == 1.0
    fq, fs = fp8.quantize_fp8(x, 128)
    rows = gmap.flatten().long()
    keep = rows < T
    assert torch.equal(q.view(torch.uint8).reshape(N * C, H)[keep],
                       fq.view(torch.uint8)[rows[keep]])
    assert torch.equal(s.reshape(N * C, -1)[keep], fs[rows[keep]])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt,od", [(torch.bfloat16, torch.float32),
                                   (torch.float32, torch.bfloat16),
                                   (torch.float16, torch.float32),
                                   (torch.bfloat16, torch.float16)])
def test_cuda_dispatch_pack_copy_dtype_change(hopper, dt, od):
    """Copy mode with a dtype change at the decode combine send's shape
    ([256, 6144] rows into [8, 32] slots, sentinels included): bitwise equal
    to the plain version's gather then cast, sentinel rows exactly 0."""
    T, H, N, C = 256, 6144, 8, 32
    x = _rand((T, H), dt, hopper, 3.0, 26)
    gmap = torch.randint(0, T + 1, (N, C), generator=torch.Generator().manual_seed(27),
                         dtype=torch.int32)
    gmap[3, :5] = T
    gmap = gmap.to(hopper)
    got, _ = dp.dispatch_pack(x, gmap, out_dtype=od)
    want, _ = ref.dispatch_pack(x, gmap, out_dtype=od)
    assert got.dtype == od and torch.equal(got, want)
    assert not got[3, :5].any()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,d", [(1, 128), (6, 128), (4, 64), (1, 96), (2, 96)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 77), (False, None),
                                           (False, 150)])
def test_cuda_flash_attention(hopper, dt, G, d, causal, window):
    """Ragged lengths (Sq 200 over Sk 328: tails in both tile sizes), GQA
    without repetition, the model's [B, S, H, d] layout; one launch per
    call, two calls bitwise equal. bf16: relative error (Frobenius norm)
    within 5e-3, about twice
    what rounding p and the output to bf16 gives, and every element within
    2e-2. Head width 96 (Phi-3-vision; bf16 on the 128 instance over
    96-column maps) at G 1 and 2."""
    bshd, kw = _flash_case(hopper, dt, G, d, causal, window, 200, 328)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bshd(*(a[..., :32].contiguous() for a in bshd), **kw)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 300), (False, None),
                                           (False, 300)])
def test_cuda_flash_attention_many_query_tiles(hopper, dt, causal, window):
    """Sq = Sk = 1000 at G = 6: eight 128-row query tiles with a ragged
    last one, several KV tiles per query tile (unmasked ones among them)
    and more work tiles than a persistent lane takes at once; the limits
    of test_cuda_flash_attention."""
    _flash_case(hopper, dt, 6, 128, causal, window, 1000, 1000)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 1024), (False, None)])
def test_cuda_flash_attention_d96_with_lse(hopper, dt, G, causal, window):
    """Head width 96 with the row LSE (what the forward under grad asks
    for) over 4 query tiles and 17 KV tiles, the last ragged: the output
    as test_cuda_flash_attention holds it, the LSE within 1e-4, the
    output bitwise that of the call without it; the backward pair refuses
    96, naming the queue item that ports it."""
    B, Hkv, S, d = 2, 2, 2100, 96
    q = _rand((B, S, Hkv * G, d), dt, hopper, 1.0, 21)
    k = _rand((B, S, Hkv, d), dt, hopper, 1.0, 22)
    v = _rand((B, S, Hkv, d), dt, hopper, 1.0, 23)
    kw = dict(scale=d ** -0.5, window=window, causal=causal)
    out, lse = fa.flash_attention_bshd(q, k, v, with_lse=True, **kw)
    assert torch.equal(fa.flash_attention_bshd(q, k, v, **kw), out)
    want, want_lse = ref.flash_attention_fwd(*(a.transpose(1, 2) for a in (q, k, v)), **kw)
    want = want.transpose(1, 2)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    if dt == torch.bfloat16:
        assert _rel(out, want) <= 5e-3
        torch.testing.assert_close(out, want, rtol=2e-2, atol=2e-2)
    else:
        torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="A12a-train"):
        fa.flash_attention_bwd(q, k, v, out, out, lse, **kw)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 4])
def test_cuda_paged_decode_attention_dk96(hopper, dt, splits):
    """Phi-3-vision's paged decode: dk = dv = 96, G 1 (the CUDA-core
    path), shuffled tables, ragged and idle rows, long enough rows to
    split: within 1e-4 of the plain version, idle rows exactly 0, two
    calls bitwise equal."""
    B, Hkv, d, page, max_pages = 6, 4, 96, 16, 40
    lens = torch.tensor([1, 600, 0, 640, 37, 255], dtype=torch.int32)
    P = B * max_pages
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(24))
    tbl = torch.full((B, max_pages), P, dtype=torch.int32)
    for b in range(B):
        n = -(-int(lens[b]) // page)
        tbl[b, :n] = perm[b * max_pages:b * max_pages + n].int()
    kp = _rand((P + 1, page, Hkv, d), dt, hopper, 1.0, 25)
    vp = _rand((P + 1, page, Hkv, d), dt, hopper, 1.0, 26)
    q = _rand((B, Hkv, d), dt, hopper, 1.0, 27)
    tbl, lens = tbl.to(hopper), lens.to(hopper)
    kw = dict(scale=d ** -0.5, num_kv_splits=splits)
    got = da.paged_decode_attention(q, kp, vp, tbl, lens, **kw)
    want = ref.paged_decode_attention(q, kp, vp, tbl, lens, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert not got[2].any()
    assert torch.equal(da.paged_decode_attention(q, kp, vp, tbl, lens, **kw), got)
    torch.cuda.synchronize()


def _flash_case(dev, dt, G, d, causal, window, Sq, Sk):
    """One call of flash_attention_bshd on [B, S, H, d] tensors against the
    plain version, one launch; a second call bitwise equal to the first.
    Returns the inputs and options."""
    B, Hkv = 2, 2
    q = _rand((B, Hkv * G, Sq, d), dt, dev, 1.0, 13)
    k = _rand((B, Hkv, Sk, d), dt, dev, 1.0, 14)
    v = _rand((B, Hkv, Sk, d), dt, dev, 1.0, 15)
    kw = dict(scale=d ** -0.5, window=window, causal=causal)
    bshd = [a.transpose(1, 2).contiguous() for a in (q, k, v)]
    before = fa.launches
    got = fa.flash_attention_bshd(*bshd, **kw)
    assert fa.launches == before + 1 and got.dtype == dt
    assert torch.equal(fa.flash_attention_bshd(*bshd, **kw), got)
    got = got.transpose(1, 2)
    want = ref.flash_attention(q, k, v, **kw)
    if dt == torch.bfloat16:
        rel = (got.float() - want.float()).norm() / want.float().norm()
        assert rel <= 5e-3, rel
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    return bshd, kw


@pytest.mark.gpu
def test_cuda_moe_block_ht_matches_dense(hopper):
    """The HT flat MoE layer at zero drop over 8 hosted ranks launches each
    EP kernel as the path implies and equals the dense fallback (f32)."""
    cfg = dataclasses.replace(smoke_config(), dtype=torch.float32)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_mode="ht",
                                                           expert_capacity_factor=None))
    params = init_params(cfg, seed=0, device=hopper)
    p = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    x = _rand((8, 32, cfg.d_model), torch.float32, hopper, 1.0, 16)
    before = (dp.launches, ru.launches, gg.launches, cg.launches)
    y, _ = moe_block(p, x, cfg, LocalComm(8))
    grew = [a - b for a, b in zip((dp.launches, ru.launches, gg.launches, cg.launches),
                                  before)]
    assert grew == [16, 8, 24, 8]
    torch.testing.assert_close(y, _moe_dense_fallback(p, x, cfg), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [128, 64, 104])
def test_cuda_fp8_quantize_dequantize_bitwise(hopper, dt, block):
    """quantize_fp8 and dequantize_fp8 bitwise against their plain versions
    (an all-zero block included; block 104 divides H = 520 but is not a
    power of two), and quantize bitwise against dispatch_pack's quant mode
    through an identity map: the two share one device function."""
    M, H = 40, (520 if block == 104 else 512)
    x = _rand((M, H), dt, hopper, 30.0, 17)
    x[3, :block] = 0.0
    before = (fp8.quantize_launches, fp8.dequantize_launches)
    q, s = fp8.quantize_fp8(x, block)
    wq, ws = ref.quantize_fp8(x, block)
    assert torch.equal(q.view(torch.uint8), wq.view(torch.uint8)) and torch.equal(s, ws)
    assert s[3, 0].item() == 1.0
    for od in (torch.bfloat16, torch.float32, torch.float16):
        assert torch.equal(fp8.dequantize_fp8(q, s, od), ref.dequantize_fp8(q, s, od))
    assert (fp8.quantize_launches, fp8.dequantize_launches) == (before[0] + 1, before[1] + 3)
    ident = torch.arange(M, device=hopper, dtype=torch.int32).view(1, M)
    pq, ps = dp.dispatch_pack(x, ident, quant_block=block)
    assert torch.equal(pq[0].view(torch.uint8), q.view(torch.uint8)) and torch.equal(ps[0], s)
    q3, s3 = fp8.quantize_fp8(x.view(4, M // 4, H), block)       # any leading shape
    assert torch.equal(q3.view(torch.uint8).reshape(M, H), q.view(torch.uint8))
    assert torch.equal(s3.reshape(M, -1), s)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_combine_reduce(hopper, dt):
    T, K, H = 24, 4, 264
    y = _rand((T, K, H), dt, hopper, 1.0, 18)
    w = torch.rand((T, K), device=hopper)
    before = cr.launches
    got = cr.combine_reduce(y, w)
    assert cr.launches == before + 1 and got.dtype == dt
    torch.testing.assert_close(got, ref.combine_reduce(y, w), **tol(dt))
    y8 = y.to(torch.float8_e4m3fn)                                # fp8 in, bf16 out
    torch.testing.assert_close(cr.combine_reduce(y8, w), ref.combine_reduce(y8, w),
                               rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["deepep", "deepep_fp8", "baseline"])
def test_cuda_moe_block_positional_layouts_match_dense(hopper, layout):
    """The LL deepep layer (bf16 payload in f32, fp8 payload in bf16 at
    d_model 256) and the baseline layer over 8 hosted ranks launch the
    kernels their path implies and equal the dense fallback: within 1e-5 in
    f32, and with fp8 within 2e-2 relative of the dense layer fed the plain
    quantize->dequantize round trip of x."""
    moe = {"deepep": dict(ll_layout="deepep"), "baseline": dict(ep_mode="baseline"),
           "deepep_fp8": dict(ll_layout="deepep", quantize_dispatch=True)}[layout]
    fp8_path = layout == "deepep_fp8"
    cfg = smoke_config()
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16 if fp8_path else torch.float32,
                              d_model=256 if fp8_path else cfg.d_model,
                              moe=dataclasses.replace(cfg.moe, **moe))
    params = init_params(cfg, seed=0, device=hopper)
    p = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    x = _rand((16, 2, cfg.d_model), cfg.dtype, hopper, 1.0, 19)
    if fp8_path:
        x = ref.dequantize_fp8(*ref.quantize_fp8(x, 128), cfg.dtype)

    def count():
        return (dp.launches, ru.launches, fp8.dequantize_launches, gg.launches, cg.launches)
    before = count()
    y, _ = moe_block(p, x, cfg, LocalComm(8))
    grew = [a - b for a, b in zip(count(), before)]
    assert grew == [8, 0, 8 if fp8_path else 0, 24, 8]
    dense = _moe_dense_fallback(p, x, cfg)
    if fp8_path:
        assert (y.float() - dense.float()).norm() / dense.float().norm() <= 2e-2
    else:
        torch.testing.assert_close(y, dense, rtol=1e-5, atol=1e-5)


def _mostly_sentinel_map(shape, n, live_share, seed):
    """An int32 slot map of ``shape`` over rows [0, n), about ``live_share``
    of its slots live and the rest the sentinel n, made on the host."""
    gen = torch.Generator().manual_seed(seed)
    gmap = torch.full(shape, n, dtype=torch.int32)
    live = torch.rand(shape, generator=gen) < live_share
    gmap[live] = torch.randint(0, n, (int(live.sum()),), generator=gen, dtype=torch.int32)
    return gmap


@pytest.mark.gpu
@pytest.mark.parametrize("dt,H", [(torch.bfloat16, 6144), (torch.float32, 6144),
                                  (torch.float8_e4m3fn, 6144), (torch.float8_e4m3fn, 6152)],
                         ids=["bf16", "f32", "fp8", "fp8-any-width"])
def test_cuda_recv_unpack_copy_decode_mostly_sentinel(hopper, dt, H):
    """B2's copy mode at the decode recv's shape ([128, H] into [2, 128]
    slots, about 70 of the 256 live): bitwise equal to the plain version,
    sentinel slots exactly zero, one launch. fp8 rows of 6144 bytes take the
    shared gather, of 6152 the element-by-element route."""
    R = 128
    recv = _rand((R, H), torch.float32, hopper, 30.0, 28).to(dt)
    gmap = _mostly_sentinel_map((2, 128), R, 70 / 256, 29)
    assert int((gmap < R).sum()) < 128
    gmap = gmap.to(hopper)
    before = ru.launches
    got = ru.recv_unpack(recv, gmap)
    assert ru.launches == before + 1 and got.shape == (2, 128, H) and got.dtype == dt
    want = ref.recv_unpack(recv, gmap)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert not got.view(torch.uint8)[gmap == R].any()
    assert ru.copy_route(H, dt, dt, recv.data_ptr(), got.data_ptr()) == int(H != 6152)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("block", [128, 104])
@pytest.mark.parametrize("od", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset-payload"])
def test_cuda_recv_unpack_dequant_bitwise(hopper, block, od, aligned):
    """B2's fused fp8 dequant, blocks of 128 (16-byte pieces into bf16,
    8-byte into f32) and 104 (8-byte pieces; a payload one byte off
    alignment goes element by element), bf16 and f32 out, with sentinel
    slots and an all-zero block: bitwise equal to the plain version;
    sentinel rows exactly zero."""
    R, H = 96, (6144 if block == 128 else 1040)
    x = _rand((R, H), torch.float32, hopper, 30.0, 30)
    x[4, :block] = 0.0
    q, s = ref.quantize_fp8(x, block)
    if not aligned:
        buf = torch.empty(R * H + 1, dtype=torch.uint8, device=hopper)
        buf[1:].copy_(q.view(torch.uint8).flatten())
        q = buf[1:].view(torch.float8_e4m3fn).view(R, H)
    gmap = _mostly_sentinel_map((3, 40), R, 0.5, 31)
    gmap[0, 0] = 4
    gmap = gmap.to(hopper)
    before = ru.launches
    got = ru.recv_unpack(q, gmap, s, out_dtype=od)
    assert ru.launches == before + 1
    want = ref.recv_unpack(q, gmap, s, od)
    assert got.dtype == od and torch.equal(got, want)
    assert not got[gmap == R].any()
    piece = ru.dequant_piece(block, od, q.data_ptr(), got.data_ptr())
    assert piece == (1 if not aligned else 16 if block == 128 and od == torch.bfloat16 else 8)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_dispatch_pack_and_recv_unpack_share_the_copy(hopper, dt):
    """B1's and B2's copy modes run one row gather: on the same rows and map
    (sentinel T for both) they give the same bits, equal to both plain
    versions, with the dtype unchanged and through a dtype change."""
    T, H, N, C = 200, 6144, 8, 32
    x = _rand((T, H), dt, hopper, 3.0, 32)
    gmap = _mostly_sentinel_map((N, C), T, 0.4, 33).to(hopper)
    for od in (dt, torch.bfloat16 if dt != torch.bfloat16 else torch.float32):
        packed, _ = dp.dispatch_pack(x, gmap, out_dtype=od)
        unpacked = ru.recv_unpack(x, gmap, out_dtype=od)
        assert torch.equal(packed, unpacked)
        assert torch.equal(packed, ref.dispatch_pack(x, gmap, out_dtype=od)[0])
        assert torch.equal(unpacked, ref.recv_unpack(x, gmap, out_dtype=od))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 4, 6, 8])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_combine_gather_reduce_any_k(hopper, K, dt):
    """B4 over K in {1, 4, 6, 8} in f32, bf16 and f16 at a width that leaves
    a part tile (1032): within 1e-5 (f32) or 2e-2 of the plain version; a
    token whose K rows are all sentinels gives an exact zero row; two calls
    give the same bits; a token's bits do not change when the other tokens'
    rows and weights change; indices and weights off 16-byte alignment (the
    scalar loads) give the same bits as aligned ones."""
    R, T, H = 64, 16, 1032
    recv = _rand((R, H), dt, hopper, 1.0, 34)
    gen = torch.Generator().manual_seed(35 + K)
    rows = torch.randint(0, R + 1, (T, K), generator=gen, dtype=torch.int32)
    rows[3] = R
    rows, w = rows.to(hopper), torch.rand((T, K), generator=gen).to(hopper)
    before = cg.launches
    got = cg.combine_gather_reduce(recv, rows, w)
    assert cg.launches == before + 1 and got.dtype == dt
    t = tol(torch.bfloat16 if dt == torch.float16 else dt)
    torch.testing.assert_close(got, ref.combine_gather_reduce(recv, rows, w), **t)
    assert not got[3].any()
    assert torch.equal(cg.combine_gather_reduce(recv, rows, w), got)
    rows2, w2 = rows.clone(), w.clone()
    keep = torch.arange(T, device=hopper) == 5
    rows2[~keep] = torch.randint(0, R + 1, (T - 1, K), generator=gen,
                                 dtype=torch.int32).to(hopper)
    w2[~keep] = torch.rand((T - 1, K), generator=gen).to(hopper)
    assert torch.equal(cg.combine_gather_reduce(recv, rows2, w2)[5], got[5])
    ibuf = torch.empty(T * K + 1, dtype=torch.int32, device=hopper)
    wbuf = torch.empty(T * K + 1, dtype=torch.float32, device=hopper)
    ibuf[1:].copy_(rows.flatten())
    wbuf[1:].copy_(w.flatten())
    off = cg.combine_gather_reduce(recv, ibuf[1:].view(T, K), wbuf[1:].view(T, K))
    assert torch.equal(off, got)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128, 256, 512, 1024, 104])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_quantize_fp8_every_block_width(hopper, block, dt):
    """B5 quantize at every block width of B1's lane-group kernel (8·2^k) and
    at 104, in f32, bf16 and f16, over 1, 40 and more rows than the
    persistent grid has blocks, with one all-zero block (scale 1.0): bitwise
    against its plain version and against dispatch_pack's quant mode
    through an identity map, bitwise between two calls; a source one
    element off 16-byte alignment (the one-warp route) gives the same bits."""
    H = 1040 if block == 104 else 2048
    more = torch.cuda.get_device_properties(hopper).multi_processor_count * 8 + 44
    for M in (1, 40, more):
        x = _rand((M, H), dt, hopper, 30.0, 40 + M)
        x[M // 2, block:2 * block] = 0.0
        q, s = fp8.quantize_fp8(x, block)
        wq, ws = ref.quantize_fp8(x, block)
        assert torch.equal(q.view(torch.uint8), wq.view(torch.uint8)) and torch.equal(s, ws)
        assert s[M // 2, 1].item() == 1.0
        ident = torch.arange(M, device=hopper, dtype=torch.int32).view(1, M)
        pq, ps = dp.dispatch_pack(x, ident, quant_block=block)
        assert torch.equal(pq[0].view(torch.uint8), q.view(torch.uint8)) and torch.equal(ps[0], s)
        q2, s2 = fp8.quantize_fp8(x, block)
        assert torch.equal(q2.view(torch.uint8), q.view(torch.uint8)) and torch.equal(s2, s)
        buf = torch.empty(M * H + 1, dtype=dt, device=hopper)
        off = buf[1:].view(M, H)
        off.copy_(x)
        assert off.data_ptr() % 16 != 0
        oq, os_ = fp8.quantize_fp8(off, block)
        assert torch.equal(oq.view(torch.uint8), q.view(torch.uint8)) and torch.equal(os_, s)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 4, 6, 8])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16,
                                torch.float8_e4m3fn])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_cuda_combine_reduce_any_k(hopper, K, dt, wdt):
    """B8 over K in {1, 4, 6, 8}, y in f32, bf16, f16 and fp8 (bf16 out),
    weights in f32 and bf16, at a width that leaves a part tile (1032):
    within 1e-5 (f32 out) or 2e-2 (bf16, f16) of the plain version; two
    calls give the same bits; a token's bits do not change when the other
    tokens' responses and weights change; with f32 weights and y in f32,
    bf16 or f16, the same bits as combine_gather_reduce over identity rows
    (the two share one reduce)."""
    T, H = 16, 1032
    gen = torch.Generator().manual_seed(50 + K)
    y = _rand((T, K, H), torch.float32, hopper, 1.0, 51 + K).to(dt)
    w = torch.rand((T, K), generator=gen).to(hopper).to(wdt)
    before = cr.launches
    got = cr.combine_reduce(y, w)
    out_dt = dt if dt != torch.float8_e4m3fn else torch.bfloat16
    assert cr.launches == before + 1 and got.dtype == out_dt
    t = tol(torch.float32 if dt == torch.float32 else torch.bfloat16)
    torch.testing.assert_close(got, ref.combine_reduce(y, w), **t)
    assert torch.equal(cr.combine_reduce(y, w), got)
    y2 = _rand((T, K, H), torch.float32, hopper, 1.0, 60 + K).to(dt)
    w2 = torch.rand((T, K), generator=gen).to(hopper).to(wdt)
    y2[5], w2[5] = y[5], w[5]
    assert torch.equal(cr.combine_reduce(y2, w2)[5], got[5])
    if wdt == torch.float32 and dt != torch.float8_e4m3fn:
        rows = torch.arange(T * K, device=hopper, dtype=torch.int32).view(T, K)
        assert torch.equal(cg.combine_gather_reduce(y.view(T * K, H), rows, w), got)
    torch.cuda.synchronize()


SERVE_LAYOUTS = {"nccl_ep": {}, "deepep_fp8": dict(ll_layout="deepep", quantize_dispatch=True),
                 "baseline": dict(ep_mode="baseline")}


def _serve_cfg(layout):
    """The smoke config at d_model 128 (fp8 blocks of 128) in ``layout``."""
    cfg = dataclasses.replace(smoke_config(), d_model=128)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **SERVE_LAYOUTS[layout]))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(SERVE_LAYOUTS))
def test_cuda_captured_decode_step_matches_eager(hopper, layout):
    """The fixed-batch server's captured step against its uncompiled step:
    the same tokens over prefill and decode, and after the capture no
    wrapper runs (the graph replays)."""
    cfg = _serve_cfg(layout)
    params = init_params(cfg, seed=0, device=hopper)
    prompts = torch.randint(0, cfg.vocab, (16, 4), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    toks = {}
    for mode in ("captured", "eager"):
        srv = DecodeServer(cfg, 16, 16, ep_size=8, params=params, device=hopper)
        if mode == "eager":
            srv._serve_step = srv._step_factory()
        first, _ = srv.prefill(prompts)
        before = gg.launches
        toks[mode], itls = srv.decode(first, 6)
        assert len(itls) == 6
        if mode == "captured":
            assert srv._serve_step.graph is not None and gg.launches == before
            assert srv.state["moe"].length.device.type == "cuda"
            assert int(srv.state["moe"].length) == 4 + 6
    assert np.array_equal(toks["captured"], toks["eager"])
    pipe = DecodeServer(cfg, 16, 16, ep_size=8, params=params, device=hopper,
                        pipeline_depth=2)
    got, itls = pipe.decode(pipe.prefill(prompts)[0], 6)
    assert np.array_equal(got, toks["eager"]) and len(itls) == 5


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(SERVE_LAYOUTS))
def test_cuda_captured_paged_step_matches_eager(hopper, layout):
    """The continuous server's captured step against its uncompiled step:
    every request's tokens equal, with requests joining and leaving."""
    cfg = _serve_cfg(layout)
    params = init_params(cfg, seed=0, device=hopper)
    rng = np.random.default_rng(2)
    spec = [(rng.integers(0, cfg.vocab, int(rng.integers(1, 6))), int(rng.integers(2, 6)),
             int(rng.integers(0, 4))) for _ in range(12)]
    toks = {}
    for mode in ("captured", "eager"):
        srv = ContinuousDecodeServer(cfg, 8, 16, ep_size=8, params=params, device=hopper,
                                     page_size=4)
        if mode == "eager":
            srv._serve_step = srv._step_factory()
        m = srv.serve_requests([Request(i, p, n, arrival_step=a)
                                for i, (p, n, a) in enumerate(spec)])
        assert m.requests_completed == len(spec)
        toks[mode] = [srv.reqsched.tokens_for(i) for i in range(len(spec))]
        if mode == "captured":
            assert srv._serve_step.graph is not None
    for a, b in zip(toks["captured"], toks["eager"]):
        assert np.array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(SERVE_LAYOUTS))
def test_cuda_decode_loop_two_streams_matches_naive(hopper, layout):
    """decode_loop on two streams against naive_decode_step, per
    micro-batch, bit for bit; then one steady-state pipelined step captured
    and replayed over a changed routing and a replayed one."""
    cfg = _serve_cfg(layout)
    params = init_params(cfg, seed=0, device=hopper)
    p = {k: v[0] for k, v in params["moe_stack"]["moe"].items()}
    T = 16
    group = ep_group(cfg, LocalComm(8), T)
    L, rcfg = group.local_experts, router_config(cfg.moe)

    def router_fn(x):
        r = route(x.float() @ p["router"], rcfg)
        return r.topk_idx, r.topk_weights

    def expert_fn(rank, y3d, counts):
        sl = slice(rank * L, (rank + 1) * L)
        return _expert_ffn(group, y3d, counts, p["w_gate"][sl], p["w_up"][sl], p["w_down"][sl])

    xs = [[[_rand((T, cfg.d_model), cfg.dtype, hopper, 1.0, 100 + 16 * s + 8 * m + r)
            for r in range(8)] for m in range(2)] for s in range(3)]
    xs.append(xs[1])                                     # a replayed step
    outs = decode_loop(group, router_fn, expert_fn, [tuple(x) for x in xs])
    want = [[naive_decode_step(group, router_fn, expert_fn, xs[s][m]) for m in range(2)]
            for s in range(4)]
    for s in range(4):
        for m in range(2):
            assert all(torch.equal(a, b) for a, b in zip(outs[s][m], want[s][m])), (s, m)
    handles = (_handle(group, router_fn, xs[0][0]), _handle(group, router_fn, xs[0][1]))
    xa = [x.clone() for x in xs[1][0]]
    xb = [x.clone() for x in xs[1][1]]
    side = capture_stream(hopper)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                        # the warm-up
        pipelined_decode_step(group, router_fn, expert_fn, handles, xa, xb)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        (oa, ob), _ = pipelined_decode_step(group, router_fn, expert_fn, handles, xa, xb)
    torch.cuda.current_stream().wait_stream(side)
    for s in (2, 0, 1):              # changed routings, and step 0's: the fast branch
        for dst, src in zip(xa + xb, xs[s][0] + xs[s][1]):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        for o, m in ((oa, 0), (ob, 1)):
            assert all(torch.equal(a, b) for a, b in zip(o, want[s][m])), (s, m)


@pytest.mark.gpu
def test_cuda_grouped_gemm_two_streams(hopper):
    """B3 at a stream-K decode shape on two streams at once: each stream's
    results equal its single-stream call, call after call."""
    L, A, H, F = 2, 128, 1024, 2048
    assert gg.plan(L, A, H, F).sk_tiles > 0
    xs = [_rand((L, A, H), torch.bfloat16, hopper, 1.0, 40 + i) for i in range(2)]
    ws = [_rand((L, H, F), torch.bfloat16, hopper, 0.05, 50 + i) for i in range(2)]
    cs = [torch.tensor([100, 37], dtype=torch.int32, device=hopper),
          torch.tensor([128, 5], dtype=torch.int32, device=hopper)]
    want = [gg.grouped_gemm(x, w, c) for x, w, c in zip(xs, ws, cs)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(gg.grouped_gemm(xs[i], ws[i], cs[i]))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(g, want[i]) for g in got[i])
    assert len([k for k in gg._sems if k[0] == torch.cuda.current_device()]) >= 3


@pytest.mark.gpu
@pytest.mark.parametrize("fp8", [False, True], ids=["bf16", "fp8"])
def test_cuda_hierarchical_ht_chunks_bitwise(hopper, fp8):
    """The hierarchical HT round trip over two pods of four on the card: 2
    and 4 chunks bitwise equal to 1 at zero drop (the combine's three sums
    are B4 gather-reduces over fixed-order maps, no scatter-add), and within
    2e-2 of the same path's plain version on the CPU."""
    from repro_torch.core import (EpGroupConfig, ep_combine, ep_create_group,
                                  ep_create_handle, ep_dispatch)
    E, K, T, H = 16, 4, 64, 256
    rng = np.random.default_rng(60)
    topk = np.stack([np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
                     for _ in range(8)]).astype(np.int32)
    w = rng.random((8, T, K)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    x = rng.standard_normal((8, T, H)).astype(np.float32)

    def run(nc, dev):
        cfg = EpGroupConfig(num_experts=E, max_tokens_per_rank=T, hidden=H, top_k=K,
                            mode="ht", ep_axis=("pod", "data"), ht_hierarchical=True,
                            ht_num_chunks=nc, quantize_dispatch=fp8)
        group = ep_create_group(cfg, LocalComm(8, axes=(("pod", 2), ("data", 4))))
        hs = ep_create_handle(group, [torch.from_numpy(a).to(dev) for a in topk],
                              [torch.from_numpy(a).to(dev) for a in w])
        recv = ep_dispatch(group, hs, [torch.from_numpy(a).to(dev, torch.bfloat16) for a in x])
        L = group.local_experts
        ys = [y * (1.0 + torch.arange(r * L, (r + 1) * L, device=dev)).to(y.dtype)[:, None, None]
              for r, (y, _) in enumerate(recv)]
        return recv, ep_combine(group, hs, ys)

    r1, o1 = run(1, hopper)
    for nc in (2, 4):
        rn, on = run(nc, hopper)
        assert all(torch.equal(a, b) and torch.equal(ca, cb) for (a, ca), (b, cb) in zip(r1, rn))
        assert all(torch.equal(a, b) for a, b in zip(o1, on))
    _, oc = run(1, torch.device("cpu"))
    for a, b in zip(o1, oc):
        torch.testing.assert_close(a.cpu().float(), b.float(), **tol(torch.bfloat16))


# --------------------------------------------------------------------------
# DeepSeek-V3: the absorbed-MLA shared pool, fp8 at its width, its servers
# --------------------------------------------------------------------------

def _kernel_names(fn) -> str:
    """The names of the kernels one call of ``fn`` ran on the card, joined."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return " ".join(e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)


_MLA_LENS = [1, 63, 64, 65, 255, 256, 257, 1040, 0]


def _mla_case(dev, Hq, dk, dt, seed, lens=_MLA_LENS, page=16, max_pages=68):
    """A shared pool of [ckv | k_rope] rows (dk wide) with every live page
    at a shuffled place, its table, q, and the mask of unreferenced pages."""
    B = len(lens)
    P = B * max_pages
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(seed))
    tbl = torch.full((B, max_pages), P, dtype=torch.int32)
    used = []
    for b in range(B):
        n = -(-lens[b] // page)
        tbl[b, :n] = perm[b * max_pages:b * max_pages + n].int()
        used += tbl[b, :n].tolist()
    kp = _rand((P + 1, page, 1, dk), dt, dev, 1.0, seed + 1)
    q = _rand((B, Hq, dk), dt, dev, 1.0, seed + 2)
    free = torch.ones(P + 1, dtype=torch.bool)
    free[used] = False
    return (q, kp, tbl.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev),
            free.to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("Hq", [64, 128])
def test_cuda_paged_decode_attention_deepseek_share_kv(hopper, Hq, splits):
    """B6 in its shared-pool mode at DeepSeek-V3's absorbed-MLA widths (64 or
    128 query heads on one bf16 pool of [ckv (512) | k_rope (64)] rows of
    pages of 16, dv 512) takes the tensor-core path (``paged_mla_kernel``):
    rows of 1 to 1040 tokens around the 64-token tile's edges, cut into up
    to 4 splits, and an idle row. Within 1e-4 of the plain version; the idle
    row exactly 0; the one-token row bitwise its pool row's first 512
    columns (p = 1 exactly); two calls bitwise equal; bitwise unchanged when
    every unreferenced page is drawn again, and when it holds NaN; a
    CUDA-graph replay bitwise equal to the eager call."""
    dv = 512
    q, kp, tbl, lens, free = _mla_case(hopper, Hq, 576, torch.bfloat16, 70 + Hq + splits)
    kw = dict(scale=192 ** -0.5, num_kv_splits=splits, dv=dv)

    def call():
        return da.paged_decode_attention(q, kp, None, tbl, lens, **kw)
    got = call()
    want = ref.paged_decode_attention(q, kp, None, tbl, lens, **kw)
    assert got.shape == (len(_MLA_LENS), Hq, dv)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert not got[-1].any()
    row = kp[tbl[0, 0].long(), 0, 0, :dv].float()
    assert torch.equal(got[0], row.expand(Hq, dv))
    assert torch.equal(call(), got)
    assert "paged_mla_kernel" in _kernel_names(call)
    kp[free] = _rand(kp[free].shape, torch.bfloat16, hopper, 50.0, 73)
    assert torch.equal(call(), got)
    kp[free] = float("nan")
    assert torch.equal(call(), got)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f32 pool", "40 heads"])
def test_cuda_paged_decode_attention_share_kv_generic_path(hopper, case):
    """Shared pools outside the tensor-core path's shapes keep the CUDA-core
    path (``paged_stage1_kernel``): an f32 pool at DeepSeek-V3's widths, and
    40 query heads (not a multiple of 64) in bf16. Within 1e-4 of the plain
    version, the idle row exactly 0."""
    dt, Hq = (torch.float32, 128) if case == "f32 pool" else (torch.bfloat16, 40)
    q, kp, tbl, lens, _ = _mla_case(hopper, Hq, 576, dt, 80)
    kw = dict(scale=192 ** -0.5, num_kv_splits=4, dv=512)

    def call():
        return da.paged_decode_attention(q, kp, None, tbl, lens, **kw)
    got = call()
    torch.testing.assert_close(got, ref.paged_decode_attention(q, kp, None, tbl, lens, **kw),
                               rtol=1e-4, atol=1e-4)
    assert not got[-1].any()
    ran = _kernel_names(call)
    assert "paged_stage1_kernel" in ran and "paged_mla_kernel" not in ran, ran
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_cuda_fp8_dispatch_and_recv_bitwise_deepseek_width(hopper, dt):
    """B1's quant mode and B2's fused dequant at H 7168 (56 blocks of 128),
    DeepSeek-V3's decode shapes: 16 tokens into [8, 16] slots with
    sentinels, an all-zero block; then the received rows into [32, 128]
    expert slots. Bitwise equal to the plain versions."""
    T, H, N, C = 16, 7168, 8, 16
    x = _rand((T, H), dt, hopper, 30.0, 74)
    x[3, 128:256] = 0.0
    gmap = torch.randint(0, T + 1, (N, C), device=hopper, dtype=torch.int32,
                         generator=torch.Generator(device=hopper).manual_seed(75))
    q, s = dp.dispatch_pack(x, gmap, quant_block=128)
    wq, ws = ref.dispatch_pack(x, gmap, 128)
    assert q.shape == (N, C, H) and s.shape == (N, C, 56)
    assert torch.equal(q.view(torch.uint8), wq.view(torch.uint8)) and torch.equal(s, ws)
    rows = N * C
    rmap = _mostly_sentinel_map((32, 128), rows, 0.03, 76).to(hopper)
    got = ru.recv_unpack(q.view(rows, H), rmap, s.view(rows, 56), out_dtype=torch.bfloat16)
    want = ref.recv_unpack(q.view(rows, H), rmap, s.view(rows, 56), torch.bfloat16)
    assert got.shape == (32, 128, H) and torch.equal(got, want)
    assert not got[rmap == rows].any()
    torch.cuda.synchronize()


def _deepseek_serve_cfg():
    """The DeepSeek-V3 smoke config at d_model 128 (fp8 blocks of 128) in
    the decode preset's layout: LL nccl_ep, fp8 dispatch."""
    from repro_torch.configs.deepseek_v3_671b import smoke_config as ds_smoke
    cfg = dataclasses.replace(ds_smoke(), d_model=128)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ep_mode="ll", ll_layout="nccl_ep", quantize_dispatch=True,
        expert_capacity_factor=2.0))


@pytest.mark.gpu
def test_cuda_deepseek_captured_servers_match_eager(hopper):
    """A DeepSeek-V3 smoke server (MLA, sigmoid group-limited routing, a
    shared expert, fp8 nccl_ep) captured against eager: the fixed-batch
    tokens bitwise equal, and every request of the continuous server over
    the MLA page pool (B6 in its shared-pool mode)."""
    cfg = _deepseek_serve_cfg()
    params = init_params(cfg, seed=0, device=hopper)
    prompts = torch.randint(0, cfg.vocab, (16, 4), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(77))
    rng = np.random.default_rng(78)
    spec = [(rng.integers(0, cfg.vocab, int(rng.integers(1, 6))), int(rng.integers(2, 6)),
             int(rng.integers(0, 4))) for _ in range(12)]
    toks, streams = {}, {}
    for mode in ("captured", "eager"):
        srv = DecodeServer(cfg, 16, 16, ep_size=8, params=params, device=hopper)
        csrv = ContinuousDecodeServer(cfg, 8, 16, ep_size=8, params=params, device=hopper,
                                      page_size=4)
        if mode == "eager":
            srv._serve_step = srv._step_factory()
            csrv._serve_step = csrv._step_factory()
        toks[mode], _ = srv.decode(srv.prefill(prompts)[0], 6)
        m = csrv.serve_requests([Request(i, p, n, arrival_step=a)
                                 for i, (p, n, a) in enumerate(spec)])
        assert m.requests_completed == len(spec)
        streams[mode] = [csrv.reqsched.tokens_for(i) for i in range(len(spec))]
        if mode == "captured":
            assert srv._serve_step.graph is not None and csrv._serve_step.graph is not None
            assert int(srv.state["moe"].length) == 4 + 6
        srv.close()
        csrv.close()
    assert np.array_equal(toks["captured"], toks["eager"])
    for a, b in zip(streams["captured"], streams["eager"]):
        assert np.array_equal(a, b)


# --------------------------------------------------------------------------
# one EP rank per process over NCCL: a spawned child per card
# --------------------------------------------------------------------------

NCCL_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int32": torch.int32,
               "fp8": torch.float8_e4m3fn}
NCCL_LAYOUTS = ("nccl_ep", "deepep_fp8")


def _nccl_layer(cfg, comm, router, w1, w3, w2):
    """The EP API over ``comm`` on one MoE layer as a CompiledStep step;
    the weights hold the hosted ranks' experts in rank order."""
    def step(params, state, batch):
        xs = list(batch["tokens"].unbind(0))
        group = ep_group(cfg, comm, xs[0].shape[0])
        L = group.local_experts
        rs = [route(x.float() @ router, router_config(cfg.moe)) for x in xs]
        hs = ep_create_handle(group, [r.topk_idx for r in rs], [r.topk_weights for r in rs])
        recv = ep_complete(group, hs, ep_dispatch(group, hs, xs, send_only=True))
        ys = [_expert_ffn(group, y, c, w1[i * L:(i + 1) * L], w3[i * L:(i + 1) * L],
                          w2[i * L:(i + 1) * L]) for i, (y, c) in enumerate(recv)]
        outs = ep_complete(group, hs, ep_combine(group, hs, ys, send_only=True))
        return torch.stack([o.to(xs[0].dtype) for o in outs]), state
    return step


def _nccl_rank(rank, world, init_method):
    """One rank over NCCL (cuda:rank): DistComm's primitives against
    LocalComm(world)'s on the same stacked inputs, and one EP layer of the
    smoke config (d_model 128, bf16) per layout, eager against LocalComm
    and captured against eager. Returns what the tests assert."""
    from repro_torch.comm import DistComm
    from repro_torch.launch.mesh import init_process
    axes = (("data", world),)
    dev = init_process(axes, None, init_method, rank=rank, world=world)
    disable_tf32()
    comm, lc = DistComm(axes), LocalComm(world)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, dt in NCCL_DTYPES.items():
        x = torch.randn((world, world, 8, 64), generator=gen, device=dev) * 4
        x = (x.to(torch.int32) if dt == torch.int32 else
             x.clamp(-448, 448).to(dt))
        as_bytes = (lambda t: t.view(torch.uint8) if t.dtype.itemsize == 1 else t)
        out["a2a", name] = torch.equal(as_bytes(comm.all_to_all([x[rank]])[0]),
                                       as_bytes(lc.all_to_all(list(x))[rank]))
        out["gather", name] = torch.equal(as_bytes(comm.all_gather([x[rank, 0]])[0]),
                                          as_bytes(lc.all_gather(list(x[:, 0]))[rank]))
        if name in ("f32", "int32"):
            got, want = comm.all_reduce([x[rank, 0]])[0], lc.all_reduce(list(x[:, 0]))[rank]
            out["reduce", name] = (torch.equal(got, want) if name == "int32" else
                                   torch.allclose(got, want, rtol=1e-6, atol=1e-5))
    cfg = dataclasses.replace(smoke_config(), d_model=128)
    E, D, Fe = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    w = [_rand(s, torch.bfloat16, dev, 0.1, seed=i + 1)
         for i, s in enumerate([(E, D, Fe), (E, D, Fe), (E, Fe, D)])]
    router = _rand((D, E), torch.float32, dev, seed=4)
    L = E // world
    mine = [t[rank * L:(rank + 1) * L].contiguous() for t in w]
    x = _rand((world, 16, D), torch.bfloat16, dev, seed=5)
    for layout in NCCL_LAYOUTS:
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep_mode="ll", ll_layout="deepep" if layout == "deepep_fp8" else layout,
            quantize_dispatch=layout.endswith("fp8")))
        want = _nccl_layer(c, lc, router, *w)(None, {}, {"tokens": x})[0][rank]
        eager = _nccl_layer(c, comm, router, *mine)(None, {}, {"tokens": x[rank:rank + 1]})[0][0]
        step, state, batch = (CompiledStep(_nccl_layer(c, comm, router, *mine)), {},
                              {"tokens": x[rank:rank + 1].clone()})
        first, _ = step(None, state, batch)
        replay, _ = step(None, state, batch)
        torch.cuda.synchronize()
        out["layer", layout] = dict(local=torch.equal(eager, want),
                                    warm_up=torch.equal(first[0], eager),
                                    replay=torch.equal(replay[0], eager),
                                    captured=step.graph is not None)
    out["continuous"] = _nccl_continuous(cfg, comm, dev, world)
    return out


def _nccl_continuous(cfg, comm, dev, world):
    """ContinuousDecodeServer over the NCCL DistComm, captured, requests
    joining and leaving: its streams and admission log; at world 1 (EP
    extent 1, the dense MoE path) also the dense-path server's streams on
    the same weights."""
    rng = np.random.default_rng(2)
    spec = [(rng.integers(0, cfg.vocab, int(rng.integers(1, 6))), int(rng.integers(2, 6)),
             int(rng.integers(0, 4))) for _ in range(12)]

    def serve(c, params):
        srv = ContinuousDecodeServer(cfg, 8, 16, comm=c, params=params, device=dev,
                                     page_size=4)
        m = srv.serve_requests([Request(i, p, n, arrival_step=a)
                                for i, (p, n, a) in enumerate(spec)])
        assert m.requests_completed == len(spec)
        toks = [srv.reqsched.tokens_for(i) for i in range(len(spec))]
        return toks, list(srv.reqsched.admissions), srv._serve_step.graph is not None

    toks, log, captured = serve(comm, init_params(cfg, seed=0, device=dev, comm=comm))
    out = dict(tokens=toks, admissions=log, captured=captured)
    if world == 1:
        want, want_log, _ = serve(None, init_params(cfg, seed=0, device=dev))
        out["dense_equal"] = (log == want_log
                              and all(np.array_equal(a, b) for a, b in zip(toks, want)))
    return out


@pytest.fixture(scope="module")
def nccl_ranks():
    """Every rank's results, one spawned process per card."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an NVIDIA sm_90 (Hopper) card")
    from repro_torch.launch.mesh import spawn
    return spawn(_nccl_rank, torch.cuda.device_count(), timeout=300)


@pytest.mark.gpu
@pytest.mark.parametrize("op,dtype", [(op, d) for op in ("a2a", "gather") for d in NCCL_DTYPES]
                         + [("reduce", "f32"), ("reduce", "int32")])
def test_cuda_nccl_primitives_match_local_comm(nccl_ranks, op, dtype):
    """DistComm over NCCL (world = the card count) against LocalComm on the
    same stacked inputs: bitwise (fp8 as bytes), f32 sums within rounding."""
    for r in nccl_ranks:
        assert r[op, dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", NCCL_LAYOUTS)
def test_cuda_nccl_ep_layer_captured(nccl_ranks, layout):
    """One EP layer over NCCL: bitwise against LocalComm(world) eagerly,
    captured by CompiledStep (NCCL's communicator made by the warm-up) and
    replayed bitwise."""
    for r in nccl_ranks:
        assert r["layer", layout] == dict(local=True, warm_up=True, replay=True,
                                          captured=True)


@pytest.mark.gpu
def test_cuda_nccl_continuous_server_captured(nccl_ranks):
    """ContinuousDecodeServer over NCCL, one process per card: captured,
    every rank's admission log the same; at world 1 its streams bitwise
    equal to the dense-path continuous server's."""
    for r in nccl_ranks:
        c = r["continuous"]
        assert c["captured"] and c["admissions"] == nccl_ranks[0]["continuous"]["admissions"]
        assert all(np.array_equal(a, b) for a, b in
                   zip(c["tokens"], nccl_ranks[0]["continuous"]["tokens"]))
    if len(nccl_ranks) == 1:
        assert nccl_ranks[0]["continuous"]["dense_equal"]


# ---- the training backward (grouped_gemm_dw, combine_gather_reduce_bwd,
# flash attention's LSE and its dQ / dK-dV pair, the autograd Functions)

def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,A,H,F,counts,nan", [
    (3, 136, 264, 200, (0, 65, 500), False),
    (2, 1024, 1024, 768, (1000, 1024), False),
    (4, 5120, 384, 520, (0, 63, 65, 4999), True),
    (2, 5120, 6144, 10752, (4100, 4235), False)],
    ids=["ragged", "tiles", "nan-past-counts", "dbrx"])
def test_cuda_grouped_gemm_dw(hopper, dt, L, A, H, F, counts, nan):
    """dW = Xᵀ·dY over each expert's live rows: f32 within 1e-5, bf16 within
    2e-2 per element and 5e-3 relative over the output (f32 sums in another
    order, one rounding); an expert with no live row gets zeros; two calls
    give the same bits. With ``nan``, x's rows past the counts (counts not
    multiples of 64, so the bf16 kernel's last stage of a tile holds them)
    are NaN and change nothing; NaN rows of dy past the counts change no
    bit either."""
    x = _rand((L, A, H), dt, hopper, 0.5, 11)
    dy = _rand((L, A, F), dt, hopper, 0.5, 12)
    c = torch.tensor(counts, device=hopper, dtype=torch.int32)
    dead = torch.arange(A, device=hopper)[None, :] >= c[:, None]
    if nan:
        x[dead] = float("nan")
    got = gg.grouped_gemm_dw(x, dy, c)
    want = ref.grouped_gemm_dw(x, dy, c)
    assert got.dtype == dt and got.shape == (L, H, F)
    torch.testing.assert_close(got, want, **tol(dt))
    assert _rel(got, want) < (5e-3 if dt == torch.bfloat16 else 1e-6)
    if counts[0] == 0:
        assert not got[0].any()
    assert torch.equal(gg.grouped_gemm_dw(x, dy, c), got)
    if nan:
        dy[dead] = float("nan")
        assert torch.equal(gg.grouped_gemm_dw(x, dy, c), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 4, 8])
def test_cuda_combine_gather_reduce_bwd(hopper, dt, K):
    """d_recv bitwise (one f32 product, one rounding), d_w within 1e-5
    relative (f32 sums in another order), the sentinel's d_w exactly 0 and
    unnamed rows exactly 0."""
    T, H = 37, 6144 // 4
    R = T * K + 5
    recv = _rand((R, H), dt, hopper, 1.0, 13)
    perm = torch.randperm(R, device=hopper)[:T * K].to(torch.int32).view(T, K)
    rows = torch.where(torch.rand((T, K), device=hopper) < 0.2, R, perm).to(torch.int32)
    w = torch.rand((T, K), device=hopper)
    dout = _rand((T, H), dt, hopper, 1.0, 14)
    d_recv, d_w = cg.combine_gather_reduce_bwd(recv, rows, w, dout)
    w_recv, w_w = ref.combine_gather_reduce_bwd(recv, rows, w, dout)
    assert torch.equal(d_recv, w_recv)
    torch.testing.assert_close(d_w, w_w, rtol=1e-5, atol=1e-3)
    assert not d_w[rows == R].any()
    named = torch.zeros(R, dtype=torch.bool, device=hopper)
    named[rows[rows < R].long()] = True
    assert not d_recv[~named].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,d", [(1, 128), (6, 128), (2, 64), (6, 64)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (False, None)])
def test_cuda_flash_attention_backward(hopper, dt, G, d, causal, window):
    """The forward's LSE within 1e-4 of the plain version's; the backward
    pair on the kernel's own output and LSE against the plain backward on
    the same: f32 within 1e-4 relative over each gradient, bf16 within 5e-3
    (the pair sums in f32 in another order and rounds P and dS to bf16
    before their products, then the output once); two calls bitwise
    equal."""
    _flash_backward_case(hopper, dt, 320, G, d, causal, window)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [200, 1000])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (False, None),
                                           (False, 100)])
def test_cuda_flash_attention_backward_ragged(hopper, dt, S, d, causal, window):
    """The same limits at lengths that end inside a tile of either kernel
    (128 query rows and keys, 64-row steps), G 6."""
    _flash_backward_case(hopper, dt, S, 6, d, causal, window)


def _flash_backward_case(hopper, dt, S, G, d, causal, window):
    B, Hkv = 2, 2
    Hq = Hkv * G
    q = _rand((B, S, Hq, d), dt, hopper, 1.0, 15)
    k = _rand((B, S, Hkv, d), dt, hopper, 1.0, 16)
    v = _rand((B, S, Hkv, d), dt, hopper, 1.0, 17)
    do = _rand((B, S, Hq, d), dt, hopper, 1.0, 18)
    kw = dict(scale=d ** -0.5, window=window, causal=causal)
    out, lse = fa.flash_attention_bshd(q, k, v, with_lse=True, **kw)
    t = [a.transpose(1, 2) for a in (q, k, v)]
    _, want_lse = ref.flash_attention_fwd(*t, **kw)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    want = ref.flash_attention_bwd(*t, out.transpose(1, 2), do.transpose(1, 2), lse, **kw)
    limit = 5e-3 if dt == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        assert _rel(g, w.transpose(1, 2)) < limit
    again = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.gpu
def test_cuda_kernel_entries_refuse_grad_outside_the_functions(hopper):
    """A kernel entry given a CUDA tensor that requires grad, with grad mode
    on, raises; under no_grad it runs; through kernels.autograd it runs and
    its backward matches the plain version's autograd."""
    from repro_torch.kernels import autograd as KA
    from repro_torch.kernels import ops
    L, A, H, F = 2, 64, 128, 96
    x = _rand((L, A, H), torch.float32, hopper, 0.5, 19).requires_grad_()
    w = _rand((L, H, F), torch.float32, hopper, 0.5, 20).requires_grad_()
    c = torch.tensor([40, 64], device=hopper, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.grouped_gemm(x, w, c)
    with torch.no_grad():
        ops.grouped_gemm(x, w, c)
    g = _rand((L, A, F), torch.float32, hopper, 1.0, 21)
    (KA.grouped_gemm(x, w, c) * g).sum().backward()
    x2, w2 = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    (ref.grouped_gemm(x2, w2, c) * g).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ht", "ll"])
def test_cuda_moe_block_gradients_match_plain(hopper, mode, monkeypatch):
    """moe_block over LocalComm(4) in f32 on the card: every gradient (x,
    router, the three expert weights) within 1e-4 relative of the same
    layer with every kernel entry routed to its plain version."""
    from repro_torch.kernels import ops
    cfg = smoke_config()
    cfg = dataclasses.replace(cfg, d_model=128, dtype=torch.float32,
                              moe=dataclasses.replace(cfg.moe, ep_mode=mode))
    p0 = init_params(cfg, 0, hopper)["moe_stack"]["moe"]
    p0 = {k: v[0] for k, v in p0.items()}
    x0 = _rand((8, 16, cfg.d_model), torch.float32, hopper, 1.0, 22)
    gy = _rand((8, 16, cfg.d_model), torch.float32, hopper, 1.0, 23)

    def grads():
        p = {k: v.clone().requires_grad_() for k, v in p0.items()}
        x = x0.clone().requires_grad_()
        y, aux = moe_block(p, x, cfg, LocalComm(4))
        ((y * gy).sum() + aux).backward()
        return [x.grad] + [p[k].grad for k in ("router", "w_gate", "w_up", "w_down")]

    got = grads()
    monkeypatch.setattr(ops, "_plain", lambda t: True)
    want = grads()
    for g, w in zip(got, want):
        assert g is not None and _rel(g, w) < 1e-4


@pytest.mark.gpu
def test_cuda_trained_parameters_serve(hopper):
    """The parameters ``Trainer.run`` returns on the card, served by the
    captured server as they are: none requires grad (the train step
    differentiates detached copies), and the tokens equal those served from
    fresh copies of their values."""
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = _serve_cfg("nccl_ep")
    params, _ = Trainer(cfg, TrainerConfig(steps=2, global_batch=8, seq_len=32),
                        comm=LocalComm(8), device=hopper).run()

    def tensors(tree):
        return [t for v in tree.values() for t in tensors(v)] if isinstance(tree, dict) \
            else [tree]

    def clone(tree):
        return {k: clone(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else tree.detach().clone()
    assert not any(t.requires_grad for t in tensors(params))
    prompts = torch.randint(0, cfg.vocab, (16, 4), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    toks = []
    for p in (params, clone(params)):
        srv = DecodeServer(cfg, 16, 16, ep_size=8, params=p, device=hopper)
        toks.append(srv.decode(srv.prefill(prompts)[0], 4)[0])
        assert srv._serve_step.graph is not None
    assert np.array_equal(*toks)


# the EP layouts whose backward the card runs: name -> group options (HT
# flat and LL nccl_ep share one backward)
EP_BWD_LAYOUTS = {
    "ht_flat": dict(mode="ht"),
    "deepep": dict(mode="ll", ll_layout="deepep"),
    "deepep_fp8": dict(mode="ll", ll_layout="deepep", quantize_dispatch=True),
    "baseline": dict(mode="baseline"),
    "hier": dict(mode="ht", ep_axis=("pod", "data"), ht_hierarchical=True, ht_num_chunks=2),
    "hier_fp8": dict(mode="ht", ep_axis=("pod", "data"), ht_hierarchical=True,
                     ht_num_chunks=2, quantize_dispatch=True),
}


def _ep_roundtrip_grads(opts, dev, x, topk, w, cot):
    """The EP round trip (dispatch, expert e scaling its rows by 1 + e,
    combine) under autograd over LocalComm(8) on ``dev``: the tokens' and
    the combine weights' gradients, stacked."""
    from repro_torch.core import EpGroupConfig, ep_create_group
    from repro_torch.core import ll as LL
    hier = opts.get("ht_hierarchical", False)
    comm = LocalComm(8, axes=(("pod", 2), ("data", 4)) if hier else None)
    cfg = EpGroupConfig(num_experts=16, max_tokens_per_rank=x.shape[1], hidden=x.shape[2],
                        top_k=4, payload_dtype=torch.float32, quant_block=128, **opts)
    group = ep_create_group(cfg, comm)
    assert group.hierarchical == hier
    xs = [a.to(dev).requires_grad_() for a in x]
    ws = [a.to(dev).requires_grad_() for a in w]
    hs = ep_create_handle(group, [a.to(dev) for a in topk], ws)
    recv = LL.ep_dispatch_autograd(group, hs, xs)
    L = group.local_experts
    ys = [y * (1.0 + torch.arange(r * L, (r + 1) * L, device=dev)).to(y.dtype)[:, None, None]
          for r, (y, _) in zip(comm.ranks, recv)]
    torch.autograd.backward(LL.ep_combine_autograd(group, hs, ys), [c.to(dev) for c in cot])
    return torch.stack([a.grad for a in xs]).cpu(), torch.stack([a.grad for a in ws]).cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(EP_BWD_LAYOUTS))
def test_cuda_ep_roundtrip_backward_matches_cpu(hopper, layout):
    """The EP round trip's backward in every layout on the card (B1, B2,
    B4 and combine_gather_reduce_bwd over the plan's maps) against the same
    round trip on the CPU's plain versions, f32 payload, 8 ranks of 64
    tokens, H 256: the tokens' and the combine weights' gradients within
    1e-5 relative, and the combine's backward kernel launched once a rank."""
    g = torch.Generator().manual_seed(40)
    N, T, H, E, K = 8, 64, 256, 16, 4
    x = torch.randn((N, T, H), generator=g)
    topk = torch.stack([torch.stack([torch.randperm(E, generator=g)[:K] for _ in range(T)])
                        for _ in range(N)]).to(torch.int32)
    w = torch.softmax(torch.randn((N, T, K), generator=g), -1)
    cot = torch.randn((N, T, H), generator=g)
    opts = EP_BWD_LAYOUTS[layout]
    before = cg.bwd_launches
    got = _ep_roundtrip_grads(opts, hopper, x, topk, w, cot)
    assert cg.bwd_launches - before == N
    want = _ep_roundtrip_grads(opts, torch.device("cpu"), x, topk, w, cot)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-5


@pytest.mark.gpu
def test_cuda_mla_chunked_backward_matches_the_loop(hopper):
    """``MlaChunked`` at DeepSeek-V3's train_4k widths on the card (one row
    of 4096 tokens, 128 heads, nope 128, rope 64, kv_lora 512, v 128, chunk
    1024, bf16): its forward bitwise the plain loop's; each gradient within
    2e-2 of its largest value of autograd through the loop (both sum in f32
    from the same bf16 inputs, in another order); its peak above the inputs
    at most a third of the loop's."""
    from repro_torch.models import mla
    S, H, dn, dr, r, dv, chunk = 4096, 128, 128, 64, 512, 128, 1024
    scale = (dn + dr) ** -0.5
    # unit queries, keys and latents; the up-projections at init scale
    shapes = [((1, S, H, dn), 1.0), ((1, S, H, dr), 1.0), ((1, S, r), 1.0), ((1, S, dr), 1.0),
              ((r, H, dn), r ** -0.5), ((r, H, dv), r ** -0.5)]
    ins = [_rand(s, torch.bfloat16, hopper, sc, seed=i) for i, (s, sc) in enumerate(shapes)]
    cot = _rand((1, S, H, dv), torch.bfloat16, hopper, seed=9).float()

    def loop(qn, qr, ck, kr, wk, wv):
        return mla._mla_chunked({"wk_b": wk, "wv_b": wv}, qn, qr, ck, kr, scale,
                                torch.bfloat16, chunk=chunk)

    def fn(*a):
        return mla.MlaChunked.apply(*a, scale, torch.bfloat16, chunk)
    with torch.no_grad():
        assert torch.equal(fn(*ins), loop(*ins))
    out = {}
    for name, f in (("loop", loop), ("fn", fn)):
        xs = [t.clone().requires_grad_() for t in ins]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        f(*xs).backward(cot)
        torch.cuda.synchronize()
        out[name] = ([t.grad for t in xs], torch.cuda.max_memory_allocated() - base)
        del xs
    for a, b in zip(out["fn"][0], out["loop"][0]):
        assert a.dtype == b.dtype
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * float(b.float().abs().max())
    assert out["fn"][1] <= out["loop"][1] / 3
