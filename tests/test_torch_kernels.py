"""The port's EP kernels against the JAX package.

CPU: each plain version in ``repro_torch.kernels.ref`` (which ``ops`` runs
for CPU tensors) against the JAX function of the same name on the same numpy
inputs, both through JAX's plain path and through its Pallas kernels in
interpret mode at H=256. Data movement and fp8 match bit for bit; the GEMM
and the reduce within 1e-5 (f32) or 2e-2 (bf16), ``tests/test_kernels.py``'s
tolerances, since the sums run in another order. The hand-written kernels
are held against these plain versions on the card in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import slots as jslots
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import slots as tslots
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" else dict(rtol=1e-5, atol=1e-5)


def to_np(t):
    """Torch or JAX array -> numpy: fp8 as raw bytes, other floats as f32."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.float8_e4m3fn:
            return t.view(torch.uint8).numpy()
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    a = np.asarray(t)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def pair(a, name="f32"):
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


@pytest.fixture(params=["ref", "interpret"])
def jax_path(request, monkeypatch):
    """JAX through its plain path, or through its Pallas kernels in
    interpret mode (set for this test only)."""
    if request.param == "interpret":
        monkeypatch.setenv("REPRO_FORCE_PALLAS", "interpret")
    else:
        monkeypatch.setenv("REPRO_FORCE_PALLAS", "off")
    return request.param


@pytest.mark.parametrize("M,D", [(0, 4), (37, 5), (256, 16)])
def test_positions_by_dest(M, D):
    rng = np.random.default_rng(M)
    dest = rng.integers(-1, D + 2, M).astype(np.int32)   # out-of-range included
    valid = rng.random(M) < 0.7
    want_o = jref.positions_by_dest(jnp.asarray(dest), D, jnp.asarray(valid))
    want_s = jslots.positions_by_dest(jnp.asarray(dest), D, jnp.asarray(valid))
    td, tv = torch.from_numpy(dest), torch.from_numpy(valid)
    for got in (tref.positions_by_dest(td, D, tv), tslots.positions_by_dest(td, D, tv)):
        for g, w_o, w_s in zip(got, want_o, want_s):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_o))
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_s))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_combine_reduce(dt):
    rng = np.random.default_rng(1)
    jy, ty = pair(rng.standard_normal((8, 4, 256)), dt)
    jw, tw = pair(rng.random((8, 4)))
    np.testing.assert_allclose(to_np(tref.combine_reduce(ty, tw)),
                               to_np(jref.combine_reduce(jy, jw)), **tol(dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_combine_gather_reduce(dt, jax_path):
    rng = np.random.default_rng(2)
    R, T, K, H = 24, 8, 4, 256
    jr, tr = pair(rng.standard_normal((R, H)), dt)
    rows = rng.integers(0, R + 1, (T, K)).astype(np.int32)    # R == sentinel
    jw, tw = pair(rng.random((T, K)))
    got = tops.combine_gather_reduce(tr, torch.from_numpy(rows), tw)
    want = jops.combine_gather_reduce(jr, jnp.asarray(rows), jw)
    assert got.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(to_np(got), to_np(want), **tol(dt))


@pytest.mark.parametrize("block", [128, 64])
def test_quantize_dequantize_fp8_bitwise(block):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 256)) * rng.choice([1e-3, 1.0, 300.0], (6, 1))
    x[2, :block] = 0.0                                      # all-zero block -> scale 1
    jx, tx = pair(x)
    tq, ts = tref.quantize_fp8(tx, block)
    jq, js = jref.quantize_fp8(jx, block)
    np.testing.assert_array_equal(to_np(tq), to_np(jq))
    np.testing.assert_array_equal(to_np(ts), to_np(js))
    for name in DTYPES:
        np.testing.assert_array_equal(
            to_np(tref.dequantize_fp8(tq, ts, DTYPES[name][1])),
            to_np(jref.dequantize_fp8(jq, js, DTYPES[name][0])))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dispatch_pack_copy_bitwise(dt, jax_path):
    rng = np.random.default_rng(4)
    T, H, N, C = 16, 256, 4, 8
    jx, tx = pair(rng.standard_normal((T, H)), dt)
    gmap = rng.integers(0, T + 1, (N, C)).astype(np.int32)   # T == sentinel
    for out in (None, "bf16"):
        od = (None, None) if out is None else DTYPES[out]
        got, _ = tops.dispatch_pack(tx, torch.from_numpy(gmap), out_dtype=od[1])
        want, _ = jops.dispatch_pack(jx, jnp.asarray(gmap), out_dtype=od[0])
        np.testing.assert_array_equal(to_np(got), to_np(want))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dispatch_pack_quant_bitwise(dt, jax_path):
    rng = np.random.default_rng(5)
    T, H, N, C = 8, 256, 4, 8
    x = rng.standard_normal((T, H)) * 20
    x[3] = 0.0
    jx, tx = pair(x, dt)
    gmap = rng.integers(0, T + 1, (N, C)).astype(np.int32)
    gmap[0, 0] = T
    tq, ts = tops.dispatch_pack(tx, torch.from_numpy(gmap), quant_block=128)
    jq, js = jops.dispatch_pack(jx, jnp.asarray(gmap), quant_block=128)
    assert to_np(ts)[0, 0].tolist() == [1.0, 1.0]            # sentinel: unit scale
    if jax_path == "ref":
        np.testing.assert_array_equal(to_np(tq), to_np(jq))
        np.testing.assert_array_equal(to_np(ts), to_np(js))
        return
    # JAX's Pallas quant kernel, traced whole, lets XLA turn amax/448 into a
    # multiply, so its scales may sit one ulp off its own plain version; the
    # JAX suite holds it to that version at these tolerances, and so do we
    np.testing.assert_allclose(to_np(ts), to_np(js), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        to_np(tref.dequantize_fp8(tq, ts, torch.float32)),
        to_np(jref.dequantize_fp8(jq, js, jnp.float32)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_recv_unpack_copy_bitwise(dt, jax_path):
    rng = np.random.default_rng(6)
    R, H = 20, 256
    jr, tr = pair(rng.standard_normal((R, H)), dt)
    gmap = rng.integers(0, R + 1, (2, 16)).astype(np.int32)  # R == sentinel
    got = tops.recv_unpack(tr, torch.from_numpy(gmap))
    want = jops.recv_unpack(jr, jnp.asarray(gmap))
    np.testing.assert_array_equal(to_np(got), to_np(want))


def test_recv_unpack_dequant_bitwise(jax_path):
    rng = np.random.default_rng(7)
    R, H = 20, 256
    tq, ts = tref.quantize_fp8(torch.from_numpy(rng.standard_normal((R, H))).float())
    # both sides unpack the same fp8 payload
    jq = jnp.asarray(tq.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
    js = jnp.asarray(ts.numpy())
    gmap = rng.integers(0, R + 1, (2, 16)).astype(np.int32)
    for name in DTYPES:
        got = tops.recv_unpack(tq, torch.from_numpy(gmap), ts, DTYPES[name][1])
        want = jops.recv_unpack(jq, jnp.asarray(gmap), js, DTYPES[name][0])
        np.testing.assert_array_equal(to_np(got), to_np(want))
    sentinel = tops.recv_unpack(tq, torch.full((1, 3), R, dtype=torch.int32), ts)
    assert sentinel.dtype == torch.bfloat16 and not sentinel.float().any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_grouped_gemm(dt, jax_path):
    rng = np.random.default_rng(8)
    L, A, H, F = 2, 128, 256, 128
    jx, tx = pair(rng.standard_normal((L, A, H)) * 0.1, dt)
    jw, tw = pair(rng.standard_normal((L, H, F)) * 0.1, dt)
    counts = np.array([37, 0], np.int32)
    got = tops.grouped_gemm(tx, tw, torch.from_numpy(counts))
    want = jops.grouped_gemm(jx, jw, jnp.asarray(counts))
    assert got.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(to_np(got), to_np(want), **tol(dt))
    assert not to_np(got)[0, 37:].any() and not to_np(got)[1].any()


def e4m3_codes(q):
    """fp8 bytes -> (sign, magnitude code): e4m3 codes grow with |value|,
    so two values one e4m3 step apart have magnitude codes one apart."""
    b = to_np(q).astype(np.int32)
    return b >> 7, b & 0x7F


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_dequantize_fp8_against_pallas(dt, jax_path):
    """The standalone fp8 pair (B5) through the port's routing against
    JAX's, plain or Pallas in interpret mode ([64, 256], block 128, so the
    kernels run). Against the plain version: bitwise. Against the
    interpret-mode quantize kernel, whose scales sit up to one ulp off its
    own plain version: scales within 2e-7 relative, every fp8 value within
    one e4m3 step, and so the round trip within one step times the scale.
    Dequantizing the same payload is bitwise either way. That some scales
    do differ pins the reference's fault (ROADMAP Queue C)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((64, 256)) * 20
    x[5, :128] = 0.0                                        # all-zero block -> scale 1
    jx, tx = pair(x, dt)
    tq, ts = tops.quantize_fp8(tx, 128)
    jq, js = jops.quantize_fp8(jx, 128)
    assert ts[5, 0].item() == 1.0 and not to_np(tq)[5, :128].any()
    if jax_path == "ref":
        np.testing.assert_array_equal(to_np(tq), to_np(jq))
        np.testing.assert_array_equal(to_np(ts), to_np(js))
    else:
        np.testing.assert_allclose(to_np(ts), to_np(js), rtol=2e-7, atol=0)
        assert (to_np(ts) != to_np(js)).any()
        (ts_sign, t_mag), (j_sign, j_mag) = e4m3_codes(tq), e4m3_codes(jq)
        assert np.all((ts_sign == j_sign) | (t_mag == 0) | (j_mag == 0))
        assert np.abs(t_mag - j_mag).max() <= 1
        t_rt = to_np(tref.dequantize_fp8(tq, ts, torch.float32))
        j_rt = to_np(jref.dequantize_fp8(jq, js, jnp.float32))
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(t_rt), np.abs(j_rt))
                                        / np.repeat(to_np(ts), 128, -1) + 1e-30)) - 3)
        step = np.maximum(step, 2.0 ** -9) * np.repeat(to_np(ts), 128, -1)
        assert np.all(np.abs(t_rt - j_rt) <= step * (1 + 1e-6))
    # both sides dequantize the port's payload
    jq_same = jnp.asarray(to_np(tq)).view(jnp.float8_e4m3fn)
    for name in DTYPES:
        np.testing.assert_array_equal(
            to_np(tops.dequantize_fp8(tq, ts, DTYPES[name][1])),
            to_np(jops.dequantize_fp8(jq_same, jnp.asarray(to_np(ts)), DTYPES[name][0])))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_combine_reduce_against_pallas(dt, jax_path):
    """B8 through the port's routing against JAX's, plain or Pallas in
    interpret mode ([16, 4, 256]): within 1e-6 in f32 (the sums run in
    another order), 2e-2 in bf16."""
    rng = np.random.default_rng(10)
    jy, ty = pair(rng.standard_normal((16, 4, 256)), dt)
    jw, tw = pair(rng.random((16, 4)))
    got = tops.combine_reduce(ty, tw)
    want = jops.combine_reduce(jy, jw)
    assert got.dtype == DTYPES[dt][1]
    t = dict(rtol=1e-6, atol=1e-6) if dt == "f32" else tol(dt)
    np.testing.assert_allclose(to_np(got), to_np(want), **t)


@pytest.mark.parametrize("H,rdt,odt,ptrs,want", [
    (6144, torch.bfloat16, torch.bfloat16, (0, 4096), 1),       # the decode recv
    (6144, torch.float8_e4m3fn, torch.float8_e4m3fn, (16, 32), 1),
    (6152, torch.float8_e4m3fn, torch.float8_e4m3fn, (16, 32), 0),  # 8 + 16k bytes
    (6152, torch.float8_e4m3fn, torch.bfloat16, (16, 32), 1),   # converts 8 at a time
    (48, torch.float32, torch.float32, (0, 0), 1),
    (5, torch.bfloat16, torch.bfloat16, (0, 0), 0),             # any width
    (6144, torch.bfloat16, torch.bfloat16, (2, 0), 0),          # unaligned rows
    (6144, torch.bfloat16, torch.float32, (0, 8), 0),
])
def test_recv_unpack_copy_route(H, rdt, odt, ptrs, want):
    """B2's copy takes the row gather it shares with B1 only where that
    kernel's 16-byte pieces fit the rows; otherwise it goes element by
    element."""
    from repro_torch.kernels import recv_unpack as tru
    assert tru.copy_route(H, rdt, odt, *ptrs) == want


@pytest.mark.parametrize("blk,odt,recv_ptr,out_ptr,want", [
    (128, torch.bfloat16, 0, 0, 16), (128, torch.float16, 16, 32, 16),
    (128, torch.float32, 0, 0, 8), (128, torch.bfloat16, 8, 0, 8),
    (104, torch.bfloat16, 0, 0, 8), (104, torch.float32, 16, 0, 8),
    (64, torch.bfloat16, 4, 0, 1), (12, torch.bfloat16, 0, 0, 1),
    (128, torch.bfloat16, 0, 8, 1), (16, torch.bfloat16, 16, 16, 16),
    (8, torch.bfloat16, 8, 16, 8),
])
def test_recv_unpack_dequant_piece(blk, odt, recv_ptr, out_ptr, want):
    """B2's dequant reads 16 payload bytes a thread-step where the quant
    block, the payload's alignment and a 2-byte output allow it (DBRX's
    block of 128 into bf16), 8 where only that fits (a block of 104, an f32
    output), else one at a time; a misaligned output takes the element
    route."""
    from repro_torch.kernels import recv_unpack as tru
    assert tru.dequant_piece(blk, odt, recv_ptr, out_ptr) == want


def test_combine_gather_reduce_decode_grid_fills_the_card():
    """B4's blocks (``GR_THREADS`` 16-byte pieces each, one token; the
    reduce it shares with B8, ``csrc/reduce.cuh``) number at least the
    H100's 132 SMs at DBRX's decode combine (16 tokens, H 6144 bf16)."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "reduce.cuh").read_text()
    threads = int(re.search(r"constexpr int GR_THREADS = (\d+);", src).group(1))
    pieces = 6144 * 2 // 16
    assert 16 * -(-pieces // threads) >= 132


@pytest.mark.parametrize("block", [8, 16, 32, 64, 128, 256, 512, 1024, 104])
def test_quantize_fp8_row_split(block):
    """B5's launch quantizes [M, H] as [M·p, H/p], the same bytes: p divides
    the row's H/block quant blocks, a part keeps one round of the 256-thread
    block (max(2048, 8·block) elements), p is 1 once M fills the 132 SMs,
    and a split stops growing once M·p does. At DBRX's decode (16 rows of
    6144, block 128) a row is cut in 3 parts of 2048."""
    from repro_torch.kernels import fp8 as tfp8
    sms = 132
    for H in (6144, 2048, 1040, 520):
        if H % block:
            continue
        nblk = H // block
        for M in (1, 16, 40, 131, 132, 4096):
            p = tfp8.row_split(M, H, block, sms)
            assert nblk % p == 0
            assert p == 1 or H // p >= max(2048, 8 * block)
            if M >= sms:
                assert p == 1
            # no larger divisor with a whole round would have been needed
            bigger = [d for d in range(p + 1, nblk + 1)
                      if nblk % d == 0 and H // d >= max(2048, 8 * block)]
            assert not bigger or M * p >= sms
    assert tfp8.row_split(16, 6144, 128, sms) == 3
    assert tfp8.row_split(4096, 6144, 128, sms) == 1
