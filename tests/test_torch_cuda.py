"""The hand-written Hopper kernels against their plain versions, on the card.

Every test here needs an sm_90 card and skips elsewhere. The file imports
nothing of JAX, so it runs on a machine without it; ``tests/conftest.py``
imports JAX, hence the command (see README):

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_cuda.py

Data movement (pack, unpack, fp8) must match bit for bit; the GEMM and the
reduce within 1e-5 (f32) or 2e-2 (bf16), since the sums run in another order.
"""
import dataclasses

import pytest
import torch

from repro_torch.comm import LocalComm
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.device import disable_tf32
from repro_torch.kernels import combine_gather_reduce as cg
from repro_torch.kernels import dispatch_pack as dp
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels import recv_unpack as ru
from repro_torch.kernels import ref
from repro_torch.models.moe import _moe_dense_fallback, moe_block
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
