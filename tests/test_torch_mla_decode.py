"""B6's shared-pool mode at DeepSeek-V3's absorbed-MLA widths, on the CPU.

The port's plain ``paged_decode_attention`` with ``v_pages=None`` (values the
leading ``dv`` columns of each [ckv | k_rope] row) against the JAX package's
plain version and its Pallas kernel in interpret mode, at the full head
widths the card's tensor-core path serves: 128 query heads, dk 576 (512 +
64), dv 512, pages of 16. Inputs come from a numpy seed; f32 throughout,
held to 1e-5 (the sums run in another order). The kernel itself is held
against this plain version on the card in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as JDA
from repro.kernels import ref as JREF
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

HQ, DK, DV, PAGE, MAX_PAGES = 128, 576, 512, 16, 20
LENS = [1, 64, 65, 300, 0]
F32 = dict(rtol=1e-5, atol=1e-5)


def mla_case(seed):
    """q [5, 128, 576], a shared pool of [ckv | k_rope] rows with garbage in
    every unreferenced page (the pad page included), a shuffled page table."""
    rng = np.random.default_rng(seed)
    B = len(LENS)
    P = B * MAX_PAGES
    pool = rng.standard_normal((P + 1, PAGE, 1, DK)).astype(np.float32)
    perm = rng.permutation(P)
    tbl = np.full((B, MAX_PAGES), P, np.int32)
    for b, n in enumerate(LENS):
        pages = -(-n // PAGE)
        tbl[b, :pages] = perm[b * MAX_PAGES:b * MAX_PAGES + pages]
    q = rng.standard_normal((B, HQ, DK)).astype(np.float32)
    return q, pool, tbl, np.asarray(LENS, np.int32)


@pytest.mark.parametrize("splits", [1, 4])
def test_plain_shared_pool_matches_jax_at_deepseek_widths(splits):
    """The plain shared-pool version within 1e-5 of JAX's plain version and
    of its Pallas kernel in interpret mode; the idle row exactly 0; the
    one-token row is its pool row's first 512 columns for every head."""
    q, pool, tbl, lens = mla_case(90 + splits)
    kw = dict(scale=(128 + 64) ** -0.5, num_kv_splits=splits, dv=DV)
    t = [torch.from_numpy(a) for a in (q, pool, tbl, lens)]
    got = tops.paged_decode_attention(t[0], t[1], None, t[2], t[3], **kw)
    assert got.dtype == torch.float32 and got.shape == (len(LENS), HQ, DV)
    j = [jnp.asarray(a) for a in (q, pool, tbl, lens)]
    np.testing.assert_allclose(got.numpy(), np.asarray(
        JREF.paged_decode_attention(j[0], j[1], None, j[2], j[3], **kw)), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        JDA.paged_decode_attention(j[0], j[1], None, j[2], j[3], **kw, interpret=True)), **F32)
    assert not got[4].any()
    np.testing.assert_allclose(got[0].numpy(),
                               np.broadcast_to(pool[tbl[0, 0], 0, 0, :DV], (HQ, DV)), **F32)
    o, lse = tref.paged_decode_stage1(t[0], t[1], None, t[2], t[3], **kw)
    jo, jlse = JREF.paged_decode_stage1(j[0], j[1], None, j[2], j[3], **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **F32)
    assert tda.launches == 0                       # CPU tensors never reach the kernel
