"""The four-card DeepSeek-V3 continuous check's reference
(``chip_smoke.blocked_step0_logits``): the first step over ``LocalComm(4)``
fed one batch rank's rows at a time, so that its dense products see a
``DistComm`` process's row count. On the CPU in f32, at DeepSeek-V3's smoke
config with fp8 ``nccl_ep`` dispatch (the decode preset's layout), it must
equal the whole-batch step (``chip_smoke.continuous_step0_logits``)
bitwise: the same function, only the row counts differ. Its products are
counted by ``chip_smoke.ProductShapes``: per block, every bf16 or f32
product of the attention, the shared expert and the head runs at the
block's rows.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as CS  # noqa: E402
from repro_torch.comm import LocalComm  # noqa: E402
from repro_torch.configs.deepseek_v3_671b import smoke_config  # noqa: E402
from repro_torch.models.kv_pages import pages_for_tokens  # noqa: E402
from repro_torch.weights import init_params  # noqa: E402

EP, BLOCKS = 4, 4
DS_MOE = dict(ep_mode="ll", ll_layout="nccl_ep", quantize_dispatch=True,
              expert_capacity_factor=2.0, capacity_factor=None)


def test_blocked_reference_equals_whole_batch_bitwise():
    cfg = dataclasses.replace(smoke_config(), dtype=torch.float32, d_model=128)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **DS_MOE))
    params = init_params(cfg, 0, "cpu")
    reqs = CS.make_requests(cfg.vocab, 256)
    s = max(int(cfg.attn.decode_kv_splits), 1)
    max_pages = -(-pages_for_tokens(CS.CMAX_LEN, CS.PAGE) // s) * s
    table = (max_pages, CS.BATCH * max_pages)
    feed = CS.continuous_step0_feed(reqs, table)
    assert 0 < int(feed["active"].sum()) < CS.BATCH          # live and idle rows
    with CS.ProductShapes() as whole_p:
        whole = CS.continuous_step0_logits(cfg, params, LocalComm(EP), "cpu", reqs, table)
    with CS.ProductShapes() as blocked_p:
        blocked = CS.blocked_step0_logits(cfg, params, EP, "cpu", reqs, table, BLOCKS)
    assert blocked.shape == whole.shape == (CS.BATCH, cfg.vocab)
    assert bool(torch.isfinite(whole).all())
    assert torch.equal(blocked, whole)
    rows = CS.BATCH // BLOCKS
    # every product runs once per block, at a quarter of the rows (the
    # router's at the hosted ranks' rows: BATCH / EP whole, rows / EP blocked)
    assert sum(blocked_p.rows().values()) == BLOCKS * sum(whole_p.rows().values())
    assert {r // BLOCKS: n * BLOCKS for r, n in whole_p.rows().items()} == blocked_p.rows()
    assert CS.BATCH in whole_p.rows() and CS.BATCH not in blocked_p.rows()
    assert rows // EP in blocked_p.rows() and CS.BATCH // EP in whole_p.rows()
    line = CS.product_line({"whole": whole_p, "blocked": blocked_p})
    assert f"{CS.BATCH} rows" in line and np.isfinite(blocked.numpy()).all()
