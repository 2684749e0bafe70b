"""Package boundaries of the port: it imports nothing of JAX or the JAX
package, its entry points need a CUDA device unless handed the CPU, and its
kernel routing sends CPU tensors to the plain versions only."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.kernels import dispatch_pack as dp_mod
from repro_torch.kernels import grouped_gemm as gg_mod
from repro_torch.kernels import ops, ref
from repro_torch.runtime.server import DecodeServer
from repro_torch.weights import init_params

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.runtime.server, repro_torch.weights\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.configs.dbrx_132b, repro_torch.core.api\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_unless_given_cpu(no_cuda):
    cfg = smoke_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeServer(cfg, batch=8, max_len=8, ep_size=8)
    with pytest.raises(RuntimeError, match="not available"):
        init_params(cfg, device="cuda")
    params = init_params(cfg, seed=1, device="cpu")
    assert params["embed"].device.type == "cpu"
    srv = DecodeServer(cfg, batch=8, max_len=8, ep_size=8, params=params,
                       device="cpu")
    toks, itls = srv.decode(srv.prefill(torch.zeros((8, 2), dtype=torch.int32))[0], 2)
    assert toks.shape == (8, 3) and len(itls) == 2


def test_unported_options_raise():
    import dataclasses
    cfg = smoke_config()
    with pytest.raises(NotImplementedError, match="A6"):
        DecodeServer(cfg, batch=8, max_len=8, device="cpu", pipeline_depth=2)
    heat = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, track_expert_heat=True))
    with pytest.raises(NotImplementedError, match="A10"):
        DecodeServer(heat, batch=8, max_len=8, device="cpu")
    ht = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_mode="ht"))
    srv = DecodeServer(ht, batch=8, max_len=8, ep_size=8, device="cpu")
    with pytest.raises(NotImplementedError, match="A5"):
        srv.prefill(torch.zeros((8, 1), dtype=torch.int32))


def test_cpu_tensors_take_the_plain_versions():
    dp_mod.launches = gg_mod.launches = 0
    x = torch.randn(6, 16)
    gmap = torch.tensor([[0, 6, 2], [5, 1, 6]], dtype=torch.int32)
    got, _ = ops.dispatch_pack(x, gmap)
    assert torch.equal(got, ref.dispatch_pack(x, gmap)[0])
    xs, w = torch.randn(2, 8, 16), torch.randn(2, 16, 8)
    counts = torch.tensor([3, 8], dtype=torch.int32)
    assert torch.equal(ops.grouped_gemm(xs, w, counts), ref.grouped_gemm(xs, w, counts))
    assert dp_mod.launches == gg_mod.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        dp_mod.dispatch_pack(x, gmap)          # the kernel wrapper never runs on CPU
