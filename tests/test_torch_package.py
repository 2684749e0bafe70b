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
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.server import ContinuousDecodeServer, DecodeServer
from repro_torch.weights import init_params

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def test_port_imports_no_jax():
    """Every module of the package, found by walking it, imports nothing of
    JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "assert 'repro_torch.runtime.scheduler' in sys.modules, mods\n"
        "assert {'repro_torch.launch.mesh', 'repro_torch.launch.serve'} <= set(sys.modules), mods\n"
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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousDecodeServer(cfg, batch=8, max_len=8, ep_size=8, page_size=4)
    csrv = ContinuousDecodeServer(cfg, batch=8, max_len=8, ep_size=8, params=params,
                                  device="cpu", page_size=4)
    m = csrv.serve_requests([Request(0, [1, 2], 3)])
    assert m.requests_completed == 1 and len(csrv.reqsched.tokens_for(0)) == 3


def test_unported_options_raise():
    import dataclasses
    cfg = smoke_config()
    # expert heat and EPLB serve since their slice landed; fault tolerance
    # is refused until its own (ROADMAP A10b)
    heat = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, track_expert_heat=True))
    with pytest.raises(NotImplementedError, match="A10b"):
        DecodeServer(heat, batch=8, max_len=8, device="cpu", fault_injector=object())
    with pytest.raises(NotImplementedError, match="A10b"):
        ContinuousDecodeServer(heat, batch=8, max_len=8, device="cpu", page_size=4,
                               ckpt_dir="ckpt")
    assert "expert_heat" in DecodeServer(heat, batch=8, max_len=8, device="cpu").state
    # the baseline dispatcher was refused until its backend landed; both
    # servers now run it
    base = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_mode="baseline"))
    srv = DecodeServer(base, batch=8, max_len=8, ep_size=8, device="cpu")
    tok, _ = srv.prefill(torch.zeros((8, 1), dtype=torch.int32))
    assert tok.shape == (8, 1)
    csrv = ContinuousDecodeServer(base, batch=8, max_len=8, ep_size=8, device="cpu",
                                  page_size=4)
    assert csrv.serve_requests([Request(0, [1], 1)]).requests_completed == 1
    # EPLB options are validated as the reference server does: the heat
    # drives the rebalancer
    with pytest.raises(ValueError, match="track_expert_heat"):
        ContinuousDecodeServer(cfg, batch=8, max_len=8, device="cpu", rebalance_every=4)


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


def test_cpu_tensors_take_the_plain_fp8_and_combine_reduce():
    """The standalone fp8 pair and combine_reduce route CPU tensors to their
    plain versions; their wrappers refuse CPU tensors and never launch."""
    from repro_torch.kernels import combine_reduce as cr_mod
    from repro_torch.kernels import fp8 as fp8_mod
    fp8_mod.quantize_launches = fp8_mod.dequantize_launches = cr_mod.launches = 0
    x = torch.randn(4, 256)
    q, s = ops.quantize_fp8(x, 64)
    wq, ws = ref.quantize_fp8(x, 64)
    assert torch.equal(q.view(torch.uint8), wq.view(torch.uint8)) and torch.equal(s, ws)
    assert torch.equal(ops.dequantize_fp8(q, s), ref.dequantize_fp8(q, s))
    y, w = torch.randn(4, 3, 16), torch.rand(4, 3)
    assert torch.equal(ops.combine_reduce(y, w), ref.combine_reduce(y, w))
    assert fp8_mod.quantize_launches == fp8_mod.dequantize_launches == cr_mod.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        fp8_mod.quantize_fp8(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fp8_mod.dequantize_fp8(q, s)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cr_mod.combine_reduce(y, w)


def test_c_entries_match_their_ctypes_signatures():
    """Every ``extern "C"`` entry of the kernel sources has the argument list
    ``_build._SIGNATURES`` gives ctypes, type by type: a pointer as
    c_void_p, int64_t as c_int64, int as c_int, float as c_float. A
    mismatch would pass garbage without any error."""
    import re
    from repro_torch.kernels import _build
    kinds = {"int64_t": "L", "int": "I", "float": "F"}
    ctypes_kinds = {_build._P: "P", _build._L: "L", _build._I: "I", _build._F: "F"}
    seen = {}
    for name in _build.SOURCES:
        text = (_build.CSRC / name).read_text()
        for fn, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            seen[fn] = tuple("P" if "*" in a else kinds[a.split()[-2]]
                             for a in (" ".join(x.split()) for x in args.split(",")))
    assert set(seen) == set(_build._SIGNATURES)
    for fn, sig in _build._SIGNATURES.items():
        assert seen[fn] == tuple(ctypes_kinds[t] for t in sig), fn


def test_every_included_header_is_hashed():
    """Every ``#include "..."`` of a kernel source or header names a file in
    ``_build.HEADERS``, and every entry there exists: the library's name is
    a hash of the sources and those headers, so an edit to a header missing
    from it would load a stale library."""
    import re
    from repro_torch.kernels import _build
    files = sorted(_build.CSRC.glob("*.cu")) + sorted(_build.CSRC.glob("*.cuh"))
    assert {p.name for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)
    included = {name for p in files
                for name in re.findall(r'^\s*#include\s+"([^"]+)"', p.read_text(), re.M)}
    assert included <= set(_build.HEADERS), included - set(_build.HEADERS)
    for name in _build.HEADERS:
        assert (_build.CSRC / name).is_file(), name
