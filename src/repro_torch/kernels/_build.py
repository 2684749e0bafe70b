"""Build and load the hand-written Hopper kernels (``repro_torch/csrc``).

The sources have a plain C interface and no PyTorch headers, so ``nvcc``
builds them in seconds: each ``.cu`` is compiled to an object in parallel,
then linked into one shared library under ``build/repro_torch/`` at the
checkout's root, named by a hash of the sources and flags. The library is
loaded with ``ctypes``; every pointer and the stream go over as
``c_void_p``. Each C entry returns ``cudaGetLastError()`` and ``check``
raises on anything but 0. Nothing is built until the first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("dispatch_pack.cu", "recv_unpack.cu", "grouped_gemm.cu",
           "combine_gather_reduce.cu", "paged_decode_attention.cu",
           "flash_attention.cu", "fp8.cu", "combine_reduce.cu",
           # the training backward (grouped_gemm's weight gradient, the
           # combine's backward, flash attention's dQ and dK/dV pair)
           "grouped_gemm_dw.cu", "combine_gather_reduce_bwd.cu",
           "flash_attention_bwd.cu")
HEADERS = ("common.cuh", "gather.cuh", "hopper.cuh", "quant.cuh", "reduce.cuh")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# torch dtype -> the DType codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float8_e4m3fn: 3}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "ep_dispatch_pack_copy": (_P, _P, _P, _L, _I, _L, _I, _I, _P),
    "ep_dispatch_pack_quant": (_P, _P, _P, _P, _L, _I, _L, _I, _I, _P),
    "ep_recv_unpack_copy": (_P, _P, _P, _L, _I, _L, _I, _I, _I, _P),
    "ep_recv_unpack_dequant": (_P, _P, _P, _P, _L, _I, _L, _I, _I, _I, _P),
    "ep_grouped_gemm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "ep_combine_gather_reduce": (_P, _P, _P, _P, _I, _I, _L, _I, _I, _P),
    "ep_paged_decode_stage1": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "ep_paged_decode_stage2": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "ep_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L,
                           _L, _L, _L, _F, _I, _I, _I, _P, _P),
    "ep_quantize_fp8": (_P, _P, _P, _L, _L, _I, _I, _I, _P),
    "ep_dequantize_fp8": (_P, _P, _P, _L, _L, _I, _I, _I, _P),
    "ep_combine_reduce": (_P, _P, _P, _I, _L, _I, _I, _I, _I, _P),
    "ep_grouped_gemm_dw": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "ep_combine_gather_reduce_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P),
    "ep_flash_attention_bwd": (_P,) * 10 + (_I,) * 6 + (_F, _I, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the build this process ran


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the Hopper kernels are built with "
                           "the CUDA toolkit at their first launch")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(target: pathlib.Path) -> None:
    """Compile every source in parallel, link, and move the library into
    place atomically (concurrent builds each work in their own tmp dir)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for name, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {name}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        so = tmp / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(so), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        (BUILD_DIR / "build.log").write_text("".join(log))
        os.replace(so, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    target = BUILD_DIR / f"libep_kernels_{_digest()}.so"
    if not target.exists():
        t0 = time.perf_counter()
        _build(target)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.ep_error_string.argtypes = [ctypes.c_int]
    lib.ep_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on the current stream (appended as the last
    argument) and raise if the launch reported an error."""
    lib = library()
    rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.ep_error_string(rc).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc} ({msg})")


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Refuse what the kernels do not take: CPU or other-device tensors and
    non-contiguous ones."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the Hopper kernel needs CUDA tensors, "
                             f"got one on {t.device}")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: tensor on {t.device} but the current "
                             f"device is cuda:{torch.cuda.current_device()}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def dtype_code(name: str, dt: torch.dtype, allowed) -> int:
    if dt not in allowed:
        raise TypeError(f"{name}: dtype {dt} not supported (takes {allowed})")
    return DTYPE_CODES[dt]


def aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)
