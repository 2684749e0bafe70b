#!/usr/bin/env python3
"""Planted-fault check of the limits ``chip_smoke.py`` holds flash attention to.

    python3 tools/flash_fault_check.py

Needs one card and nvcc. Runs the kernel on ``chip_smoke.py``'s main-path
inputs (DBRX-132B's prefill: q [8, 4096, 48, 128], k/v [8, 4096, 8, 128]
bf16) in its three main cases (causal, a window of 1024, non-causal), then
builds a copy of the kernel sources, in a temporary directory, in which the
bf16 kernel skips KV tile 32 (keys 2048 to 2111: their scores are masked),
and runs that copy on the same inputs. Prints, for each case and each
build, the largest absolute error and the relative error (Frobenius norm)
against the plain version. Exits non-zero unless every case of the sound
kernel passes ``chip_smoke.py``'s limits and every case of the faulted one
fails them.
"""
from __future__ import annotations

import pathlib
import shutil
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.configs.dbrx_132b import full_config  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SKIPPED_TILE = 32
ANCHOR = "    const int k0 = j * BKV;\n    float mx0 = NEG_INF, mx1 = NEG_INF;\n"
FAULT = (f"    if (j == {SKIPPED_TILE})\n"
         "      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = NEG_INF;\n")


def passes(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, float, float]:
    err, rel = cs.flash_errors(got, want)
    ok = rel <= cs.FLASH_REL and torch.allclose(got.float(), want.float(),
                                                rtol=cs.TOL, atol=cs.TOL)
    return ok, err, rel


def faulted_sources(tmp: pathlib.Path) -> pathlib.Path:
    csrc = tmp / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = (csrc / "flash_attention.cu").read_text()
    if src.count(ANCHOR) != 1:
        raise RuntimeError("the fault's anchor is not in csrc/flash_attention.cu once")
    (csrc / "flash_attention.cu").write_text(src.replace(ANCHOR, ANCHOR + FAULT))
    return csrc


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fault_check: needs a CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line())
    cfg = full_config("train_4k")
    q, k, v, scale = cs.flash_main_inputs(cfg)
    wants = {label: ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), scale=scale, **extra).transpose(1, 2)
             for label, extra in cs.FLASH_CASES.items()}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for build in ("sound", f"KV tile {SKIPPED_TILE} skipped"):
            if build != "sound":     # rebuild every source from the faulted copy
                _build.CSRC = faulted_sources(pathlib.Path(tmp))
                _build.BUILD_DIR = pathlib.Path(tmp) / "build"
                _build._lib = None
            for label, extra in cs.FLASH_CASES.items():
                got = fa.flash_attention_bshd(q, k, v, scale=scale, **extra)
                passed, err, rel = passes(got, wants[label])
                print(f"{build}, {label}: max_abs_err {err:.4g}, relative {rel:.4g} "
                      f"(limits {cs.TOL} per element, {cs.FLASH_REL} relative): "
                      f"{'passes' if passed else 'fails'}")
                ok = ok and passed == (build == "sound")
    print("flash_fault_check: " + ("the limits pass the sound kernel and fail the faulted one"
                                   if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
