"""Model configurations ported so far (DBRX-132B, DeepSeek-V3-671B), by the
JAX package's ids (``src/repro/configs/__init__.py``)."""
from __future__ import annotations

import importlib

ARCH_IDS = {"dbrx-132b": "dbrx_132b", "deepseek-v3-671b": "deepseek_v3_671b"}


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(f"arch {arch_id!r} is not ported yet; the port "
                                  f"has {sorted(ARCH_IDS)} (ROADMAP A12)")
    return importlib.import_module(f"repro_torch.configs.{ARCH_IDS[arch_id]}")


def get_config(arch_id: str, shape: str | None = None):
    return _module(arch_id).full_config(shape)


def get_smoke(arch_id: str):
    return _module(arch_id).smoke_config()
