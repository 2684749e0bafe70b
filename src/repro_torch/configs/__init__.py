"""Model configurations ported so far, by the JAX package's ids
(``src/repro/configs/__init__.py``): every config of the ``lm`` family
(DBRX-132B, DeepSeek-V3-671B, ChatGLM3-6B, InternLM2-20B, MiniCPM3-4B),
``gemma3`` (Gemma3-27B) and ``vlm`` (Phi-3-vision-4.2B)."""
from __future__ import annotations

import importlib

ARCH_IDS = {"dbrx-132b": "dbrx_132b", "deepseek-v3-671b": "deepseek_v3_671b",
            "chatglm3-6b": "chatglm3_6b", "internlm2-20b": "internlm2_20b",
            "minicpm3-4b": "minicpm3_4b", "gemma3-27b": "gemma3_27b",
            "phi-3-vision-4.2b": "phi3_vision_4_2b"}


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: the ssm and hybrid families wait "
            f"for ROADMAP A12b, encdec for A12c; the port has {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_IDS[arch_id]}")


def get_config(arch_id: str, shape: str | None = None):
    return _module(arch_id).full_config(shape)


def get_smoke(arch_id: str):
    return _module(arch_id).smoke_config()
