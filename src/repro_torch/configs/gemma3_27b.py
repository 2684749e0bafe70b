"""Gemma3-27B [hf:google/gemma-3-*-pt family]: 62L d_model=5376 32H (GQA
kv=16) d_ff=21504 vocab=262144 — 5:1 local:global attention, local window
1024, 128k context. Sub-quadratic in 5/6 layers -> runs long_500k.

Copied from ``src/repro/configs/gemma3_27b.py``. Dense: EP does not apply."""
from repro_torch.models.config import ArchConfig, AttnSpec


def full_config(shape=None):
    micro = {"train_4k": 8, "prefill_32k": 1}.get(shape, 1)
    return ArchConfig(
        name="gemma3-27b", family="gemma3", num_layers=62, d_model=5376,
        d_ff=21504, vocab=262144,
        attn=AttnSpec(n_heads=32, n_kv=16, head_dim=128, rope_base=1e6,
                      qk_norm=True),
        local_global=(5, 1), local_window=1024,
        tie_embeddings=True, microbatch=micro,
    )


def smoke_config():
    return ArchConfig(
        name="gemma3-smoke", family="gemma3", num_layers=8, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnSpec(n_heads=4, n_kv=2, head_dim=16, qk_norm=True),
        local_global=(2, 1), local_window=8, tie_embeddings=True, remat=False,
    )
