"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: 62L d_model=2560 40H d_ff=6400
vocab=73448 — MLA attention (q_lora 768, kv_lora 256, nope 64, rope 32, v 64).
Dense (no MoE) -> EP inapplicable; exercises MLA + absorbed decode.

Copied from ``src/repro/configs/minicpm3_4b.py``."""
from repro_torch.models.config import ArchConfig, AttnSpec, MLASpec


def full_config(shape=None):
    micro = {"train_4k": 8, "prefill_32k": 1}.get(shape, 1)
    return ArchConfig(
        name="minicpm3-4b", family="lm", num_layers=62, d_model=2560,
        d_ff=6400, vocab=73448,
        attn=AttnSpec(n_heads=40, n_kv=40, head_dim=64, kind="mla",
                      rope_base=10000.0),
        mla=MLASpec(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                    qk_rope_dim=32, v_head_dim=64),
        tie_embeddings=True, microbatch=micro,
    )


def smoke_config():
    return ArchConfig(
        name="minicpm3-smoke", family="lm", num_layers=2, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnSpec(n_heads=4, n_kv=4, head_dim=16, kind="mla"),
        mla=MLASpec(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                    qk_rope_dim=8, v_head_dim=16),
        tie_embeddings=True, remat=False,
    )
