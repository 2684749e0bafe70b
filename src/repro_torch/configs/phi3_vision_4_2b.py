"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct]: 32L
d_model=3072 32H (MHA) d_ff=8192 vocab=32064 — phi3-mini backbone + CLIP
frontend. The modality frontend is a STUB: input_specs() provides precomputed
patch embeddings [B, 576, d_model] injected at the sequence front.

Copied from ``src/repro/configs/phi3_vision_4_2b.py``. Dense: EP does not
apply."""
from repro_torch.models.config import ArchConfig, AttnSpec


def full_config(shape=None):
    micro = {"train_4k": 4, "prefill_32k": 1}.get(shape, 1)
    return ArchConfig(
        name="phi-3-vision-4.2b", family="vlm", num_layers=32, d_model=3072,
        d_ff=8192, vocab=32064,
        attn=AttnSpec(n_heads=32, n_kv=32, head_dim=96, rope_base=10000.0),
        img_tokens=576, microbatch=micro,
    )


def smoke_config():
    return ArchConfig(
        name="phi3v-smoke", family="vlm", num_layers=2, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnSpec(n_heads=4, n_kv=4, head_dim=16),
        img_tokens=8, remat=False,
    )
