"""ChatGLM3-6B [arXiv:2406.12793]: 28L d_model=4096 32H (GQA kv=2)
d_ff=13696 vocab=65024 — 2d RoPE (rotary on half the head dims), GQA kv=2.

Copied from ``src/repro/configs/chatglm3_6b.py``. Dense: EP does not
apply."""
from repro_torch.models.config import ArchConfig, AttnSpec


def full_config(shape=None):
    micro = {"train_4k": 4, "prefill_32k": 1}.get(shape, 1)
    return ArchConfig(
        name="chatglm3-6b", family="lm", num_layers=28, d_model=4096,
        d_ff=13696, vocab=65024,
        attn=AttnSpec(n_heads=32, n_kv=2, head_dim=128,
                      rope_fraction=0.5),          # 2d RoPE
        microbatch=micro,
    )


def smoke_config():
    return ArchConfig(
        name="chatglm3-smoke", family="lm", num_layers=2, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnSpec(n_heads=4, n_kv=2, head_dim=16, rope_fraction=0.5),
        remat=False,
    )
