"""InternLM2-20B [arXiv:2403.17297]: 48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92544. Dense GQA decoder.

Copied from ``src/repro/configs/internlm2_20b.py``. Dense: EP does not
apply."""
from repro_torch.models.config import ArchConfig, AttnSpec


def full_config(shape=None):
    micro = {"train_4k": 8, "prefill_32k": 1}.get(shape, 1)
    return ArchConfig(
        name="internlm2-20b", family="lm", num_layers=48, d_model=6144,
        d_ff=16384, vocab=92544,
        attn=AttnSpec(n_heads=48, n_kv=8, head_dim=128, rope_base=1e6),
        microbatch=micro,
    )


def smoke_config():
    return ArchConfig(
        name="internlm2-smoke", family="lm", num_layers=2, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnSpec(n_heads=4, n_kv=2, head_dim=16), remat=False,
    )
