"""DBRX-132B [hf:databricks/dbrx-base]: 40L d_model=6144 48H (GQA kv=8)
d_ff=10752/expert, vocab=100352, MoE 16 experts top-4 (fine-grained).

Copied from ``src/repro/configs/dbrx_132b.py``. HT for train/prefill, LL for
decode; E=16 bounds EP at 16 ranks."""
from repro_torch.models.config import ArchConfig, AttnSpec, MoESpec


def full_config(shape=None):
    kind = "decode" if shape in ("decode_32k", "long_500k") else "train"
    moe = MoESpec(
        num_experts=16, top_k=4, d_ff_expert=10752,
        ep_mode=("ll" if kind == "decode" else "ht"), ep_axis=("data",),
        capacity_factor=(None if kind == "decode" else 1.25),
        expert_capacity_factor=(2.0 if kind == "decode" else 1.25),
        quantize_dispatch=(kind != "decode"),
    )
    micro = {"train_4k": 8, "prefill_32k": 1}.get(shape, 1)
    return ArchConfig(
        name="dbrx-132b", family="lm", num_layers=40, d_model=6144,
        d_ff=10752, vocab=100352,
        attn=AttnSpec(n_heads=48, n_kv=8, head_dim=128, rope_base=5e5),
        moe=moe, microbatch=micro,
    )


def smoke_config():
    return ArchConfig(
        name="dbrx-smoke", family="lm", num_layers=2, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnSpec(n_heads=4, n_kv=2, head_dim=16),
        moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=64,
                    ep_axis=("data",), capacity_factor=None),
        remat=False,
    )
