"""DeepSeek-V3-671B [arXiv:2412.19437]: 61L d_model=7168 128H MLA,
d_ff=18432 dense / 2048 per expert, vocab=129280, MoE: 1 shared + 256 routed
top-8, sigmoid gating, group-limited (8 groups, top-4), aux-loss-free bias,
first 3 layers dense, MTP. The arch the NCCL EP evaluation models (256
experts, hidden 7168, top-8).

Copied from ``src/repro/configs/deepseek_v3_671b.py``. Train/prefill: HT
over ("data", "model"), flat, fp8 dispatch; decode: LL ``nccl_ep`` over
("data",), fp8 dispatch, zero-drop (expert capacity factor 2.0)."""
from repro_torch.models.config import ArchConfig, AttnSpec, MLASpec, MoESpec


def full_config(shape=None):
    kind = "decode" if shape in ("decode_32k", "long_500k") else "train"
    if kind == "train":
        moe = MoESpec(
            num_experts=256, top_k=8, d_ff_expert=2048, shared_experts=1,
            first_k_dense=3, gating="sigmoid", n_groups=8, topk_groups=4,
            use_selection_bias=True, routed_scaling=2.5,
            ep_mode="ht", ep_axis=("data", "model"), ht_hierarchical=False,
            capacity_factor=1.25, expert_capacity_factor=1.25,
            quantize_dispatch=True,
        )
    else:
        moe = MoESpec(
            num_experts=256, top_k=8, d_ff_expert=2048, shared_experts=1,
            first_k_dense=3, gating="sigmoid", n_groups=8, topk_groups=4,
            use_selection_bias=True, routed_scaling=2.5,
            ep_mode="ll", ep_axis=("data",), ll_layout="nccl_ep",
            capacity_factor=None, expert_capacity_factor=2.0,
            quantize_dispatch=True,
        )
    micro = {"train_4k": 8, "prefill_32k": 1}.get(shape, 1)
    return ArchConfig(
        name="deepseek-v3-671b", family="lm", num_layers=61, d_model=7168,
        d_ff=18432, vocab=129280,
        attn=AttnSpec(n_heads=128, n_kv=128, head_dim=128, kind="mla"),
        mla=MLASpec(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                    qk_rope_dim=64, v_head_dim=128),
        moe=moe, mtp=(kind == "train"), microbatch=micro,
    )


def smoke_config():
    return ArchConfig(
        name="deepseek-v3-smoke", family="lm", num_layers=3, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnSpec(n_heads=4, n_kv=4, head_dim=16, kind="mla"),
        mla=MLASpec(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                    qk_rope_dim=8, v_head_dim=16),
        moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=32, shared_experts=1,
                    first_k_dense=1, gating="sigmoid", n_groups=2,
                    topk_groups=1, use_selection_bias=True,
                    ep_mode="auto", ep_axis=("data",), capacity_factor=None),
        mtp=True, remat=False,
    )
