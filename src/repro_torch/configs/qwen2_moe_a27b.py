"""Qwen1.5/2-MoE-A2.7B: 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B].

Routed experts are padded 60 -> 64 so expert-parallelism divides the 16-way
``model`` mesh axis evenly; the 4 pad experts are masked out of routing.
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    use_bias=False,
    rope_theta=1_000_000.0,
    period=(ATTN,),
    moe=MoEConfig(
        num_experts=60,
        num_experts_per_tok=4,
        expert_d_ff=1408,
        num_shared_experts=4,
        shared_d_ff=5632,       # 4 shared experts fused: 4 * 1408
        padded_num_experts=64,
    ),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=64,
        vocab_size=512,
        period=(ATTN,),
        moe=MoEConfig(
            num_experts=6, num_experts_per_tok=2, expert_d_ff=64,
            num_shared_experts=1, shared_d_ff=128, padded_num_experts=8,
        ),
    )
