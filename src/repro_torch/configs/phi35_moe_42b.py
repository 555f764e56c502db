"""Phi-3.5-MoE 42B (6.6B active): 16 experts, top-2
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,                  # unused for MoE layers; kept for reference
    vocab_size=32064,
    use_layernorm=True,
    rope_theta=10000.0,
    period=(ATTN,),
    moe=MoEConfig(
        num_experts=16,
        num_experts_per_tok=2,
        expert_d_ff=6400,
    ),
    grad_accum_steps=2,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi35-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=512,
        use_layernorm=True,
        period=(ATTN,),
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2, expert_d_ff=96),
    )
