"""Cascade oracle model: Llama-3.3-70B-class dense GQA (paper §5.2)."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="oracle-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    period=(ATTN,),
    grad_accum_steps=4,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="oracle-smoke",
        family="dense",
        num_layers=3,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        period=(ATTN,),
    )
