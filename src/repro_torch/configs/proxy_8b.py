"""Cascade proxy model: Llama-3.1-8B-class dense GQA (paper §5.2)."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="proxy-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    period=(ATTN,),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="proxy-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        period=(ATTN,),
    )
