"""Minitron-8B: width-pruned Nemotron-4 [arXiv:2407.14679]."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    rope_theta=10000.0,
    period=(ATTN,),
    grad_accum_steps=2,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        period=(ATTN,),
    )
