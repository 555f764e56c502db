"""Qwen3-32B: dense GQA with qk-norm [hf:Qwen/Qwen3 family]."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    period=(ATTN,),
    grad_accum_steps=4,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        qk_norm=True,
        period=(ATTN,),
    )
