"""Qwen2-VL-7B backbone: GQA + M-RoPE [arXiv:2409.12191].

The vision tower is a STUB per the assignment: ``input_specs`` provides
precomputed patch embeddings; M-RoPE positions [B, S, 3] (t/h/w streams)
arrive as model input.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    use_bias=False,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # rotary half-dims per (t, h, w); sums to 64
    frontend="patches",
    num_patches=1024,
    period=(ATTN,),
    grad_accum_steps=2,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        mrope_sections=(4, 2, 2),
        frontend="patches",
        num_patches=16,
        period=(ATTN,),
    )
