"""StableLM-2-12B: dense GQA, parallel block, LayerNorm
[hf:stabilityai/stablelm-2-12b]."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    use_layernorm=True,
    parallel_block=True,
    rope_theta=10000.0,
    period=(ATTN,),
    grad_accum_steps=2,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        use_layernorm=True,
        parallel_block=True,
        period=(ATTN,),
    )
