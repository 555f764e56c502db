"""Command-R 35B: dense GQA, parallel attn+mlp block, no bias
[hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    use_layernorm=True,
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    period=(ATTN,),
    grad_accum_steps=4,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        head_dim=8,
        d_ff=160,
        vocab_size=512,
        use_layernorm=True,
        parallel_block=True,
        tie_embeddings=True,
        period=(ATTN,),
    )
