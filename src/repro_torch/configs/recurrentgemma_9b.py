"""RecurrentGemma-9B: RG-LRU + local attention, 1:2 pattern [arXiv:2402.19427].

38 layers decompose as 12 × (rglru, rglru, attn) + (rglru, rglru) tail,
preserving the 1:2 attention:recurrence ratio at exactly 38 layers.
"""
from repro_torch.configs.base import ATTN, LOCAL_ATTN, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attention_window=2048,
    rope_theta=10000.0,
    scale_embedding=True,
    tie_embeddings=True,
    logit_softcap=30.0,
    period=(RGLRU, RGLRU, LOCAL_ATTN),
    tail=(RGLRU, RGLRU),
    lru_width=4096,
    grad_accum_steps=2,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attention_window=32,
        scale_embedding=True,
        tie_embeddings=True,
        logit_softcap=30.0,
        period=(RGLRU, RGLRU, LOCAL_ATTN),
        tail=(RGLRU, RGLRU),
        lru_width=64,
    )
