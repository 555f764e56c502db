"""RWKV-6 "Finch" 1.6B: attention-free, data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.configs.base import RWKV, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,                # wkv heads: d_model / rwkv_head_size
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    use_layernorm=True,
    period=(RWKV,),
    rwkv_head_size=64,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        use_layernorm=True,
        period=(RWKV,),
        rwkv_head_size=16,
    )
