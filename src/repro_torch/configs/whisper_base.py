"""Whisper-base: audio encoder-decoder [arXiv:2212.04356].

The conv frontend is a STUB per the assignment: ``input_specs`` provides
precomputed frame embeddings of shape [B, encoder_seq, d_model].
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,                 # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    use_layernorm=True,
    use_bias=True,
    use_rope=False,
    learned_pos_embed=True,
    tie_embeddings=True,
    is_encoder_decoder=True,
    max_pos_embed=33024,
    encoder_layers=6,
    encoder_seq=1500,
    frontend="frames",
    period=(ATTN,),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        use_layernorm=True,
        use_bias=True,
        tie_embeddings=True,
        is_encoder_decoder=True,
        max_pos_embed=128,
        encoder_layers=2,
        encoder_seq=32,
        frontend="frames",
        period=(ATTN,),
    )
