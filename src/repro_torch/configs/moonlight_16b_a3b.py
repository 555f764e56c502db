"""Moonlight-16B-A3B: the DeepSeek-V3 block at 16B
[hf:moonshotai/Moonlight-16B-A3B, ``model_type`` deepseek_v3].

27 layers: multi-head latent attention (16 heads, no q latent, a kv
latent of 512 and a shared RoPE key of 64; q / k heads 128 + 64, v heads
128), layer 0 a dense SwiGLU of 11,264, layers 1-26 DeepSeekMoE (64
routed experts of 1,408, top 6 by sigmoid scores plus a correction bias,
weights renormalised and scaled by 2.446, two shared experts fused into
one SwiGLU of 2,816).  ``n_group`` = ``topk_group`` = 1, so the
group-limited choice is the plain top 6.  A port-only id: the JAX package
has no such block.
"""
import dataclasses

from repro_torch.configs.base import MLA, DeepSeekConfig, DeepSeekMoEConfig

CONFIG = DeepSeekConfig(
    name="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,               # qk_nope_head_dim + qk_rope_head_dim
    d_ff=11264,                 # the dense layer's width
    vocab_size=163840,
    rope_theta=50_000.0,
    norm_eps=1e-5,
    period=(MLA,),
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense=1,
    moe=DeepSeekMoEConfig(
        num_experts=64,
        num_experts_per_tok=6,
        expert_d_ff=1408,
        num_shared_experts=2,
        shared_d_ff=2816,       # 2 shared experts fused: 2 * 1408
        routed_scale=2.446,
        # dropless, as the published model routes: every expert may take
        # every token of a full-sequence pass too
        capacity_factor=64 / 6,
    ),
)


def smoke_config() -> DeepSeekConfig:
    return dataclasses.replace(
        CONFIG, name="moonlight-smoke", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=24, d_ff=96, vocab_size=512,
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16,
        moe=dataclasses.replace(CONFIG.moe, num_experts=8,
                                num_experts_per_tok=3, expert_d_ff=32,
                                shared_d_ff=64, padded_num_experts=8,
                                capacity_factor=8 / 3))
