"""Model configuration for the PyTorch port of the AISQL model zoo.

Every hosted architecture is described by a :class:`ModelConfig`, plain data
kept field for field equal to the JAX package's, so that one configuration
means the same model in both packages.  Only the architectures whose blocks
the port implements resolve here; every other known id raises.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# Block type tags used by the generic LM assembly (models/lm.py).
ATTN = "attn"          # global causal self-attention
LOCAL_ATTN = "local"   # sliding-window self-attention
RGLRU = "rglru"        # RG-LRU recurrent block (recurrentgemma)
RWKV = "rwkv6"         # RWKV-6 "Finch" time-mix block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int                # routed experts (pre-padding)
    num_experts_per_tok: int        # top-k
    expert_d_ff: int                # per-expert hidden dim
    num_shared_experts: int = 0     # always-on shared experts
    shared_d_ff: int = 0            # hidden dim of the fused shared expert
    router_aux_loss: float = 0.001  # load-balance loss weight
    capacity_factor: float = 1.25   # per-expert token capacity multiplier
    padded_num_experts: int = 0     # experts padded up for even EP sharding

    def __post_init__(self):
        if self.padded_num_experts == 0:
            object.__setattr__(self, "padded_num_experts", self.num_experts)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # --- attention options ---------------------------------------------
    qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 10000.0
    attention_window: int = 0       # sliding window size for LOCAL_ATTN
    mrope_sections: Tuple[int, ...] = ()   # M-RoPE (qwen2-vl): rotary dims per (t,h,w)
    # --- norms / embeddings ---------------------------------------------
    use_rope: bool = True
    learned_pos_embed: bool = False # additive learned positions (whisper)
    max_pos_embed: int = 4096       # rows of the learned position table
    norm_eps: float = 1e-6
    use_layernorm: bool = False     # LayerNorm instead of RMSNorm (whisper, stablelm)
    parallel_block: bool = False    # attn+mlp in parallel (command-r, stablelm)
    tie_embeddings: bool = False
    scale_embedding: bool = False   # multiply embeddings by sqrt(d_model) (gemma)
    logit_softcap: float = 0.0
    # --- block pattern ----------------------------------------------------
    # The model is `num_periods` repetitions of `period` followed by `tail`.
    # Homogeneous models: period=("attn",), num_periods=num_layers, tail=().
    period: Tuple[str, ...] = (ATTN,)
    tail: Tuple[str, ...] = ()
    # --- MoE ---------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    # --- recurrent families -------------------------------------------------
    lru_width: int = 0              # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4           # temporal conv in RG-LRU block
    rwkv_head_size: int = 64        # RWKV6 per-head state size
    # --- encoder/decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500         # audio frames after the (stubbed) conv frontend
    # --- modality frontend stub ----------------------------------------------
    # "none": token ids. "frames": precomputed frame embeddings (audio).
    # "patches": precomputed patch embeddings prepended to token stream (vlm).
    frontend: str = "none"
    num_patches: int = 0            # vlm: patch positions prepended to the stream
    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    # --- training memory lever (per-arch default, overridable per run) -------
    grad_accum_steps: int = 1

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.lru_width == 0 and RGLRU in self.period + self.tail:
            object.__setattr__(self, "lru_width", self.d_model)

    # ---- derived ----
    @property
    def num_periods(self) -> int:
        body = self.num_layers - len(self.tail)
        assert body % len(self.period) == 0, (
            f"{self.name}: {self.num_layers} layers does not decompose into "
            f"{self.period} * k + {self.tail}")
        return body // len(self.period)

    @property
    def block_pattern(self) -> Tuple[str, ...]:
        return self.period * self.num_periods + self.tail

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def attention_free(self) -> bool:
        return not any(b in (ATTN, LOCAL_ATTN) for b in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if sequence mixing cost is sub-quadratic in seq_len (may run
        the long_500k shape)."""
        return not any(b == ATTN for b in self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (matches init to within ties/padding)."""
        d, v = self.d_model, self.vocab_size
        n = v * d                                     # embedding
        if not self.tie_embeddings:
            n += d * v                                # lm_head
        n += d                                        # final norm
        for blk in self.block_pattern:
            n += self._block_params(blk)
        if self.is_encoder_decoder:
            n += self.encoder_layers * self._block_params(ATTN)
            # cross attention per decoder layer
            n += self.num_layers * (2 * d * self.q_dim + 2 * d * self.kv_dim + d)
            n += d                                    # encoder final norm
        return n

    def _block_params(self, blk: str) -> int:
        d = self.d_model
        n = 2 * d                                     # two pre-norms
        if blk in (ATTN, LOCAL_ATTN):
            n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qk_norm:
                n += 2 * self.head_dim
            n += self._mlp_params()
        elif blk == RGLRU:
            w = self.lru_width
            n += 2 * d * w + w * d                    # x/gate in-proj, out-proj
            n += self.conv1d_width * w                # temporal conv
            n += 3 * w                                # a_param, input_gate, a_gate (diag)
            n += self._mlp_params()
        elif blk == RWKV:
            # time-mix: r,k,v,g,w projections + out; small lora-ish decay nets folded in
            n += 5 * d * d + d * d
            n += 6 * d                                # per-channel mix/decay/bonus params
            # channel-mix
            n += d * self.d_ff + self.d_ff * d + 2 * d
        else:
            raise ValueError(blk)
        return n

    def _mlp_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            n = d * m.num_experts                     # router
            n += m.num_experts * (3 * d * m.expert_d_ff)
            if m.num_shared_experts:
                n += 3 * d * m.shared_d_ff
            return n
        return 3 * d * self.d_ff                      # gated mlp (wi, wg, wo)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full_expert = 3 * self.d_model * m.expert_d_ff
        inactive = (m.num_experts - m.num_experts_per_tok) * full_expert
        n_moe_layers = sum(1 for b in self.block_pattern if b in (ATTN, LOCAL_ATTN))
        return self.param_count() - inactive * n_moe_layers


# Architectures the port implements: the dense global-attention decoders
# of the cascade pair, the attention-free RWKV-6 model and the RG-LRU /
# local-attention hybrid.
PORTED_IDS = ("proxy-8b", "oracle-70b", "rwkv6-1.6b", "recurrentgemma-9b")

# Every architecture the JAX package hosts; the ones missing from
# PORTED_IDS are queued for later slices of the port.
KNOWN_IDS = (
    "recurrentgemma-9b", "command-r-35b", "qwen3-32b", "stablelm-12b",
    "minitron-8b", "whisper-base", "phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b",
    "qwen2-vl-7b", "rwkv6-1.6b", "proxy-8b", "oracle-70b",
)

_MODULE_FOR = {
    "proxy-8b": "proxy_8b",
    "oracle-70b": "oracle_70b",
    "rwkv6-1.6b": "rwkv6_16b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def _module(arch: str):
    if arch not in KNOWN_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(KNOWN_IDS)}")
    if arch not in _MODULE_FOR:
        raise NotImplementedError(
            f"arch {arch!r} is not yet ported; ported: {list(PORTED_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    return _module(arch).smoke_config()
