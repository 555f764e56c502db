"""Model interface of the PyTorch port: ``build(arch)`` returns a
:class:`Model` with init/apply/cache entry points for every architecture
of the zoo: the decoders of ``models/lm.py`` (dense global attention with
qk-norm, parallel blocks, biases, M-RoPE and a patches front end as
options, mixture-of-experts feed-forwards, sliding-window attention,
RG-LRU and RWKV-6 blocks, tail blocks, tied or scaled embeddings) and the
encoder-decoder of ``models/whisper.py``.  ``ce_loss`` is the chunked
training loss of ``models/lm.py`` for both.

``input_specs(cfg, shape)`` and ``cache_specs(cfg, shape)`` give the
inputs of one (arch x shape) cell as tensors on the ``meta`` device (shape
and dtype, no storage), ``abstract_params`` the params so; the sharding
rules and the step cells read them.  ``model_flops`` and
``attention_flops`` are the analytic FLOP counts of the roofline, equal
to the JAX package's."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Union

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import base as cfgs
from repro_torch.models import lm, whisper
from repro_torch.models.common import dtype_of


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: cfgs.ModelConfig
    init_params: Callable[..., Any]
    init_cache: Callable[..., Any]
    apply: Callable[..., Any]
    logits_of: Callable[..., Any]
    ce_loss: Callable[..., Any]

    @property
    def name(self) -> str:
        return self.cfg.name


def build(arch: Union[str, cfgs.ModelConfig], *, smoke: bool = False
          ) -> Model:
    if isinstance(arch, str):
        cfg = cfgs.get_smoke_config(arch) if smoke else cfgs.get_config(arch)
    else:
        cfg = arch
    body = whisper if cfg.is_encoder_decoder else lm
    return Model(
        cfg=cfg,
        init_params=functools.partial(body.init_params, cfg),
        init_cache=functools.partial(body.init_cache, cfg),
        apply=functools.partial(body.apply, cfg),
        logits_of=functools.partial(lm.logits_of, cfg),
        ce_loss=functools.partial(lm.ce_loss_chunked, cfg),
    )


# ---------------------------------------------------------------------------
# input specs (shape and dtype on the meta device; no storage)
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_meta(v) for v in tree]
    return _meta(tuple(tree.shape), tree.dtype)


def abstract_params(cfg: cfgs.ModelConfig) -> Dict[str, Any]:
    """The param tree of ``cfg`` as meta tensors: drawn under a fake
    tensor mode (no storage at any width), then given the meta device."""
    with FakeTensorMode():
        tree = build(cfg).init_params(torch.Generator().manual_seed(0))
    return _to_meta(tree)


def input_specs(cfg: cfgs.ModelConfig, shape: cfgs.ShapeSpec
                ) -> Dict[str, torch.Tensor]:
    """The batch of one (arch x shape) cell as meta tensors.

    train  -> {"tokens","labels","loss_mask"} (+ modality extras)
    prefill-> {"tokens","lengths"} (+ extras)
    decode -> {"tokens"} (+ positions for M-RoPE); the cache comes from
              :func:`cache_specs`.
    """
    B, S = shape.global_batch, shape.seq_len
    act = dtype_of(cfg.dtype)
    i32 = torch.int32
    batch: Dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        n_tok = S - cfg.num_patches if cfg.frontend == "patches" else S
        batch["tokens"] = _meta((B, n_tok), i32)
        if shape.kind == "train":
            batch["labels"] = _meta((B, S), i32)
            batch["loss_mask"] = _meta((B, S), torch.float32)
        else:
            batch["lengths"] = _meta((B,), i32)
        if cfg.frontend == "patches":
            batch["patches"] = _meta((B, cfg.num_patches, cfg.d_model), act)
            batch["positions"] = _meta((B, S, 3), i32)
        if cfg.frontend == "frames":
            batch["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model), act)
    else:  # decode: one new token against a cache of S tokens
        batch["tokens"] = _meta((B, 1), i32)
        if cfg.mrope_sections:
            batch["positions"] = _meta((B, 1, 3), i32)
    return batch


def cache_specs(cfg: cfgs.ModelConfig, shape: cfgs.ShapeSpec):
    """The KV / state cache of a cell as meta tensors."""
    return build(cfg).init_cache(shape.global_batch, shape.seq_len,
                                 device="meta")


# ---------------------------------------------------------------------------
# analytic FLOPs (the roofline's MODEL_FLOPS term)
# ---------------------------------------------------------------------------


def model_flops(cfg: cfgs.ModelConfig, shape: cfgs.ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference forward), N the
    active params, D the tokens processed: B*S for train and prefill, B
    for a decode step.  Attention is not included."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def attention_flops(cfg: cfgs.ModelConfig, shape: cfgs.ShapeSpec) -> float:
    """Analytic attention matmul FLOPs (q k^T and p v), forward only;
    three times that for a train step."""
    n_attn = sum(1 for b in cfg.block_pattern if b == cfgs.ATTN)
    n_local = sum(1 for b in cfg.block_pattern if b == cfgs.LOCAL_ATTN)
    B, S = shape.global_batch, shape.seq_len
    H, hd = cfg.num_heads, cfg.head_dim
    if shape.kind == "decode":
        per_q = 4.0 * H * hd
        return B * (n_attn * per_q * S
                    + n_local * per_q * min(S, cfg.attention_window))
    full = 2.0 * S * S * H * hd
    local = 2.0 * S * min(2 * cfg.attention_window, S) * H * hd
    f = B * (n_attn * full + n_local * local)
    if shape.kind == "train":
        f *= 3.0
    return f
