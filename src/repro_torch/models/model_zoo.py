"""Model interface of the PyTorch port: ``build(arch)`` returns a
:class:`Model` with init/apply/cache entry points, for the dense
pure-global-attention decoders the port implements so far."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Union

from repro_torch.configs import base as cfgs
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: cfgs.ModelConfig
    init_params: Callable[..., Any]
    init_cache: Callable[..., Any]
    apply: Callable[..., Any]
    logits_of: Callable[..., Any]

    @property
    def name(self) -> str:
        return self.cfg.name


def _unported_features(cfg: cfgs.ModelConfig):
    feats = {
        "non-attention or windowed blocks": any(
            b != cfgs.ATTN for b in cfg.block_pattern),
        "tail blocks": bool(cfg.tail),
        "mixture of experts": cfg.moe is not None,
        "encoder-decoder": cfg.is_encoder_decoder,
        f"frontend {cfg.frontend!r}": cfg.frontend != "none",
        "learned positions": cfg.learned_pos_embed,
        "M-RoPE": bool(cfg.mrope_sections),
        "qk norm": cfg.qk_norm,
        "biases": cfg.use_bias,
        "parallel blocks": cfg.parallel_block,
        "tied embeddings": cfg.tie_embeddings,
        "scaled embeddings": cfg.scale_embedding,
    }
    return [name for name, on in feats.items() if on]


def build(arch: Union[str, cfgs.ModelConfig], *, smoke: bool = False
          ) -> Model:
    if isinstance(arch, str):
        cfg = cfgs.get_smoke_config(arch) if smoke else cfgs.get_config(arch)
    else:
        cfg = arch
    missing = _unported_features(cfg)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not yet ported ({', '.join(missing)}); the port "
            "builds dense pure-attention decoders")
    return Model(
        cfg=cfg,
        init_params=functools.partial(lm.init_params, cfg),
        init_cache=functools.partial(lm.init_cache, cfg),
        apply=functools.partial(lm.apply, cfg),
        logits_of=functools.partial(lm.logits_of, cfg),
    )
