"""Model interface of the PyTorch port: ``build(arch)`` returns a
:class:`Model` with init/apply/cache entry points, for the decoders the
port implements so far: dense global attention, sliding-window
attention, RG-LRU and RWKV-6 blocks, with tail blocks and tied or scaled
embeddings."""
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
        "mixture of experts": cfg.moe is not None,
        "encoder-decoder": cfg.is_encoder_decoder,
        f"frontend {cfg.frontend!r}": cfg.frontend != "none",
        "learned positions": cfg.learned_pos_embed,
        "M-RoPE": bool(cfg.mrope_sections),
        "qk norm": cfg.qk_norm,
        "biases": cfg.use_bias,
        "parallel blocks": cfg.parallel_block,
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
            f"{cfg.name}: not yet ported ({', '.join(missing)})")
    return Model(
        cfg=cfg,
        init_params=functools.partial(lm.init_params, cfg),
        init_cache=functools.partial(lm.init_cache, cfg),
        apply=functools.partial(lm.apply, cfg),
        logits_of=functools.partial(lm.logits_of, cfg),
    )
