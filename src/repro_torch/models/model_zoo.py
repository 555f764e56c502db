"""Model interface of the PyTorch port: ``build(arch)`` returns a
:class:`Model` with init/apply/cache entry points for every architecture
of the zoo: the decoders of ``models/lm.py`` (dense global attention with
qk-norm, parallel blocks, biases, M-RoPE and a patches front end as
options, mixture-of-experts feed-forwards, sliding-window attention,
RG-LRU and RWKV-6 blocks, tail blocks, tied or scaled embeddings) and the
encoder-decoder of ``models/whisper.py``.  ``ce_loss`` is the chunked
training loss of ``models/lm.py`` for both."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Union

from repro_torch.configs import base as cfgs
from repro_torch.models import lm, whisper


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
