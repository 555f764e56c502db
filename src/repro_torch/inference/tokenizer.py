"""Byte-level tokenizer for the serving stack.

Vocabulary: 4 specials + 256 bytes.  Fits every zoo vocab (all >= 512) so
any hosted architecture can serve AISQL traffic.  The yes/no class tokens
used for AI_FILTER confidence scores (§5.2) are the byte tokens for 'y'/'n'.
"""
from __future__ import annotations

from typing import List, Sequence

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
SEP_ID = 3
_OFFSET = 4
VOCAB_SIZE = 256 + _OFFSET

YES_ID = ord("y") + _OFFSET
NO_ID = ord("n") + _OFFSET


def encode(text: str, *, bos: bool = True, eos: bool = False,
           max_len: int | None = None) -> List[int]:
    ids = [BOS_ID] if bos else []
    ids += [b + _OFFSET for b in text.encode("utf-8", errors="replace")]
    if eos:
        ids.append(EOS_ID)
    if max_len is not None and len(ids) > max_len:
        # keep the tail: instructions usually end the prompt
        ids = ids[:1] + ids[-(max_len - 1):] if bos else ids[-max_len:]
    return ids


def decode(ids: Sequence[int]) -> str:
    bs = bytes(i - _OFFSET for i in ids
               if _OFFSET <= i < VOCAB_SIZE)
    return bs.decode("utf-8", errors="replace")
