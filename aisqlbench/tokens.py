"""The serving stack's byte-level tokenizer, as the reference reads it: 4
special ids, then one id a byte.  A copy, so that the reference reads no
module of the program."""
from __future__ import annotations

from typing import List

PAD_ID, BOS_ID, EOS_ID = 0, 1, 2
OFFSET = 4
VOCAB = 256 + OFFSET
YES_ID = ord("y") + OFFSET
NO_ID = ord("n") + OFFSET


def encode(text: str) -> List[int]:
    return [BOS_ID] + [b + OFFSET for b in text.encode("utf-8")]

