"""Seeded weights of a configuration, made on the device in a few large
calls: one group of leaves (the embedding, each layer, the final norm,
the output head) is one draw of N(0, 1) in fp32 from a generator keyed by
the seed and the group's name, cut into the group's leaves, each scaled
and rounded to its serving type.  The same key on the same device gives
the same bits, so the program and the plain reference hold equal weights
without either reading the other's.

Which groups and leaves a model has is its architecture's
(``archs/<arch>.py``, ``groups(model)``); this module holds what every
architecture shares: the leaf helpers with their laws, the decoder's
skeleton of groups, the key and the draw.

Laws: matrices N(0, 1 / fan_in), a stack of matrices (one a routed
expert) each so; the embedding and the output head N(0, 0.02^2); norm
scales 1 + N(0, 0.1^2) (not ones, so that a norm left out shows).  Leaves
are named as the port's parameter tree (``layers.<i>.attn.wq``), each
matrix stored [in, out].
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

# (leaf name, shape, mean, std, dtype name or "model": the served type)
Leaf = Tuple[str, Tuple[int, ...], float, float, str]
Group = Tuple[str, List[Leaf]]


def norm(name: str, d: int) -> Leaf:
    return (name, (d,), 1.0, 0.1, "model")


def dense(name: str, din: int, dout: int, dtype: str = "model") -> Leaf:
    return (name, (din, dout), 0.0, 1.0 / math.sqrt(din), dtype)


def stacked(name: str, n: int, din: int, dout: int) -> Leaf:
    """``n`` matrices [din, dout] in one [n, din, dout] leaf."""
    return (name, (n, din, dout), 0.0, 1.0 / math.sqrt(din), "model")


def swiglu(prefix: str, d: int, f: int) -> List[Leaf]:
    return [dense(f"{prefix}.wi", d, f), dense(f"{prefix}.wg", d, f),
            dense(f"{prefix}.wo", f, d)]


def decoder_groups(m: Dict, layer_leaves: Callable[[Dict, int], List[Leaf]]
                   ) -> List[Group]:
    """Every group of a decoder in drawing order: the embedding, each
    layer (``layer_leaves(m, i)``, names relative to the layer), the final
    norm and, unless tied, the output head; leaf names relative to the
    parameter tree's root."""
    d, v = m["d_model"], m["vocab_size"]
    out = [("embed", [("embed.w", (v, d), 0.0, 0.02, "model")])]
    for i in range(m["num_layers"]):
        out.append((f"layers.{i}", [(f"layers.{i}.{n}",) + tuple(rest)
                                    for n, *rest in layer_leaves(m, i)]))
    out.append(("final_norm", [norm("final_norm.scale", d)]))
    if not m.get("tie_embeddings"):
        out.append(("lm_head", [("lm_head.w", (d, v), 0.0, 0.02, "model")]))
    return out


def key(seed: int, group: str) -> int:
    h = hashlib.sha256(f"{int(seed)}|{group}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def draw(m: Dict, seed: int, group: Group, device
         ) -> Iterator[Tuple[str, torch.Tensor]]:
    """The leaves of one group, in the type they are served in."""
    name, leaves = group
    n = sum(math.prod(shape) for _, shape, *_ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(key(seed, name))
    flat = torch.randn((n,), generator=gen, dtype=torch.float32,
                       device=device)
    off = 0
    model_dtype = DTYPES[m["dtype"]]
    for leaf, shape, mean, std, dt in leaves:
        k = math.prod(shape)
        x = flat[off:off + k].view(shape) * std + mean
        off += k
        yield leaf, x.to(model_dtype if dt == "model" else DTYPES[dt])
    del flat
