"""Seeded weights of a configuration, made on the device in a few large
calls: one group of leaves (the embedding, each layer, the final norm,
the output head) is one draw of N(0, 1) in fp32 from a generator keyed by
the seed and the group's name, cut into the group's leaves, each scaled
and rounded to its serving type.  The same key on the same device gives
the same bits, so the program and the plain reference hold equal weights
without either reading the other's.

Laws: matrices N(0, 1 / fan_in); the embedding and the output head
N(0, 0.02^2); norm scales 1 + N(0, 0.1^2) (not ones, so that a norm left
out shows).  Leaves are named as the port's
parameter tree (``layers.<i>.attn.wq``), each matrix stored [in, out].
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

# (leaf name, shape, mean, std, dtype name or "model": the served type)
Leaf = Tuple[str, Tuple[int, ...], float, float, str]


def _norm(name: str, d: int) -> Leaf:
    return (name, (d,), 1.0, 0.1, "model")


def _dense(name: str, din: int, dout: int) -> Leaf:
    return (name, (din, dout), 0.0, 1.0 / math.sqrt(din), "model")


def _swiglu(prefix: str, d: int, f: int) -> List[Leaf]:
    return [_dense(f"{prefix}.wi", d, f), _dense(f"{prefix}.wg", d, f),
            _dense(f"{prefix}.wo", f, d)]


def layer_leaves(m: Dict) -> List[Leaf]:
    """One decoder layer's leaves (dense SwiGLU), for the ``model`` section
    of a configuration file."""
    d, hd = m["d_model"], m["head_dim"]
    q, kv = m["num_heads"] * hd, m["num_kv_heads"] * hd
    out = [_norm("ln1.scale", d), _norm("ln2.scale", d),
           _dense("attn.wq", d, q), _dense("attn.wk", d, kv),
           _dense("attn.wv", d, kv), _dense("attn.wo", q, d)]
    if m.get("qk_norm"):
        out += [_norm("attn.q_norm.scale", hd), _norm("attn.k_norm.scale", hd)]
    return out + _swiglu("mlp", d, m["d_ff"])


def groups(m: Dict) -> List[Tuple[str, List[Leaf]]]:
    """Every group of leaves in drawing order: (group name, its leaves
    with names relative to the parameter tree's root)."""
    d, v = m["d_model"], m["vocab_size"]
    out = [("embed", [("embed.w", (v, d), 0.0, 0.02, "model")])]
    for i in range(m["num_layers"]):
        out.append((f"layers.{i}", [(f"layers.{i}.{n}",) + tuple(rest)
                                    for n, *rest in layer_leaves(m)]))
    out.append(("final_norm", [_norm("final_norm.scale", d)]))
    if not m.get("tie_embeddings"):
        out.append(("lm_head", [("lm_head.w", (d, v), 0.0, 0.02, "model")]))
    return out


def key(seed: int, group: str) -> int:
    h = hashlib.sha256(f"{int(seed)}|{group}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def draw(m: Dict, seed: int, group: Tuple[str, List[Leaf]], device
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
