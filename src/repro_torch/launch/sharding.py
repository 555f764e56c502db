"""Sharding rules: the PyTorch counterpart of ``repro.launch.sharding``.

The rule tables are the JAX package's, entry for entry:

  * TP (``model`` axis): attention q-heads, MLP hidden, MoE experts (EP
    reuses the TP axis), RG-LRU recurrence width, RWKV heads, vocab;
  * FSDP (``data`` axis): the d_model dimension of every weight;
  * GQA KV projections are replicated across ``model``;
  * decode KV caches: batch on the DP axes, sequence chunks on ``model``
    (flash-decode sharding).

An axis is used only where it divides the dimension; otherwise that
dimension is replicated.

A spec is a tuple with one entry per dimension: ``None``, an axis name or
a tuple of axis names, the entries of the JAX package's
``PartitionSpec`` (``()`` replicates the whole leaf).  The functions take
any mesh with ``.shape`` (axis -> size) and ``.axis_names``, or a
``DeviceMesh``, so the rules run without a process group.

Trees are nested dicts and lists of tensors (meta tensors serve).  A leaf
is matched by its key path, ``/``-joined; the port's per-layer lists are
keyed as the JAX package keys its stacked layers (``layers/<l>`` becomes
``periods/b<i>`` or ``tail/t<i>``, ``enc_layers/<l>`` ``enc_layers``), so
every rule matches the same leaves in both packages.  A layer leaf lacks
the JAX leaf's leading stacked axis; the rules align from the right, so
its spec is the JAX spec without that leading ``None``.

:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh`` and :func:`distribute` places a tree by its specs.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.configs import base as cfgs

Spec = Tuple[Any, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """axis -> size, of a ``DeviceMesh`` or of a mesh with a ``.shape``
    mapping."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def _fit(mesh, shape, want: Sequence[Any]) -> Spec:
    """A spec for ``shape``, dropping axes that don't divide their dim."""
    spec = []
    for dim, axis in zip(shape, want):
        if axis is None or dim % _axis_size(mesh, axis):
            spec.append(None)
        else:
            spec.append(axis)
    return tuple(spec)


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _key_of(path, cfg: Optional[cfgs.ModelConfig] = None) -> str:
    """The JAX package's ``_key_of`` string of a port key path: per-layer
    list indices become the stacked layout's names (``cfg`` says where the
    periods end and the tail begins)."""
    out = []
    i = 0
    while i < len(path):
        p = path[i]
        nxt = path[i + 1] if i + 1 < len(path) else None
        if p in ("layers", "enc_layers", "dec_layers") and isinstance(nxt,
                                                                      int):
            if p != "layers":
                out.append(p)
            else:
                if cfg is None:
                    raise ValueError("keying a per-layer param tree needs "
                                     "its config (cfg=)")
                n = len(cfg.period)
                body = cfg.num_periods * n
                out += (["periods", f"b{nxt % n}"] if nxt < body
                        else ["tail", f"t{nxt - body}"])
            i += 2
            continue
        out.append(str(p))
        i += 1
    return "/".join(out)


# ---------------------------------------------------------------------------
# parameter rules (the JAX package's table)
# ---------------------------------------------------------------------------

# (regex on the leaf path, want-spec); `F`=fsdp, `T`=tp.  The want list is
# right-aligned to the leaf's shape.
_PARAM_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    (r"embed/w$",                       ("T", "F")),
    (r"lm_head/w$",                     ("F", "T")),
    (r"(pos_embed|enc_pos)/w$",         (None, "F")),
    # attention
    (r"attn/wq$",                       ("F", "T")),
    (r"x?attn/w[kv]$",                  ("F", None)),
    (r"attn/wo$",                       ("T", "F")),
    (r"xattn/wq$",                      ("F", "T")),
    (r"xattn/wo$",                      ("T", "F")),
    (r"attn/bq$",                       ("T",)),
    (r"attn/b[kvo]$",                   (None,)),
    # dense MLP
    (r"mlp/w[ig]$",                     ("F", "T")),
    (r"mlp/wo$",                        ("T", "F")),
    (r"mlp/b[ig]$",                     ("T",)),
    (r"mlp/bo$",                        (None,)),
    # MoE (EP on the model axis)
    (r"router/w$",                      ("F", None)),
    (r"experts/w[ig]$",                 ("T", "F", None)),
    (r"experts/wo$",                    ("T", None, "F")),
    (r"shared/w[ig]$",                  ("F", "T")),
    (r"shared/wo$",                     ("T", "F")),
    (r"shared/b[ig]$",                  ("T",)),
    (r"shared/bo$",                     (None,)),
    # RG-LRU
    (r"rec/in_(x|gate)$",               ("F", "T")),
    (r"rec/out$",                       ("T", "F")),
    (r"rec/conv_w$",                    (None, "T")),
    (r"rec/(conv_b|a_param|[ir]_gate_[wb])$", ("T",)),
    # RWKV6
    (r"tmix/w[rkvgw]$",                 ("F", "T")),
    (r"tmix/ww$",                       ("F", "T")),
    (r"tmix/wo$",                       ("T", "F")),
    (r"tmix/u$",                        ("T", None)),
    (r"tmix/(mu_.|w0|gn_scale|gn_bias)$", (None,)),
    (r"cmix/wk$",                       ("F", "T")),
    (r"cmix/wv$",                       ("T", "F")),
    (r"cmix/mu_k$",                     (None,)),
)


def param_spec(mesh, key: str, shape, *, fsdp, tp) -> Spec:
    # optimizer moments share the param layout
    key = re.sub(r"^(mu|nu)/", "", key)
    for pat, want in _PARAM_RULES:
        if re.search(pat, key):
            aligned = [None] * (len(shape) - len(want)) + [
                {"F": fsdp, "T": tp, None: None}[w] for w in want]
            return _fit(mesh, shape, aligned)
    return ()           # norms, scalars, anything unmatched: replicate


def state_specs(mesh, state_tree, *, cfg: Optional[cfgs.ModelConfig] = None
                ) -> Any:
    """Specs for a train state ``{"params", "opt_state": {"mu", "nu",
    "count"}, "step"}`` (params and AdamW moments)."""
    def one(path, leaf):
        key = re.sub(r"^(params|opt_state)/", "", _key_of(path, cfg))
        if key in ("count", "step"):
            return ()
        return param_spec(mesh, key, tuple(leaf.shape), fsdp="data",
                          tp="model")
    return _tree_map_with_path(one, state_tree)


def param_specs(mesh, params_tree, *, fsdp: Any = "data",
                cfg: Optional[cfgs.ModelConfig] = None) -> Any:
    """Param specs.  Training uses fsdp="data" (ZeRO-3 layout).  Serving
    passes fsdp=None: weights TP-sharded only and replicated across the DP
    axes."""
    def one(path, leaf):
        return param_spec(mesh, _key_of(path, cfg), tuple(leaf.shape),
                          fsdp=fsdp, tp="model")
    return _tree_map_with_path(one, params_tree)


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------


def _dp_axis(mesh):
    dp = tuple(a for a in axis_names(mesh) if a != "model")
    return dp if len(dp) > 1 else dp[0]


def batch_specs(mesh, batch_tree) -> Any:
    """Shard the leading (batch) dim over all DP axes (divisibility-gated)."""
    dp_ax = _dp_axis(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        return _fit(mesh, shape, [dp_ax] + [None] * (len(shape) - 1))
    return _tree_map_with_path(one, batch_tree)


_CACHE_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    # attention KV: [..., B, S, KV, hd]: batch on DP, sequence on model
    (r"/x?k$|/x?v$|^k$|^v$|^xk$|^xv$",  ("B", "S", None, None)),
    # RG-LRU state: h [B, W], conv [B, cw-1, W]
    (r"/h$",                            ("B", "S")),
    (r"/conv$",                         ("B", None, "S")),
    # RWKV state: s [B, H, hd, hd], shift [B, D]
    (r"/s$",                            ("B", "S", None, None)),
    (r"/shift_[tc]$",                   ("B", None)),
    (r"len$",                           ("B",)),
)


def cache_specs_tree(mesh, cache_tree) -> Any:
    """KV / state cache specs: batch over the DP axes, the large state axis
    (sequence / recurrence width / heads) over ``model``."""
    sub = {"B": _dp_axis(mesh), "S": "model", None: None}

    def one(path, leaf):
        key = _key_of(path)
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        for pat, want in _CACHE_RULES:
            if re.search(pat, key):
                aligned = [None] * (len(shape) - len(want)) + [
                    sub[w] for w in want]
                return _fit(mesh, shape, aligned)
        return ()
    return _tree_map_with_path(one, cache_tree)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh, spec: Spec):
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh axis,
    ``Shard(d)`` where dimension ``d``'s entry names it, else
    ``Replicate()``.  An axis of size 1 is always ``Replicate()`` (its one
    shard is the whole), so two specs that differ only there place a
    tensor alike."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    out = []
    for name in axis_names(mesh):
        dim = next((d for d, a in enumerate(spec)
                    if a == name or (isinstance(a, tuple) and name in a)),
                   None)
        out.append(Replicate() if dim is None or sizes[name] == 1
                   else Shard(dim))
    return tuple(out)


def distribute(mesh, tree, specs):
    """Place every leaf of ``tree`` on ``mesh`` by its spec in ``specs``
    (a tree of the same structure) and return the tree of DTensors.  Each
    rank keeps its own slice of the tensor it holds (no communication), so
    every rank must hold the same tensors: draw them from the same
    generator and seed.  The leaves are replaced in place, so each full
    tensor is freed as soon as its slice is taken."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(t, s):
        pl = placements(mesh, s)
        d = distribute_tensor(t, mesh, pl, src_data_rank=None)
        loc = d.to_local()
        if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
            # a slice along the leading dim is a view of the full tensor:
            # copy it, so the full tensor's memory goes with it
            d = DTensor.from_local(loc.clone(), mesh, pl, run_check=False,
                                   shape=d.shape, stride=d.stride())
        return d

    def walk(t, s):
        if isinstance(t, dict):
            for k in list(t):
                t[k] = walk(t[k], s[k])
            return t
        if isinstance(t, list):
            for i in range(len(t)):
                t[i] = walk(t[i], s[i])
            return t
        return place(t, s)
    return walk(tree, specs)
