"""Fault-tolerant checkpointing: the PyTorch counterpart of
``repro.train.checkpoint``, with the same on-disk format, so a checkpoint
written by either package restores in the other.

  * atomic publish: write to ``step_K.tmp/``, fsync, rename to ``step_K/``
    (a crash mid-write can never corrupt the latest checkpoint);
  * integrity: every array file gets a sha256 recorded in
    ``MANIFEST.json``; restore verifies and rejects corrupt checkpoints;
  * auto-resume: ``restore_latest`` walks checkpoints newest-first and
    returns the first one that verifies;
  * retention: keeps the newest ``keep`` checkpoints.

Arrays are stored leaf-per-file (``.npy``, named by the leaf's
``/``-joined path with ``__``) with the tree's paths in the manifest.
The trees are nested dicts of tensors (on any device) or numpy arrays in
the JAX layout (``bridge.state_to_jax``).  numpy's ``.npy`` has no bf16:
a bf16 leaf is stored as its ``uint16`` bits with ``"bfloat16"`` in the
manifest, as the JAX package stores it.  Leaves are copied to the host,
written and hashed in a few threads (the copies, ``np.save`` and
``hashlib`` release the interpreter lock), which leaves the format as it
is.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_WORKERS = 8


def _leafpaths(tree, prefix="") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the JAX package's order (sorted keys)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leafpaths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _unflatten(like, leaves: Dict[str, Any], prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    return leaves[prefix[:-1]]


def _stored(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array written to disk and its logical dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":           # an ml_dtypes array
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _torch_dtype(like) -> torch.dtype:
    """The torch dtype of a ``like`` leaf: a tensor, a numpy array or a
    dtype."""
    if isinstance(like, torch.dtype):
        return like
    if isinstance(like, torch.Tensor):
        return like.dtype
    name = np.dtype(like.dtype).name
    return torch.bfloat16 if name == "bfloat16" else getattr(torch, name)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointCorrupt(RuntimeError):
    pass


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        def write(item):
            key, leaf = item
            arr, dtype = _stored(leaf)
            fname = key.replace("/", "__") + ".npy"
            fpath = os.path.join(tmp, fname)
            np.save(fpath, arr, allow_pickle=False)
            return key, {"file": fname, "shape": list(arr.shape),
                         "dtype": dtype, "sha256": _sha256(fpath)}

        with ThreadPoolExecutor(_WORKERS) as pool:
            written = list(pool.map(write, _leafpaths(tree)))
        manifest: Dict[str, Any] = {"step": step, "leaves": dict(written)}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like`` (verifying hashes): CPU
        tensors of the dtypes of ``like``'s leaves (tensors, arrays or
        torch dtypes)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)

        def read(item):
            key, meta = item
            fpath = os.path.join(path, meta["file"])
            if _sha256(fpath) != meta["sha256"]:
                raise CheckpointCorrupt(f"{path}: bad hash for {key}")
            arr = np.load(fpath, allow_pickle=False)
            if meta["dtype"] == "bfloat16":
                return key, torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            return key, torch.from_numpy(arr)

        with ThreadPoolExecutor(_WORKERS) as pool:
            leaves = dict(pool.map(read, manifest["leaves"].items()))
        out = {}
        for key, leaf in _leafpaths(like):
            if key not in leaves:
                raise CheckpointCorrupt(f"{path}: missing leaf {key}")
            out[key] = leaves[key].to(_torch_dtype(leaf))
        return _unflatten(like, out)

    def restore_latest(self, like: Any) -> Optional[Tuple[int, Any]]:
        """Newest checkpoint that verifies; corrupt ones are skipped."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, like)
            except (CheckpointCorrupt, FileNotFoundError,
                    json.JSONDecodeError):
                continue
        return None
