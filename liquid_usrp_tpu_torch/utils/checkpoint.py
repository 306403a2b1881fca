"""Checkpoint/resume for streaming pipeline state.

Port of ``liquid_usrp_tpu/utils/checkpoint.py``.  Every operator carries its
state explicitly (synchronizer tails, stream counters, NCO phases), so a
long run checkpoints and resumes bit-exactly with a generic dump of a tree
of tensors: NamedTuples, dicts (keys in sorted order, as JAX flattens them),
lists and tuples.  The ``.npz`` layout is JAX's: ``leaf_i`` in flatten
order plus a structure tag; the tag is the port's own, so a file written by
the JAX package does not load here.
"""
from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["save_state", "load_state"]


def _norm(path: str) -> str:
    """np.savez appends '.npz' to bare paths; normalize so save/load agree."""
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s tensors to ``leaves``; return its structure tag."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        inner = ",".join(f"{k}={_flatten(v, leaves)}"
                         for k, v in zip(tree._fields, tree))
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, dict):
        inner = ",".join(f"{k}={_flatten(tree[k], leaves)}"
                         for k in sorted(tree))
        return f"dict({inner})"
    if isinstance(tree, (list, tuple)):
        inner = ",".join(_flatten(v, leaves) for v in tree)
        return f"{type(tree).__name__}({inner})"
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"state leaf of type {type(tree).__name__} is not a "
                        f"tensor")
    leaves.append(tree)
    return "*"


def _unflatten(like, leaves):
    """``like``'s structure with its tensors taken in order from the
    iterator ``leaves``."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def save_state(path: str, state) -> None:
    """Serialize a tree of tensors to ``path`` (.npz + structure tag)."""
    leaves: list = []
    tag = _flatten(state, leaves)
    arrays = {f"leaf_{i}": v.detach().cpu().numpy()
              for i, v in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(json.dumps(tag).encode(),
                                          dtype=np.uint8)
    np.savez(_norm(path), **arrays)


def load_state(path: str, like):
    """Load a checkpoint into the structure of ``like`` (same pipeline
    config); each tensor goes to the device of its ``like`` counterpart.
    A different structure, leaf count, shape or dtype raises."""
    like_leaves: list = []
    tag = _flatten(like, like_leaves)
    with np.load(_norm(path)) as data:
        n = len(like_leaves)
        n_stored = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_stored != n:
            raise ValueError(
                f"checkpoint holds {n_stored} leaves, pipeline state has "
                f"{n} — config mismatch")
        stored = json.loads(bytes(data["__treedef__"]).decode())
        if stored != tag:
            raise ValueError(
                "checkpoint structure differs from the pipeline state — "
                f"config mismatch\n  stored:  {stored}\n  current: {tag}")
        out = []
        for i, ref in enumerate(like_leaves):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint leaf {i} shape {arr.shape} != pipeline "
                    f"state shape {tuple(ref.shape)} — config mismatch")
            want = torch.empty(0, dtype=ref.dtype).numpy().dtype
            if arr.dtype != want:
                raise ValueError(
                    f"checkpoint leaf {i} dtype {arr.dtype} != pipeline "
                    f"state dtype {want} — config mismatch")
            out.append(torch.from_numpy(arr).to(ref.device))
    return _unflatten(like, iter(out))
