"""Atomic npz checkpointing for nested trees (the port of ``repro.checkpoint.checkpointer``).

Layout: one ``step_<n>/`` directory per checkpoint containing
``arrays_p<i>.npz`` (flattened keypath -> array) + ``meta.json`` (user
metadata).  Writes go to ``<dir>.tmp`` then ``os.replace`` — a crash
mid-write never corrupts the latest checkpoint.

The format is the reference's, byte for byte in its keys: a tree is nested
dicts, lists and tuples (``None`` is an empty subtree, as in a JAX pytree),
and a leaf's key is its path joined by ``/``, a dict key as itself and a
sequence index as ``[i]`` — ``jax.tree_util.tree_flatten_with_path``'s
names, with no JAX import.  So a checkpoint written here restores through
the reference's ``restore_pytree`` and the reverse.  The port's train state
crosses as the reference's tree (``models.convert.train_state_to_jax``),
and :func:`as_train_state` turns a restored tree back into the port's.

Leaves are numpy arrays or Python scalars.  A dtype npz cannot store is
upcast to float32 on save and cast back to the ``like`` leaf's dtype on
restore; the port's bfloat16 tensors reach the tree as float32 already
(``train_state_to_jax``), exact since bfloat16 is a subset of float32, and
:func:`as_train_state` casts them back.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import train_state_from_jax

__all__ = ["save_pytree", "restore_pytree", "tree_paths", "as_train_state"]


def _to_savable(arr: np.ndarray) -> np.ndarray:
    """npz can't store ml_dtypes (bfloat16 etc.); upcast to float32 — exact
    for bf16/f16 (strict subsets of fp32), cast back on restore."""
    if arr.dtype.kind not in "fiub" or arr.dtype.itemsize == 0:
        return arr.astype(np.float32)
    try:
        np.dtype(arr.dtype.name)  # native?
        return arr
    except TypeError:
        return arr.astype(np.float32)


def _leaves_with_paths(tree: Any, path: tuple = ()) -> list[tuple[str, Any]]:
    """(key, leaf) in a JAX pytree's flatten order: dict keys sorted,
    sequences in order, ``None`` leaves nothing."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves_with_paths(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _leaves_with_paths(v, path + (f"[{i}]",))]
    return [("/".join(path), tree)]


def _map_leaves(fn, tree: Any, path: tuple = ()) -> Any:
    """``tree`` with each leaf replaced by ``fn(key, leaf)``, containers kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, path + (f"[{i}]",)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _flatten_with_paths(tree: Any) -> dict[str, np.ndarray]:
    return {key: _to_savable(np.asarray(leaf)) for key, leaf in _leaves_with_paths(tree)}


def tree_paths(tree: Any) -> list[str]:
    return sorted(key for key, _ in _leaves_with_paths(tree))


def save_pytree(directory: str, tree: Any, metadata: dict | None = None, process_index: int = 0) -> str:
    """Atomically write ``tree`` (+ json-serializable ``metadata``)."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten_with_paths(tree)
    np.savez(os.path.join(tmp, f"arrays_p{process_index}.npz"), **flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"metadata": metadata or {}, "n_arrays": len(flat)}, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)
    return directory


def restore_pytree(directory: str, like: Any, process_index: int = 0) -> tuple[Any, dict]:
    """Restore into the structure (and dtypes) of ``like``, whose leaves are
    arrays or anything with a ``shape`` and a ``dtype`` (``models.convert.LeafSpec``).
    Returns (tree, metadata)."""
    path = os.path.join(directory, f"arrays_p{process_index}.npz")
    with np.load(path) as npz:
        stored = {k: npz[k] for k in npz.files}
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)["metadata"]

    flat_like = dict(_leaves_with_paths(like))
    missing = set(flat_like) - set(stored)
    extra = set(stored) - set(flat_like)
    if missing or extra:
        raise ValueError(
            f"checkpoint/tree mismatch: missing={sorted(missing)[:5]} extra={sorted(extra)[:5]}"
        )

    def restore(key: str, leaf: Any) -> Any:
        arr = stored[key]
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if arr.shape != shape:
            raise ValueError(f"{key}: shape {arr.shape} != expected {shape}")
        return arr.astype(leaf.dtype) if hasattr(leaf, "dtype") else arr

    return _map_leaves(restore, like), meta


def as_train_state(tree: dict, cfg: ModelConfig, device: torch.device, opt_dtypes: dict) -> dict:
    """The reference-shaped ``tree`` (numpy leaves) as a port train state on
    ``device``: ``opt_dtypes`` maps each per-parameter optimizer list
    (AdamW's ``mu``/``nu``) to its tensors' dtypes, so bfloat16 moments come
    back bfloat16, exactly; the parameters take their module's dtypes."""
    out = train_state_from_jax(tree, cfg, device)
    for key, dtypes in opt_dtypes.items():
        out["opt"][key] = [t.to(dt) for t, dt in zip(out["opt"][key], dtypes, strict=True)]
    return out
