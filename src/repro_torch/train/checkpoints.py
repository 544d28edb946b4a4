"""Checkpointing: numpy archives of pytrees with the reference's manifest.

Layout of a checkpoint directory::

    <dir>/
      step_00000060/
        manifest.json   # step, leaf keys, shapes/dtypes, tree structure, metadata
        arrays.npz      # the leaves, in manifest order (arr_0, arr_1, ...)

The manifest is the reference's (``repro/train/checkpoints.py``); the
leaves go into an ``np.savez`` archive where the reference packs raw
buffers with msgpack. A leaf may be a tensor on any device (it is copied
to the host) or an array, or a function of no arguments that returns one
when the writer reaches it; leaves are written and read one at a time,
and come back as numpy arrays in the structure of a template. Pytrees
here are tensors, arrays, dicts (keys in sorted order, as
``jax.tree_util`` orders them), lists and tuples.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Any

import numpy as np
import torch

PyTree = Any

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "tree_leaves",
           "CheckpointManager"]

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


def _flatten_with_keys(tree: PyTree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs in ``jax.tree_util`` order, keys in its
    ``keystr`` form (``['theta']``, ``[0]``)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten_with_keys(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten_with_keys(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_leaves(tree: PyTree) -> list:
    """The leaves of ``tree`` in the order ``save_checkpoint`` writes them."""
    return [leaf for _, leaf in _flatten_with_keys(tree)]


def _structure(tree: PyTree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _unflatten(like: PyTree, leaves: list) -> PyTree:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 leaf has no numpy dtype; cast it before checkpointing")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree: PyTree, metadata: dict | None = None) -> str:
    """Write ``tree`` under ``directory/step_<step>``; returns the path.
    One leaf is on the host at a time: each is copied, written into the
    archive (``np.savez``'s layout) and dropped before the next; a
    function leaf is called when its turn comes."""
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    pairs = _flatten_with_keys(tree)
    shapes, dtypes = [], []
    with zipfile.ZipFile(os.path.join(path, _ARRAYS), "w", zipfile.ZIP_STORED,
                         allowZip64=True) as archive:
        for i, (_, leaf) in enumerate(pairs):
            arr = _to_numpy(leaf() if callable(leaf) else leaf)
            with archive.open(f"arr_{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            shapes.append(list(arr.shape))
            dtypes.append(str(arr.dtype))
            del arr
    manifest = {
        "step": step,
        "keys": [k for k, _ in pairs],
        "shapes": shapes,
        "dtypes": dtypes,
        "treedef": _structure(tree),
        "metadata": metadata or {},
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    return path


def restore_checkpoint(directory: str, step: int, like: PyTree,
                       select=None) -> tuple[PyTree, dict]:
    """Restore into the structure of ``like`` (shapes validated); returns
    ``(tree of numpy arrays, metadata)``. Leaves are read one at a time;
    ``select(array, template_leaf)``, where given, replaces each as it is
    read, so a reader may keep only the part it needs."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves_like = [leaf for _, leaf in _flatten_with_keys(like)]
    leaves = []
    with np.load(os.path.join(path, _ARRAYS)) as archive:
        if len(archive.files) != len(leaves_like):
            raise ValueError(
                f"checkpoint has {len(archive.files)} leaves, template has {len(leaves_like)}"
            )
        for i, (shape, dtype, tmpl) in enumerate(zip(manifest["shapes"], manifest["dtypes"],
                                                     leaves_like)):
            arr = archive[f"arr_{i}"].astype(np.dtype(dtype), copy=False).reshape(shape)
            t_shape = tuple(tmpl.shape) if hasattr(tmpl, "shape") else tuple(np.shape(tmpl))
            if t_shape != tuple(shape):
                raise ValueError(f"shape mismatch: checkpoint {shape} vs template {t_shape}")
            leaves.append(arr if select is None else select(arr, tmpl))
    return _unflatten(like, leaves), manifest["metadata"]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(directory)
        if name.startswith("step_")
    ]
    return max(steps) if steps else None


@dataclasses.dataclass
class CheckpointManager:
    """Keeps the most recent ``max_to_keep`` checkpoints."""

    directory: str
    max_to_keep: int = 3

    def save(self, step: int, tree: PyTree, metadata: dict | None = None) -> str:
        path = save_checkpoint(self.directory, step, tree, metadata)
        self._gc()
        return path

    def restore_latest(self, like: PyTree) -> tuple[int, PyTree, dict] | None:
        step = latest_step(self.directory)
        if step is None:
            return None
        tree, meta = restore_checkpoint(self.directory, step, like)
        return step, tree, meta

    def _gc(self) -> None:
        steps = sorted(
            int(name.split("_")[1])
            for name in os.listdir(self.directory)
            if name.startswith("step_")
        )
        for s in steps[: -self.max_to_keep]:
            p = os.path.join(self.directory, f"step_{s:08d}")
            for fn in os.listdir(p):
                os.remove(os.path.join(p, fn))
            os.rmdir(p)
