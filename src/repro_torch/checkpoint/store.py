"""Fault-tolerant checkpointing: atomic npz + manifest, retention, resume
(counterpart of ``repro.checkpoint.store``, the same protocol and files).

Write protocol (crash-safe at every point):
  1. serialize the tree's leaves to ``step_N.npz.tmp``
  2. fsync + atomic ``rename`` to ``step_N.npz``
  3. rewrite ``manifest.json`` (atomic rename) listing the new step
A torn write can only ever lose the newest checkpoint, never corrupt an
older one; ``latest_step`` only trusts steps listed in the manifest whose
file exists.

Trees are the port's nested dicts and lists of tensors.  Leaves are
stored as ``leaf_<i>`` in ``repro_torch.tree.tree_leaves`` order (dict
keys sorted, lists in index order, depth first), as numpy arrays; numpy
has no bfloat16, so bf16 leaves are stored as f32, exactly.  A restored
leaf takes the dtype and device of its ``like`` leaf.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..tree import tree_leaves, tree_unflatten


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree) -> None:
    arrays = {f"leaf_{i}": _to_numpy(x)
              for i, x in enumerate(tree_leaves(tree))}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def restore_pytree(path: str, like) -> object:
    """The tree saved at ``path``, in ``like``'s structure, each leaf with
    its ``like`` leaf's dtype and device; a leaf count or shape that
    differs raises ``ValueError``."""
    leaves = tree_leaves(like)
    with np.load(path) as data:
        if len(data.files) != len(leaves):
            raise ValueError(
                f"checkpoint {path} has {len(data.files)} leaves, "
                f"expected {len(leaves)}")
        new = [data[f"leaf_{i}"] for i in range(len(leaves))]
    for a, b in zip(new, leaves):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"leaf shape mismatch: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
    return tree_unflatten(like, [
        torch.from_numpy(a).to(device=b.device, dtype=b.dtype)
        for a, b in zip(new, leaves)])


def _manifest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "manifest.json")


def latest_step(ckpt_dir: str) -> int | None:
    mf = _manifest_path(ckpt_dir)
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        manifest = json.load(f)
    for step in sorted(manifest.get("steps", []), reverse=True):
        if os.path.exists(os.path.join(ckpt_dir, f"step_{step}.npz")):
            return int(step)
    return None


class CheckpointManager:
    """Step-indexed checkpoints with retention and resume."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.npz")

    def save(self, step: int, tree) -> None:
        save_pytree(self._path(step), tree)
        mf = _manifest_path(self.dir)
        steps = []
        if os.path.exists(mf):
            with open(mf) as f:
                steps = json.load(f).get("steps", [])
        steps = sorted(set(steps + [step]))
        # retention: drop oldest beyond `keep`
        drop, steps = steps[:-self.keep], steps[-self.keep:]
        tmp = mf + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"steps": steps}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, mf)
        for s in drop:
            try:
                os.remove(self._path(s))
            except FileNotFoundError:
                pass

    def restore_latest(self, like) -> tuple[int, object] | None:
        step = latest_step(self.dir)
        if step is None:
            return None
        return step, restore_pytree(self._path(step), like)
