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

Under a mesh (``specs`` and ``mesh`` given) a tree is this rank's blocks
(``distributed.sharding``: params, ZeRO-1 moments, a sequence-split
cache) and every rank calls in the same order.  The file is the one a
single-shard run writes, whole leaves: each leaf is put together from
the ranks' blocks (``whole_leaf``) and written before the next, so a
rank holds its blocks plus about one whole leaf; rank 0 writes, with
the same tmp, fsync and rename, and every rank waits on a barrier
before the call returns (so ``latest_step`` trusts a step every rank has
finished).  A restore reads each whole leaf on every rank and keeps the
rank's block (``rank_block``), so a file written on one mesh restores on
another.
"""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.sharding import FUSED, rank_block, whole_leaf
from ..tree import tree_leaves, tree_unflatten


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _with_specs(tree, specs, name=""):
    """(leaf, spec, fused) of every leaf of ``tree``, in ``tree_leaves``
    order, ``specs`` walked alongside."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _with_specs(tree[k], specs[k], str(k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, node in enumerate(tree)
                for x in _with_specs(node, specs[i], name)]
    return [(tree, specs, name in FUSED)]


def _sharded(mesh) -> bool:
    return mesh is not None and dist.is_initialized()


def save_pytree(path: str, tree, specs=None, mesh=None) -> None:
    """Write ``tree``'s leaves to ``path``; under a mesh (``specs`` and
    ``mesh``: module docstring) ``tree`` is the rank's blocks and the
    file holds the whole leaves."""
    tmp = path + ".tmp"
    if not _sharded(mesh):
        arrays = {f"leaf_{i}": _to_numpy(x)
                  for i, x in enumerate(tree_leaves(tree))}
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return
    writer = dist.get_rank() == 0
    f = open(tmp, "wb") if writer else None
    try:
        # np.savez's layout: one stored .npy entry a leaf, in order.
        zf = zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) \
            if writer else None
        for i, (block, spec, fused) in enumerate(_with_specs(tree, specs)):
            whole = whole_leaf(block, spec, mesh, fused)
            if writer:
                with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as entry:
                    np.lib.format.write_array(entry, _to_numpy(whole),
                                              allow_pickle=False)
            del whole
        if writer:
            zf.close()
            f.flush()
            os.fsync(f.fileno())
    finally:
        if f is not None:
            f.close()
    if writer:
        os.replace(tmp, path)
    dist.barrier()


def restore_pytree(path: str, like, specs=None, mesh=None) -> object:
    """The tree saved at ``path``, in ``like``'s structure, each leaf with
    its ``like`` leaf's dtype and device; a leaf count or shape that
    differs raises ``ValueError``.  Under a mesh ``like`` is the rank's
    blocks, and each leaf comes back as the rank's block of the saved
    whole (module docstring)."""
    leaves = tree_leaves(like)
    sharded = _sharded(mesh)
    cut = _with_specs(like, specs) if sharded else None
    new = []
    with np.load(path) as data:
        if len(data.files) != len(leaves):
            raise ValueError(
                f"checkpoint {path} has {len(data.files)} leaves, "
                f"expected {len(leaves)}")
        for i, b in enumerate(leaves):
            a = data[f"leaf_{i}"]
            if sharded:     # one whole leaf at a time
                _, spec, fused = cut[i]
                a = rank_block(torch.from_numpy(a), spec, mesh, fused)
            if tuple(a.shape) != tuple(b.shape):
                raise ValueError(f"leaf shape mismatch: {tuple(a.shape)} "
                                 f"vs {tuple(b.shape)}")
            new.append(torch.as_tensor(a).to(device=b.device, dtype=b.dtype))
    return tree_unflatten(like, new)


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

    def save(self, step: int, tree, specs=None, mesh=None) -> None:
        """Write step ``step``; under a mesh every rank calls with its
        blocks (module docstring), rank 0 writes the file and the
        manifest, and all return together."""
        save_pytree(self._path(step), tree, specs, mesh)
        if _sharded(mesh):
            if dist.get_rank() == 0:
                self._record(step)
            dist.barrier()
        else:
            self._record(step)

    def _record(self, step: int) -> None:
        """List ``step`` in the manifest; drop the oldest beyond ``keep``."""
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

    def restore_latest(self, like, specs=None,
                       mesh=None) -> tuple[int, object] | None:
        step = latest_step(self.dir)
        if step is None:
            return None
        return step, restore_pytree(self._path(step), like, specs, mesh)
