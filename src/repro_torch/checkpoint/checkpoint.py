"""Atomic sharded checkpointing with restart-from-latest.

Layout (one directory per step):
    <dir>/step_000120.tmp/...     (write in progress)
    <dir>/step_000120/
        manifest.json             {step, leaf paths, shapes, dtypes, checksum}
        <leaf-path>.npy           one file per pytree leaf

Atomicity: leaves + manifest are written into a ``.tmp`` directory which is
os.rename()'d to its final name — a crashed writer never leaves a directory
that ``latest_step`` would pick up. ``keep`` bounds disk usage.

The port's counterpart of the JAX package's ``checkpoint/checkpoint.py``,
with its on-disk layout: the same directories, manifest and leaf paths
(dicts by sorted key, NamedTuples by field, lists by index), so that a
checkpoint written by either package loads in the other. Leaves are torch
tensors (any device; written from the host) or anything numpy takes.
bfloat16 leaves are written as JAX's writer writes them (numpy has no
bfloat16: two-byte void records under a ``<V2`` header, ``bfloat16`` in the
manifest) and read back through a 16-bit view, without ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"

#: dtypes numpy lacks, by their name in a manifest: the leaf is stored as
#: void records of the type's width and read back through this view
_VOID_DTYPES = {"bfloat16": torch.bfloat16}


def _flatten(tree, prefix=()) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)) or hasattr(tree, "_fields"):
        items = tree._asdict().items() if hasattr(tree, "_asdict") \
            else enumerate(tree)
        out = []
        for k, v in items:
            out.extend(_flatten(v, prefix + (str(k),)))
        return out
    return [("/".join(prefix), tree)]


def _save_leaf(path: str, leaf: Any) -> Tuple[List[int], str, bytes]:
    """Writes one ``.npy`` file; returns (shape, dtype name, raw bytes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _VOID_DTYPES.values():
            name = next(k for k, v in _VOID_DTYPES.items() if v == t.dtype)
            raw = t.view(torch.int16).numpy().tobytes()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(f, {
                    "descr": f"<V{t.element_size()}",
                    "fortran_order": False, "shape": tuple(t.shape)})
                f.write(raw)
            return list(t.shape), name, raw
        leaf = t.numpy()
    arr = np.asarray(leaf)
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype), arr.tobytes()


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = _flatten(tree)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for path, leaf in leaves:
        fname = path.replace("/", "__") + ".npy"
        shape, dtype, raw = _save_leaf(os.path.join(tmp, fname), leaf)
        manifest["leaves"].append({
            "path": path, "file": fname,
            "shape": shape, "dtype": dtype,
            "checksum": int(np.uint64(abs(hash(raw)) & 0xFFFFFFFF)),
        })
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    _gc(directory, keep)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, name, MANIFEST)):
            steps.append(int(name[5:]))
    return max(steps) if steps else None


def _load_leaf(path: str, entry: Dict[str, Any]) -> torch.Tensor:
    arr = np.load(path)
    if arr.dtype.kind == "V":
        # bfloat16 leaves save as raw void records: reinterpret from the
        # manifest's dtype name through an integer view of the same width
        dtype = _VOID_DTYPES.get(entry["dtype"])
        if dtype is None or arr.dtype.itemsize != 2:
            raise TypeError(f"checkpoint leaf {entry['path']} has dtype "
                            f"{entry['dtype']!r}, which the port does not "
                            f"read (it reads {sorted(_VOID_DTYPES)})")
        arr = np.require(arr, requirements=["C", "W"]).view(np.int16)
        return torch.from_numpy(arr).view(dtype)
    return torch.from_numpy(np.require(arr, requirements=["C", "W"]))


def load_checkpoint(directory: str, step: Optional[int] = None,
                    like: Any = None) -> Tuple[int, Any, Dict[str, Any]]:
    """Returns (step, tree, extra): without ``like``, {leaf path: CPU
    tensor}. With ``like`` given, the loaded leaves are reassembled into
    that pytree structure; a tensor of ``like`` gives its leaf's dtype and
    device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    root = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(root, MANIFEST)) as f:
        manifest = json.load(f)
    flat = {}
    for entry in manifest["leaves"]:
        t = _load_leaf(os.path.join(root, entry["file"]), entry)
        if list(t.shape) != entry["shape"]:
            raise IOError(f"corrupt checkpoint leaf {entry['path']}")
        flat[entry["path"]] = t
    if like is None:
        return step, flat, manifest["extra"]

    like_flat = _flatten(like)
    missing = [p for p, _ in like_flat if p not in flat]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}")
    rebuilt = _unflatten(like, {p: flat[p] for p, _ in like_flat})
    return step, rebuilt, manifest["extra"]


def _unflatten(like: Any, flat: Dict[str, torch.Tensor], prefix=()):
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),))
                for k, v in like.items()}
    if hasattr(like, "_fields"):
        vals = {k: _unflatten(v, flat, prefix + (str(k),))
                for k, v in like._asdict().items()}
        return type(like)(**vals)
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, flat, prefix + (str(i),))
                          for i, v in enumerate(like))
    t = flat["/".join(prefix)]
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        int(n[5:]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


@dataclass
class CheckpointManager:
    directory: str
    interval: int = 100
    keep: int = 3

    def maybe_save(self, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        if step % self.interval == 0 and step > 0:
            return save_checkpoint(self.directory, step, tree, extra, self.keep)
        return None

    def restore_or_none(self, like: Any = None):
        step = latest_step(self.directory)
        if step is None:
            return None
        return load_checkpoint(self.directory, step, like)
