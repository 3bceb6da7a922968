"""Param-tree checkpointing: npz payload + json manifest per step.

Port of ``repro/checkpoint/ckpt.py``, with its on-disk layout:
``<dir>/step_<n>/arrays.npz`` + ``<dir>/step_<n>/manifest.json``.  Arrays
are keyed by their "/"-joined tree path (dict keys in sorted order, list
and tuple indices), the reference's keys, so a checkpoint written by either
package restores in the other.  Restore validates the structure against a
template tree and casts to the template's dtypes and devices.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch.interop import tree_unflatten


def _flatten_with_path(tree, path=()):
    """(path, leaf) pairs in the reference's order: dicts by sorted key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def save_checkpoint(ckpt_dir: str, step: int, tree, metadata: dict | None = None):
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(out, exist_ok=True)
    arrays = {}
    for path, leaf in _flatten_with_path(tree):
        t = torch.as_tensor(leaf).detach()
        if t.dtype == torch.bfloat16:   # npz has no native bf16; upcast losslessly
            t = t.float()
        arrays[_path_str(path)] = t.cpu().numpy()
    np.savez(os.path.join(out, "arrays.npz"), **arrays)
    manifest = {"step": step, "keys": sorted(arrays), "metadata": metadata or {}}
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return out


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)$", d))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, template):
    """``template``'s tree with the checkpoint's arrays, each cast to its
    template leaf's dtype and moved to its device."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    data = np.load(path)
    leaves = []
    for p, leaf in _flatten_with_path(template):
        key = _path_str(p)
        if key not in data:
            raise KeyError(f"checkpoint missing {key}")
        arr = data[key]
        shape = tuple(leaf.shape)
        if arr.shape != shape:
            raise ValueError(f"{key}: shape {arr.shape} != template {shape}")
        leaves.append(torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(template, leaves)
