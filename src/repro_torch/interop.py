"""Carry parameter trees across: numpy <-> torch, keeping key paths.

A tree is nested dicts, lists and tuples with arrays at the leaves, as the
reference keeps its params; ``jax.tree.map(np.asarray, params)`` on the
reference side gives exactly what ``params_from_numpy`` takes.  Complex
leaves (the cached key spectrum ``keys_fft``) become complex64, every other
floating leaf keeps its dtype.  Also the small tree helpers the port uses
where the reference used ``jax.tree``.
"""
from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of the same structure.  Dicts are
    walked in sorted key order, as ``jax.tree`` walks them, so leaf lists
    line up with the reference's."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the traversal order of :func:`tree_map`."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves) -> object:
    """Rebuild ``tree``'s structure with ``leaves`` in traversal order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _to_torch(x, device):
    a = np.asarray(x)
    if np.iscomplexobj(a):
        a = a.astype(np.complex64)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (the reference's leaves carry
        # ml_dtypes' type): carry the bits across as int16
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device="cuda", mesh=None):
    """numpy (or array-like) leaves -> tensors on ``device``, same key paths.
    With ``mesh`` (a ``launch.mesh.make_host_mesh`` mesh on ``device``'s
    type), each leaf is then placed on it as a DTensor by
    ``sharding.rules.param_shardings``: every rank passes the same whole
    tree and keeps its shard."""
    out = tree_map(lambda x: _to_torch(x, device), tree)
    if mesh is None:
        return out
    from repro_torch.sharding import rules
    return rules.distribute_tree(out, rules.param_shardings(out, mesh), mesh)


def _whole(t):
    """A DTensor's whole value (``full_tensor()``, a collective every rank
    joins), or ``t``."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def params_to_numpy(tree):
    """Tensor leaves -> numpy arrays on the host, same key paths; a DTensor
    leaf becomes its whole value (every rank must call this)."""
    return tree_map(lambda t: _whole(t.detach()).cpu().numpy(), tree)
