"""Divisibility-safe partition rules for every param/cache/batch tensor.

Port of ``repro/sharding/rules.py``.  Name-based rules produce a spec for
the *trailing* dims of each leaf; leading stack axes (superblocks,
pipeline stages) are padded with None.  Every axis assignment is guarded:
if the dim is not divisible by the mesh axis size, it falls back to
replication, so every (arch x shape x mesh) combination places.

A spec is a plain tuple whose entries equal the reference's
``PartitionSpec`` entries: None, an axis name, or a tuple of names such as
``("pod", "data")`` (one tensor dim over several mesh axes, major to
minor).  The rules read only a mesh's ``.shape`` (a dict of axis sizes)
and ``.axis_names``, so they run on a device-free ``launch.mesh.MeshShape``
as on a ``DeviceMesh`` (``launch.mesh.make_host_mesh`` gives one with both
attributes).  :func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``; :func:`distribute_tree` places a tree of tensors by a tree
of specs.

Modes:
  train  — params: tensor-parallel over "model"; optimizer state
           additionally ZeRO-1-sharded over "data" on the largest
           still-replicated dim.
  decode — params fully sharded (model rules + "data" on another dim,
           FSDP-style); caches: batch over "data", long axes over "model".
"""
from __future__ import annotations

import math
import re

from repro_torch.interop import tree_map


def _dims(mesh, axis) -> int:
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _guard(spec: tuple, shape, mesh) -> tuple:
    """Replicate any spec entry whose dim is not divisible by its axes."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, entries):
        if ax is None:
            out.append(None)
        elif dim % _dims(mesh, ax) == 0 and dim >= _dims(mesh, ax):
            out.append(ax)
        else:
            out.append(None)
    return tuple(out)


# rule: (path regex, trailing spec) — first match wins.  The spec applies to
# the LAST len(spec) dims of the leaf.
_PARAM_RULES: list[tuple[str, tuple]] = [
    # --- embeddings / head -------------------------------------------------
    (r"/embed$",               ("model", None)),
    (r"/head$",                (None, "model")),
    (r"frontend_proj$",        (None, "model")),
    # --- MoE (expert parallelism over the E axis) ---------------------------
    (r"/router$",              (None, None)),
    (r"moe/w_(gate|up|down)$", ("model", None, None)),
    (r"moe/shared/w_(gate|up)$", (None, "model")),
    (r"moe/shared/w_down$",    ("model", None)),
    # --- MLA ----------------------------------------------------------------
    (r"mla/w_q$",              (None, "model")),
    (r"mla/w_dkv$",            (None, None)),
    (r"mla/w_uk$",             (None, "model")),
    (r"mla/w_uv$",             (None, "model")),
    (r"mla/w_kpe$",            (None, None)),
    (r"mla/w_o$",              ("model", None)),
    # --- RWKV ----------------------------------------------------------------
    (r"rwkv_tm/w_(r|k|v|g)$",  (None, "model")),
    (r"rwkv_tm/w_o$",          ("model", None)),
    (r"rwkv_tm/w_dec_a$",      (None, None)),
    (r"rwkv_tm/w_dec_b$",      (None, "model")),
    (r"rwkv_tm/(w0|ln_scale)$", ("model",)),
    (r"rwkv_tm/u$",            ("model", None)),
    (r"rwkv_cm/w_k$",          (None, "model")),
    (r"rwkv_cm/w_v$",          ("model", None)),
    (r"rwkv_cm/w_r$",          (None, "model")),
    # --- Mamba ----------------------------------------------------------------
    (r"mamba/w_in$",           (None, "model")),
    (r"mamba/conv_w$",         (None, "model")),
    (r"mamba/conv_b$",         ("model",)),
    (r"mamba/w_x$",            ("model", None)),
    (r"mamba/w_dt$",           (None, "model")),
    (r"mamba/dt_bias$",        ("model",)),
    (r"mamba/A_log$",          ("model", None)),
    (r"mamba/D$",              ("model",)),
    (r"mamba/w_out$",          ("model", None)),
    # --- attention (GQA + cross) ----------------------------------------------
    (r"/w_q$",                 (None, "model")),
    (r"/w_k$",                 (None, "model")),
    (r"/w_v$",                 (None, "model")),
    (r"/w_o$",                 ("model", None)),
    (r"/b_(q|k|v)$",           ("model",)),
    # --- MLPs -------------------------------------------------------------------
    (r"/w_(gate|up)$",         (None, "model")),
    (r"/w_down$",              ("model", None)),
    # --- norms, biases, scalars, codec keys, convnets: replicate ---------------
    (r".*",                    ()),
]


def _path_str(path) -> str:
    """'/'-joined key path: dict keys and list indices, as the reference
    joins a jax key path (``/stack/l0_0_attn/w_q``)."""
    return "/" + "/".join(str(p) for p in path)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, walked as
    :func:`repro_torch.interop.tree_map` walks it (dict keys sorted);
    ``path`` is the tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def spec_for_param(path_str: str, shape, mesh) -> tuple:
    for pat, trailing in _PARAM_RULES:
        if re.search(pat, path_str):
            pad = (None,) * (len(shape) - len(trailing))
            return _guard(pad + tuple(trailing), shape, mesh)
    return ()


def _extend_over(spec: tuple, shape, mesh, axis: str, min_size: int = 1) -> tuple:
    """Shard the largest still-replicated dim over `axis` (ZeRO/FSDP)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    ax_size = _dims(mesh, axis)
    best, best_dim = -1, -1
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % ax_size == 0 and dim >= max(ax_size, min_size) \
                and dim > best_dim:
            best, best_dim = i, dim
    if best >= 0:
        entries[best] = axis
    return tuple(entries)


def param_shardings(params, mesh, mode: str = "train"):
    """Specs for a param tree (``mode`` is accepted and read by nothing, as
    in the reference: both modes place params alike)."""
    data_axis = "data"

    def one(path, leaf):
        spec = spec_for_param(_path_str(path), leaf.shape, mesh)
        # fully shard big tensors over data too (FSDP/ZeRO-3-style)
        return _extend_over(spec, leaf.shape, mesh, data_axis, min_size=1024)

    return tree_map_with_path(one, params)


def opt_state_shardings(opt_state, mesh):
    """m/v mirror the param specs + ZeRO-1 over data; scalars replicated."""

    def one(path, leaf):
        if leaf.ndim == 0:
            return ()
        spec = spec_for_param(_path_str(path), leaf.shape, mesh)
        return _extend_over(spec, leaf.shape, mesh, "data", min_size=1024)

    return tree_map_with_path(one, opt_state)


def batch_spec(mesh, multi_pod_data: bool = True) -> tuple:
    """Batch-dim sharding: over (pod, data) when the mesh has a pod axis."""
    axes = tuple(mesh.axis_names)
    if "pod" in axes and multi_pod_data:
        return (("pod", "data"),)
    return ("data",)


def batch_shardings(batch, mesh, multi_pod_data: bool = True):
    bspec = batch_spec(mesh, multi_pod_data)

    def one(leaf):
        return _guard(bspec + (None,) * (len(leaf.shape) - 1), leaf.shape, mesh)

    return tree_map(one, batch)


# --- decode caches -----------------------------------------------------------

_CACHE_RULES: list[tuple[str, tuple]] = [
    # attn KV cache (N, B, T, KV, hd): batch over data, time over model
    (r"/(k|v)$",       ("data", "model", None, None)),
    (r"/(k|v)_scale$", ("data", "model", None, None)),
    # MLA compressed cache (N, B, T, L)
    (r"/c_kv$",        ("data", "model", None)),
    (r"/k_pe$",        ("data", "model", None)),
    # mamba state (N, B, di, ds) / conv (N, B, K-1, di)
    (r"/h$",           ("data", "model", None)),
    (r"/conv$",        ("data", None, "model")),
    # rwkv (N, B, H, hd, hd) / (N, B, d)
    (r"/wkv$",         ("data", "model", None, None)),
    (r"/x_prev$",      ("data", "model")),
    # encoder memory (B, S, d)
    (r"/memory$",      ("data", None, "model")),
    (r".*",            ()),
]


def cache_shardings(cache, mesh):
    def one(path, leaf):
        ps = _path_str(path)
        for pat, trailing in _CACHE_RULES:
            if re.search(pat, ps):
                pad = (None,) * (len(leaf.shape) - len(trailing))
                return _guard(pad + tuple(trailing), leaf.shape, mesh)
        return ()

    return tree_map_with_path(one, cache)


# --- specs on a DeviceMesh ---------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` with
    ``mesh_dim_names``): each mesh dim gets ``Shard(d)`` where tensor dim
    ``d`` names its axis, else ``Replicate()``.  A tuple entry shards one
    tensor dim over several mesh dims; DTensor splits such a dim over its
    mesh dims in mesh order, so the entry must name them in that order,
    as the reference's ``("pod", "data")`` does."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(_device_mesh(mesh).mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names the mesh axes out of "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor placed by
    ``spec`` (the guard makes every split even)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(dim // _dims(mesh, ax) if ax is not None else dim
                 for dim, ax in zip(shape, entries))


def distribute_tree(tree, specs, mesh):
    """Each tensor of ``tree`` placed on ``mesh`` by its spec in ``specs``
    (a tree of the same structure, walked by ``tree``'s, so each spec
    tuple stays whole): ``distribute_tensor``, which takes each rank's
    shard of the full tensor it is given (every rank holds the same full
    tensor).  A tensor on another device type than the mesh's raises:
    ``distribute_tensor`` would move it there without a word."""
    from torch.distributed.tensor import distribute_tensor
    dm = _device_mesh(mesh)

    def place(t, s):
        if t.device.type != dm.device_type:
            raise ValueError(f"a {t.device.type} tensor placed on a "
                             f"{dm.device_type} mesh: build the mesh on the "
                             "tensors' device type, or move them first")
        return distribute_tensor(t, dm, placements(s, dm))
    return tree_map(place, tree, specs)


def _device_mesh(mesh):
    """The ``DeviceMesh`` of a ``launch.mesh.HostMesh``, or ``mesh``."""
    return getattr(mesh, "device_mesh", mesh)
