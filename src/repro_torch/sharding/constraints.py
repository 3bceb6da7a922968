"""Guarded sharding-constraint helper usable inside model code (port of
``repro/sharding/constraints.py``).

``constrain(x, template)`` redistributes a DTensor to the given axis-name
template (tuple entries may be None / "data" / "model" / ("pod","data")),
but only over axes of the active mesh (``sharding.active.set_mesh``) and only
where the dim divides evenly and is at least the axes' size; every other
dim is replicated.  It is a no-op without an active mesh or when ``x`` is
a plain tensor, so model code runs unchanged on one device.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.interop import tree_leaves
from repro_torch.sharding.active import active_mesh


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_scope(tree):
    """``implicit_replication()`` where a leaf of ``tree`` is a DTensor
    (plain tensors, such as rope tables, masks, positions and the
    optimizer's step count, then act as replicated over its mesh), else a
    null context."""
    if any(is_dtensor(x) for x in tree_leaves(tree)):
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def guarded_spec(shape, template, mesh) -> tuple:
    """``template`` over ``shape`` on ``mesh``: each entry kept where all its
    axes are the mesh's and the dim divides evenly and is at least their
    size, else None."""
    entries = []
    for dim, ax in zip(shape, tuple(template) + (None,) * (len(shape) - len(template))):
        if ax is None:
            entries.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if not all(a in mesh.shape for a in axes):
            entries.append(None)
            continue
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        entries.append(ax if (dim % size == 0 and dim >= size) else None)
    return tuple(entries)


def constrain(x: torch.Tensor, template) -> torch.Tensor:
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    from repro_torch.sharding.rules import placements
    spec = guarded_spec(x.shape, template, mesh)
    if all(e is None for e in spec):
        return x
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def on_local_rows(fn, x: torch.Tensor, group_rows: int) -> torch.Tensor:
    """``fn`` (plain (B, D) -> plain (B, D')) over DTensor ``x``'s rows, on
    each rank's local tensor.  Dim 1 is made whole first (every split of
    it replicated), and dim 0 stays split where each rank's rows are a
    whole number of ``group_rows``-row groups: each rank then forms the
    same groups of consecutive rows as the whole batch.  Where a group
    would span ranks, the rows are gathered first and every rank runs
    ``fn`` on the whole batch.  The result carries the placements ``fn``
    ran under; gradients flow through ``to_local`` and ``from_local``.
    ``fn`` itself on a plain tensor."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate
    x = rows_only(x)
    if x.to_local().shape[0] % group_rows:
        x = x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)
    out = fn(x.to_local())
    return from_local(out, x.device_mesh, x.placements,
                       (x.shape[0], *out.shape[1:]))


def microbatch(x: torch.Tensor, M: int, m: int) -> torch.Tensor:
    """Rows [m B/M, (m+1) B/M) of ``x`` (B, ...): microbatch ``m`` of
    ``M``, ``x.reshape(M, B // M, ...)[m]`` on a plain tensor.  On a
    DTensor whose rows are split, that reshape would split the M dim and
    indexing it would gather the whole microbatch on every rank; here the
    rows are gathered instead (a batch of token ids is small) and each
    rank keeps its share of the microbatch's rows, split over the same
    mesh dims as ``x``'s, so each rank still runs B / (M n) rows.  Where
    the microbatch's rows do not divide over those mesh dims, they are
    replicated."""
    B = x.shape[0]
    if not is_dtensor(x):
        return x.reshape(M, B // M, *x.shape[1:])[m]
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    rows = x.full_tensor()[m * (B // M):(m + 1) * (B // M)]
    n = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                  if p.is_shard(0))
    want = tuple(p if rows.shape[0] % n == 0 or not p.is_shard(0)
                 else Replicate() for p in x.placements)
    whole = DTensor.from_local(rows, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    return whole.redistribute(mesh, want)


def rows_only(x: torch.Tensor) -> torch.Tensor:
    """DTensor ``x`` with only its rows (dim 0) split, where they were:
    every other placement made ``Replicate``.  A no-op on a plain
    tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``t`` (..., heads * head_dim) as (..., heads, head_dim).  On a
    DTensor whose last dim is split over mesh dims that do not divide
    ``heads`` (which DTensor cannot unflatten), those mesh dims are made
    whole first."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        mesh, last = t.device_mesh, t.ndim - 1
        split = [i for i, p in enumerate(t.placements) if p.is_shard(last)]
        if heads % math.prod(mesh.size(i) for i in split):
            t = t.redistribute(mesh, tuple(Replicate() if i in split else p
                                           for i, p in enumerate(t.placements)))
    return t.reshape(*t.shape[:-1], heads, head_dim)


class _MapGrad(torch.autograd.Function):
    """The identity; ``fn`` of its gradient in the backward."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def on_local_heads(fn, q, k, v, *args):
    """``fn(q, k, v, *args)`` (attention over (B, S, heads, hd) -> (B, S,
    heads * hd_v)) on each rank's local tensors: the batch stays split
    where ``q``'s is, the heads are split over every other mesh dim whose
    size divides the kv heads (q's heads in the same blocks, so each
    rank's query heads read its own kv heads), and the sequence and head
    dims are made whole.  Every head attends alone, so the numbers are the
    whole tensors' own.  ``fn`` itself on plain tensors."""
    if not is_dtensor(q):
        return fn(q, k, v, *args)
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    kv_left = k.shape[2]
    place = []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p == Shard(0):
            place.append(Shard(0))
        elif kv_left % n == 0:
            place.append(Shard(2))
            kv_left //= n
        else:
            place.append(Replicate())
    place = tuple(place)
    # the local gradients made contiguous: the attention's backward gives
    # them in a permuted layout, and DTensor views a local tensor as if it
    # were laid out as the global one
    out = fn(*(_MapGrad.apply(t.redistribute(mesh, place).to_local(),
                              torch.Tensor.contiguous) for t in (q, k, v)), *args)
    split = math.prod(mesh.size(i) for i, p in enumerate(place) if p == Shard(2))
    return from_local(out, mesh, place, (q.shape[0], *out.shape[1:-1],
                                          out.shape[-1] * split))


def from_local(out, mesh, placements, shape):
    """A DTensor of global ``shape`` from each rank's contiguous ``out``
    (no communication; gradients flow through)."""
    from torch.distributed.tensor import DTensor
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(out.contiguous(), mesh, placements,
                              run_check=False, shape=tuple(shape),
                              stride=tuple(stride))


def lookup(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` (an embedding lookup), over a mesh on local
    tensors: the table gathered whole, each rank's rows of ``index``
    looked up in it, the result split as ``index``'s rows are.  The
    table's gradient is each rank's sum over its own rows: a partial sum
    over the mesh dims that split the rows, which the gather's backward
    reduce-scatters to the table's placements.  ``table[index]`` on plain
    tensors."""
    if not is_dtensor(table):
        return table[index]
    from torch.distributed.tensor import Partial, Replicate
    mesh = table.device_mesh
    rows = (tuple(index.placements) if is_dtensor(index)
            else (Replicate(),) * mesh.ndim)
    local_index = index.to_local() if is_dtensor(index) else index
    grads = [Partial() if p.is_shard() else Replicate() for p in rows]
    whole = table.redistribute(mesh, (Replicate(),) * mesh.ndim)
    out = whole.to_local(grad_placements=grads)[local_index]
    return from_local(out, mesh, rows, (*index.shape, *table.shape[1:]))


def whole_inner(x: torch.Tensor) -> torch.Tensor:
    """DTensor ``x`` with its partial sums reduced and none of its inner
    dims (all but the first and the last) split: each ``Partial`` and each
    such ``Shard`` made ``Replicate``.  A matmul flattens the leading
    dims, and DTensor's planner cannot place a flattened dim split over an
    inner one without replicating the operands; left to itself, DTensor
    may resolve a partial sum into just such a split.  A no-op on a plain
    tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if p.is_partial()
                 or (p.is_shard() and 0 < p.dim < x.ndim - 1) else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def whole_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, its gradient made :func:`whole_inner` in the backward:
    the input gradient of column-parallel projections, partial over
    "model", is summed there before it reaches the op that made ``x``
    (Megatron's f), where DTensor would resolve it into a split sequence.
    A no-op on a plain tensor."""
    if not is_dtensor(x):
        return x
    return _MapGrad.apply(x, whole_inner)


def unshard(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` with nothing split over mesh axis ``axis``: each ``Shard`` or
    ``Partial`` placement on that mesh dim made ``Replicate``.  A no-op on
    a plain tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names
    if axis not in names:
        return x
    i = names.index(axis)
    if x.placements[i].is_replicate():
        return x
    want = list(x.placements)
    want[i] = Replicate()
    return x.redistribute(x.device_mesh, tuple(want))
