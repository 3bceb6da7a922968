"""Functional optimizers over param trees (port of ``repro/optim/optimizers.py``).

API mirrors the reference (and optax): opt = adamw(lr); state =
opt.init(params); updates, state = opt.update(grads, state, params);
params = apply_updates(params, updates).  States have the params' tree
structure with float32 leaves; the step count is a 0-d int32 tensor on the
params' device, so an update needs no host sync.

Adam and AdamW also offer ``opt.update_(grads, state, params)``: the same
update and ``apply_updates`` in place on ``state`` and ``params``, with the
same numbers.  The functional form keeps the old moments and params beside
the new ones until the caller drops them (eight copies of the params at
the peak, with the gradients and the updates); in place, four.  The LM
trainer uses it, with ``clip_by_global_norm_``, at full width.

Leaves may be DTensors on a mesh (the dry run's sharded step): the moments
take their param's placements, each gradient is redistributed to its
param's placements before the update (a ``Partial`` gradient is reduced
there), the norms are DTensor reductions over every rank's shard, and the
updates run under ``implicit_replication`` so the plain 0-d step count
and bias corrections act as replicated.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.interop import tree_leaves, tree_map
from repro_torch.sharding.constraints import is_dtensor, mesh_scope


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    update_: Callable | None = None     # in place, where the optimizer has one


def _f32(x):
    """Float32 view for optimizer math.  Complex leaves only occur as FROZEN
    constants (the C3-SL codec's cached key spectrum); their gradients are
    exactly zero, so the real part is the whole story — and apply_updates
    leaves complex params untouched."""
    if x.is_complex():
        x = x.real
    return x.float()


def _placed_like(g, p):
    """``g`` redistributed to DTensor ``p``'s placements (a ``Partial``
    gradient reduced, a differently split one moved); ``g`` itself where
    either is a plain tensor or the placements already agree."""
    if (not is_dtensor(p) or not is_dtensor(g)
            or tuple(g.placements) == tuple(p.placements)):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _zeros_f32(p):
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def global_norm(tree) -> torch.Tensor:
    """The L2 norm over every leaf; over DTensor leaves, a reduction over
    every rank's shard (a replicated DTensor)."""
    with mesh_scope(tree):
        return torch.sqrt(sum(torch.sum(torch.square(x.abs().float()))
                              for x in tree_leaves(tree)))


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    gn = global_norm(tree)
    with mesh_scope(tree):
        scale = _clip_scale(gn, max_norm)
        return tree_map(lambda x: x * scale, tree), gn


@torch.no_grad()
def clip_by_global_norm_(tree, max_norm: float):
    """:func:`clip_by_global_norm` in place on ``tree``'s leaves; returns
    the global norm before clipping."""
    gn = global_norm(tree)
    with mesh_scope(tree):
        scale = _clip_scale(gn, max_norm)
        for x in tree_leaves(tree):
            x.mul_(scale)
    return gn


def _count0(params):
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def _adam_core(lr, b1, b2, eps, weight_decay):
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params), "count": _count0(params)}

    def corrections(count):
        lr_t = lr(count) if callable(lr) else lr
        cf = count.float()
        # the bases filled on the device: a torch.tensor of a host number
        # would be a blocking host-to-device copy in every step
        c1 = 1 - torch.pow(torch.full((), b1, device=cf.device), cf)
        c2 = 1 - torch.pow(torch.full((), b2, device=cf.device), cf)
        return lr_t, c1, c2

    def upd(m, v, p, lr_t, c1, c2):
        u = -lr_t * (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay and p is not None:
            u = u - lr_t * weight_decay * _f32(p)
        return u

    def moments_(m, v, g):
        """One leaf's moment step, in place on ``m`` and ``v``."""
        g = _f32(g)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))

    def update(grads, state, params=None):
        with mesh_scope(state["m"]):
            count = state["count"] + 1
            m = tree_map(torch.clone, state["m"])
            v = tree_map(torch.clone, state["v"])
            for mi, vi, g in zip(tree_leaves(m), tree_leaves(v), tree_leaves(grads)):
                moments_(mi, vi, _placed_like(g, mi))
            lr_t, c1, c2 = corrections(count)
            if weight_decay:
                updates = tree_map(lambda m, v, p: upd(m, v, p, lr_t, c1, c2),
                                   m, v, params)
            else:
                updates = tree_map(lambda m, v: upd(m, v, None, lr_t, c1, c2),
                                   m, v)
        return updates, {"m": m, "v": v, "count": count}

    @torch.no_grad()
    def update_(grads, state, params):
        """``update`` then ``apply_updates``, in place on ``state`` and
        ``params``, leaf by leaf, in the same operations."""
        with mesh_scope(params):
            state["count"] = state["count"] + 1
            lr_t, c1, c2 = corrections(state["count"])
            for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                                  tree_leaves(state["v"]), tree_leaves(params)):
                moments_(m, v, _placed_like(g, p))
                if p.is_complex():
                    continue   # frozen constants take no updates
                u = upd(m, v, p, lr_t, c1, c2)
                if p.dtype == torch.float32:
                    p.add_(u)
                else:
                    p.copy_((p.float() + u).to(p.dtype))

    return Optimizer(init, update, update_)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay=0.0)


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay)


def sgd_momentum(lr, momentum=0.9) -> Optimizer:
    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params),
                "count": _count0(params)}

    def update(grads, state, params=None):
        count = state["count"] + 1
        lr_t = lr(count) if callable(lr) else lr
        mu = tree_map(lambda mu, g: momentum * mu + _f32(g), state["mu"], grads)
        updates = tree_map(lambda mu: -lr_t * mu, mu)
        return updates, {"mu": mu, "count": count}

    return Optimizer(init, update)


def apply_updates(params, updates):
    def one(p, u):
        if p.is_complex():
            return p   # frozen constants (cached key spectra) take no updates
        return (p.float() + u).to(p.dtype)
    return tree_map(one, params, updates)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    def schedule(count):
        count = count.float()
        warm = count / max(warmup_steps, 1)
        frac = torch.clamp((count - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return peak_lr * torch.where(count < warmup_steps, warm, cos)
    return schedule
