"""Mixture-of-Experts layer: top-k router with capacity, row dispatch.

Port of ``repro/models/moe.py``.  Expert params carry a leading E axis;
the experts run as one batched SwiGLU over (E, capacity, d).

Dispatch is the Switch/GShard capacity scheme: each token's top-k copies,
in (token, k) order, take the next free slot of their expert; copies past
``cap = max(int(top_k * N * capacity_factor / E), 1)`` are dropped (their
residual passes through).

The reference scatters the copies with ``.at[dest].add`` into a buffer
whose last row takes every dropped copy.  Here rows move by gathers only,
in both directions: :class:`_MoveRows` gathers by one index map and its
backward gathers by the inverse map, so the dispatch, the combine and
their gradients are deterministic on the card and use no atomics.  The
inverse map (slot -> copy) is built with ``scatter_`` of the copies' slots,
plain stores that are unique for every kept copy; only the discarded
overflow slot is written more than once.

Over a mesh (DTensor ``x``), :func:`apply_moe` runs the same routing on
each rank's own token rows (split over "data", and "pod"), with the
capacity cut in the global token order: each rank's copies of an expert
take the slots after those of the ranks ahead of it (an all-gather of
each rank's (E,) counts, not of its tokens).  The experts are split over
the mesh dims that split the expert axis of ``w_*`` ("model", by the
rules).  Each rank writes its kept copies of its own experts into their
global slots of a zero buffer (E/m, cap, d); the buffers are summed and
split by slot over the row dims (a reduce-scatter: each slot holds one
copy or zeros, so the sum is exact), each rank runs its experts over its
share of the slots, the outputs are gathered back over the row dims, and
each rank combines its tokens' copies of its own experts: a partial sum
over the expert dims, as a row-parallel layer's output is.  Every index
runs on local tensors (DTensor's propagation of integer indexing is not
used).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (_normal, apply_mlp, dense_init, init_mlp,
                                       matmul, promote)
from repro_torch.sharding.constraints import from_local, is_dtensor, rows_only

# A list here receives, for every apply_moe call, the detached (kept
# copies, all copies, aux loss) of that call; None records nothing.
ROUTING_LOG: list | None = None


def init_moe(rng: torch.Generator, d_model: int, d_ff: int, num_experts: int, *,
             num_shared_experts: int = 0, dtype=torch.float32, lead: tuple = ()):
    E = num_experts
    p = {
        "router": dense_init(rng, d_model, E, dtype, lead=lead),
        "w_gate": _normal(rng, (*lead, E, d_model, d_ff), d_model ** -0.5, dtype),
        "w_up": _normal(rng, (*lead, E, d_model, d_ff), d_model ** -0.5, dtype),
        "w_down": _normal(rng, (*lead, E, d_ff, d_model), d_ff ** -0.5, dtype),
    }
    if num_shared_experts:
        p["shared"] = init_mlp(rng, d_model, d_ff * num_shared_experts,
                               dtype=dtype, lead=lead)
    return p


class _MoveRows(torch.autograd.Function):
    """``cat([x, 0])[take]``: rows of x (n, d) gathered by ``take`` (m,),
    where the index n reads a zero row.  ``back`` (n,) is the inverse map
    (m for a row of x that no output reads), so the backward is the same
    gather of the output gradient by ``back``."""

    @staticmethod
    def forward(ctx, x, take, back):
        ctx.save_for_backward(take, back)
        return torch.cat([x, x.new_zeros((1, x.shape[1]))])[take]

    @staticmethod
    def backward(ctx, g):
        take, back = ctx.saved_tensors
        return _MoveRows.apply(g, back, take), None, None


def _one_hot(idx, E: int):
    """``F.one_hot(idx, E)`` without its range checks, which read ``idx`` on
    the host on a CPU tensor."""
    return (idx[..., None] == torch.arange(E, device=idx.device)).long()


def route(p, xf, *, top_k: int, capacity_factor: float, tokens: int | None = None,
          ahead=None):
    """The router and the capacity dispatch for xf (N, d): probs (N, E)
    float32, gates (N, k) renormalised, expert_idx (N, k), keep (N*k,)
    bool, dest (N*k,) each copy's slot (E*cap where dropped), slot_copy
    (E*cap,) each slot's copy (N*k where empty), and cap.  Over a mesh,
    ``tokens`` is the global token count the capacity is taken over and
    ``ahead`` maps this rank's per-expert copy counts (E,) to the copies
    of each expert in the token rows ahead of this rank's."""
    N = xf.shape[0]
    E = p["router"].shape[-1]
    logits = matmul(xf, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    cap = max(int(top_k * (tokens or N) * capacity_factor / E), 1)
    e_flat = expert_idx.reshape(-1)
    # each copy's running count in its expert, scanned along the copies as
    # the inner axis of (E, N*k) (an outer-axis scan is far slower on CUDA)
    count = torch.cumsum(_one_hot(e_flat, E).T.contiguous(), dim=1)
    if ahead is not None:
        count = count + ahead(count[:, -1])[:, None]
    pos_in_e = torch.gather(count, 0, e_flat[None, :])[0] - 1
    keep = pos_in_e < cap
    dest = torch.where(keep, e_flat * cap + pos_in_e, E * cap)
    return {"probs": probs, "gates": gate_vals, "expert_idx": expert_idx,
            "keep": keep, "dest": dest, "slot_copy": _inverse(dest, E * cap),
            "cap": cap}


def _inverse(dest, n_slots: int):
    """Each of ``n_slots`` slots' copy (len(dest) where empty) from each
    copy's slot ``dest`` (n_slots for a copy that has none)."""
    copies = torch.arange(dest.shape[0], device=dest.device)
    return torch.full((n_slots + 1,), dest.shape[0], dtype=copies.dtype,
                      device=dest.device).scatter_(0, dest, copies)[:-1]


def apply_moe(p, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar)."""
    if is_dtensor(x):
        return _apply_moe_mesh(p, x, top_k=top_k, capacity_factor=capacity_factor)
    B, S, d = x.shape
    E = p["router"].shape[-1]
    N = B * S
    xf = x.reshape(N, d)
    r = route(p, xf, top_k=top_k, capacity_factor=capacity_factor)
    cap = r["cap"]

    # token copies in (token, k) order; the backward of expand sums them
    src = xf[:, None, :].expand(N, top_k, d).reshape(N * top_k, d)
    dispatched = _MoveRows.apply(src, r["slot_copy"], r["dest"]).reshape(E, cap, d)

    h = F.silu(torch.bmm(*promote(dispatched, p["w_gate"])))
    h = h * torch.bmm(*promote(dispatched, p["w_up"]))
    out_e = torch.bmm(*promote(h, p["w_down"]))                # (E, cap, d)

    gathered = _MoveRows.apply(out_e.reshape(E * cap, d), r["dest"],
                               r["slot_copy"])                 # (N*k, d)
    w = (r["gates"].reshape(-1) * r["keep"]).to(xf.dtype)
    y = (gathered * w[:, None]).reshape(N, top_k, d).sum(dim=1)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], xf)

    # Switch-style load-balance auxiliary loss
    frac_tokens = _one_hot(r["expert_idx"][:, 0], E).float().mean(dim=0)
    frac_probs = r["probs"].mean(dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    if ROUTING_LOG is not None:
        ROUTING_LOG.append((r["keep"].sum().detach(), N * top_k, aux.detach()))
    return y.reshape(B, S, d), aux


def _local(w, mesh, want, grads):
    """DTensor ``w``'s local tensor at placements ``want``, its gradient
    read back at ``grads``; a plain ``w`` itself (replicated)."""
    if not is_dtensor(w):
        return w
    return w.redistribute(mesh, want).to_local(grad_placements=grads)


def _block(mesh, dims) -> tuple:
    """(this rank's block index, the block count) over mesh dims ``dims``,
    major to minor in mesh order, as DTensor splits one tensor dim over
    several mesh dims."""
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
        n *= mesh.size(i)
    return idx, n


def _apply_moe_mesh(p, x, *, top_k: int, capacity_factor: float):
    """:func:`apply_moe` over DTensor ``x`` (see the module's docstring):
    the rows stay split where ``x``'s are, the experts split where
    ``w_gate``'s expert axis is over the other mesh dims, every other mesh
    dim computes alike.  The same routing, drops and outputs as the whole
    batch; y is a partial sum over the expert dims, the aux loss and
    ``ROUTING_LOG``'s kept count are the global batch's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    x = rows_only(x)
    mesh = x.device_mesh
    B, S, d = x.shape
    E = p["router"].shape[-1]
    wp = getattr(p["w_gate"], "placements", ())
    rows = [i for i, q in enumerate(x.placements) if q.is_shard(0)]
    experts = [i for i, q in enumerate(wp) if i not in rows and q == Shard(0)]
    r_idx, n_rows = _block(mesh, rows)
    e_idx, n_exp = _block(mesh, experts)
    E_loc = E // n_exp

    def place(row, expert, other=Replicate()):
        return tuple(row if i in rows else expert if i in experts else other
                     for i in range(mesh.ndim))

    xl = x.to_local()
    B_l = xl.shape[0]
    N_l, N = B_l * S, B * S
    # the router's path is whole on every expert rank, so its gradients are
    # too; the dispatch's reads only this rank's experts, so its gradient
    # is summed over the expert dims
    xf = xl.reshape(N_l, d)
    xd = x.to_local(grad_placements=place(Shard(0), Partial())).reshape(N_l, d)
    router = _local(p["router"], mesh, place(Replicate(), Replicate()),
                    place(Partial(), Replicate()))

    def ahead(counts):
        every = from_local(counts[None], mesh, place(Shard(0), Replicate()),
                           (n_rows, E)).full_tensor()
        return every[:r_idx].sum(dim=0)

    r = route({"router": router}, xf, top_k=top_k, capacity_factor=capacity_factor,
              tokens=N, ahead=ahead if n_rows > 1 else None)
    cap = r["cap"]
    C = -(-cap // n_rows) * n_rows          # the slots, split evenly over rows
    e_flat = r["expert_idx"].reshape(-1)
    lo = e_idx * E_loc
    mine = r["keep"] & (e_flat >= lo) & (e_flat < lo + E_loc)
    slot = torch.where(mine, (e_flat - lo) * C + r["dest"] - e_flat * cap,
                       E_loc * C)
    slot_copy = _inverse(slot, E_loc * C)

    src = xd[:, None, :].expand(N_l, top_k, d).reshape(N_l * top_k, d)
    part = _MoveRows.apply(src, slot_copy, slot).reshape(E_loc, C, d)
    dispatched = from_local(part, mesh, place(Partial(), Shard(0)), (E, C, d))
    dispatched = dispatched.redistribute(mesh, place(Shard(1), Shard(0))).to_local()

    w = {k: _local(p[k], mesh, place(Replicate(), Shard(0)),
                   place(Partial(), Shard(0)))
         for k in ("w_gate", "w_up", "w_down")}
    h = F.silu(torch.bmm(*promote(dispatched, w["w_gate"])))
    h = h * torch.bmm(*promote(dispatched, w["w_up"]))
    out_e = torch.bmm(*promote(h, w["w_down"]))          # (E_loc, C / n_rows, d)

    out_e = from_local(out_e, mesh, place(Shard(1), Shard(0)), (E, C, d))
    out_e = out_e.redistribute(mesh, place(Replicate(), Shard(0))).to_local(
        grad_placements=place(Partial(), Shard(0)))
    gathered = _MoveRows.apply(out_e.reshape(E_loc * C, d), slot, slot_copy)
    gates = from_local(r["gates"], mesh, place(Shard(0), Replicate()),
                       (N, top_k)).to_local(
        grad_placements=place(Shard(0), Partial()))
    wts = (gates.reshape(-1) * mine).to(xf.dtype)
    y = (gathered * wts[:, None]).reshape(B_l, S, top_k, d).sum(dim=2)
    y = from_local(y, mesh, place(Shard(0), Partial()), (B, S, d))
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x)

    # the load-balance loss over the global tokens: each rank's sums,
    # summed over the row dims
    sums = torch.stack([_one_hot(r["expert_idx"][:, 0], E).float().sum(dim=0),
                        r["probs"].sum(dim=0)])
    sums = from_local(sums, mesh, place(Partial(), Replicate()), (2, E))
    frac = sums.redistribute(mesh, place(Replicate(), Replicate())).to_local() / N
    aux = E * torch.sum(frac[0] * frac[1])
    if ROUTING_LOG is not None:
        kept = from_local(r["keep"].sum()[None], mesh, place(Partial(), Replicate()),
                          (1,)).full_tensor()[0]
        ROUTING_LOG.append((kept.detach(), N * top_k, aux.detach()))
    return y, from_local(aux, mesh, place(Replicate(), Replicate()), ())
