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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (_normal, apply_mlp, dense_init, init_mlp,
                                       matmul, promote)

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


def route(p, xf, *, top_k: int, capacity_factor: float):
    """The router and the capacity dispatch for xf (N, d): probs (N, E)
    float32, gates (N, k) renormalised, expert_idx (N, k), keep (N*k,)
    bool, dest (N*k,) each copy's slot (E*cap where dropped), slot_copy
    (E*cap,) each slot's copy (N*k where empty), and cap."""
    N = xf.shape[0]
    E = p["router"].shape[-1]
    logits = matmul(xf, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    cap = max(int(top_k * N * capacity_factor / E), 1)
    e_flat = expert_idx.reshape(-1)
    # each copy's running count in its expert, scanned along the copies as
    # the inner axis of (E, N*k) (an outer-axis scan is far slower on CUDA)
    count = torch.cumsum(_one_hot(e_flat, E).T.contiguous(), dim=1)
    pos_in_e = torch.gather(count, 0, e_flat[None, :])[0] - 1
    keep = pos_in_e < cap
    dest = torch.where(keep, e_flat * cap + pos_in_e, E * cap)
    copies = torch.arange(N * top_k, device=xf.device)
    slot_copy = torch.full((E * cap + 1,), N * top_k, dtype=copies.dtype,
                           device=xf.device).scatter_(0, dest, copies)[:-1]
    return {"probs": probs, "gates": gate_vals, "expert_idx": expert_idx,
            "keep": keep, "dest": dest, "slot_copy": slot_copy, "cap": cap}


def apply_moe(p, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar)."""
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
