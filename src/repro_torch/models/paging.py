"""Paged KV cache geometry + device-side gather/scatter addressing.

Port of ``repro/models/paging.py``.  Every per-position cache leaf is a
shared pool of fixed-size pages ``(num_pages, page_size, ...)``; a
per-slot page table ``(B, P)`` of physical page ids maps each slot's
logical positions onto the pool.

* ``gather_pages`` builds the slot-major ``(B, T, ...)`` view that is
  element for element the contiguous cache layout (the gather read).
* ``scatter_rows`` / ``scatter_chunk`` write decode tokens / prefill
  chunks through the page table with the reference's drop semantics: rows
  that are not live (or padded chunk tails, or positions past the table)
  write nothing.

Unlike the reference, whose scatters return a new pool, these write IN
PLACE (``index_put_``) and return the pool they were given: a 30-layer
float32 pool set of the full-width serving run is about 4 GB, and copying
it every step is not an option.  The writes never synchronise with the
host: a dropped row is redirected to a live row's target with that row's
value (or, when no row is live, to its own target with the value already
there), so every write lands on a row that ends up holding exactly what
the reference's scatter would leave there.

Page *allocation* is host-side policy and lives with the serving engine
(``repro_torch.serving.paging``); this module is only the device-side
layout.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of a paged cache.

    ``len_linear`` / ``len_swa`` are the LOGICAL positions per slot (what
    the contiguous layout would allocate: ``max_len``, and
    ``min(max_len, sliding_window)``); ``num_pages`` / ``num_pages_swa``
    size the physical pools.  ``len_swa = 0`` means no sliding-window
    caches in the model.
    """
    page_size: int
    len_linear: int
    num_pages: int
    len_swa: int = 0
    num_pages_swa: int = 0

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {self.num_pages}")

    @property
    def pages_per_slot(self) -> int:
        """Page-table width for full-length caches."""
        return -(-self.len_linear // self.page_size)

    @property
    def pages_per_slot_swa(self) -> int:
        """Page-table width for sliding-window ring caches."""
        return -(-self.len_swa // self.page_size)

    def pages_for(self, positions: int) -> int:
        """Pages a slot must hold to cover ``positions`` cache positions."""
        return -(-min(positions, self.len_linear) // self.page_size)


def gather_pages(pool: torch.Tensor, table: torch.Tensor, length: int) -> torch.Tensor:
    """Slot-major view of a paged pool: (num_pages, ps, ...) -> (B, length, ...).

    ``view[b, t] == pool[table[b, t // ps], t % ps]`` — exactly the
    contiguous cache layout for slot b.  Trailing-page semantics as audited
    in the reference: the last page a slot uses is read whole and then
    sliced to ``length``; every position ``t < length`` the slot has not
    written yet still appears (stale pool rows or page-0 rows) and is
    hidden downstream by the decode mask, never here.
    """
    B, P = table.shape
    ps = pool.shape[1]
    view = pool[table.long()]                              # (B, P, ps, ...)
    return view.reshape(B, P * ps, *pool.shape[2:])[:, :length]


def masked_write(rows: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                 keep: torch.Tensor) -> None:
    """``rows[idx[n]] = vals[n]`` where ``keep[n]``, nothing elsewhere, in
    place and without a host sync.  ``rows`` (N, ...); ``idx`` (M,) int64
    in [0, N); ``vals`` (M, ...); ``keep`` (M,) bool.  Kept targets must be
    distinct.  A dropped entry writes the first kept entry's value to that
    entry's target (or, when nothing is kept, the value already at its own
    target), so duplicate indices always carry equal values."""
    any_keep = keep.any()
    # a (1,) index, never a 0-dim one: indexing with a 0-dim device tensor
    # reads it on the host (aten._local_scalar_dense)
    first = torch.argmax(keep.to(torch.int32)).reshape(1)
    lead = (-1,) + (1,) * (vals.ndim - 1)
    use_first = (~keep & any_keep).reshape(lead)
    tgt = torch.where(keep | ~any_keep, idx, idx.index_select(0, first))
    src = torch.where(use_first, vals.index_select(0, first),
                      torch.where(keep.reshape(lead), vals, rows[idx]))
    rows[tgt] = src.to(rows.dtype)


def scatter_rows(pool: torch.Tensor, table: torch.Tensor, slots: torch.Tensor,
                 vals: torch.Tensor, *, live=None) -> torch.Tensor:
    """Write one position per slot, in place: vals (B, 1, ...) at logical
    slot (B,).  Rows where ``live`` is False, and positions past the table
    (e.g. pos == max_len), write nothing — never remapped into the last
    page.  Returns ``pool``."""
    B, P = table.shape
    ps = pool.shape[1]
    slots = slots.long()
    lp = torch.clamp(slots // ps, 0, P - 1)
    page = torch.gather(table.long(), 1, lp[:, None])[:, 0]
    keep = slots < P * ps
    if live is not None:
        keep = keep & live
    idx = page * ps + slots % ps
    masked_write(pool.view(-1, *pool.shape[2:]), idx, vals[:, 0], keep)
    return pool


def scatter_chunk(pool: torch.Tensor, table: torch.Tensor, slots: torch.Tensor,
                  valid: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Write a prefill chunk, in place: vals (B, C, ...) at logical slots
    (B, C).  ``valid`` (B, C) marks real tokens; padded tails (and
    positions past the table) write nothing.  Chunk positions are distinct
    within a row and rows own disjoint pages, so kept writes never
    collide.  Returns ``pool``."""
    B, P = table.shape
    ps = pool.shape[1]
    slots = slots.long()
    lp = torch.clamp(slots // ps, 0, P - 1)
    page = torch.gather(table.long(), 1, lp)                # (B, C)
    keep = valid & (slots < P * ps)
    idx = page * ps + slots % ps
    masked_write(pool.view(-1, *pool.shape[2:]), idx.reshape(-1),
                 vals.reshape(-1, *vals.shape[2:]), keep.reshape(-1))
    return pool
