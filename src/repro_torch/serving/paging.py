"""Host-side page allocator for the paged KV cache.

Port of ``repro/serving/paging.py`` (verbatim logic).  The device-side
layout (pools + page tables, see ``repro_torch.models.paging``) is pure
data; WHICH physical pages a slot holds is serving policy and is decided
here, on the host, at admit/retire boundaries only.

The engine reserves a request's full worst-case footprint at admit
(``ceil(min(prompt_len + max_new_tokens, max_len) / page_size)`` pages),
so a mid-flight decode can never run out of pages.  Admission is
FIFO-blocking: when the head of the queue does not fit, the engine waits
for pages to free rather than admitting later (smaller) requests past it.
"""
from __future__ import annotations


class PageAllocator:
    """Free-list allocator over ``num_pages`` physical pages.

    Frees are pushed back in retire order, so a recycled slot typically
    gets DIFFERENT physical pages than its previous occupant.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` pages, or None (allocation is all-or-nothing)."""
        if n > len(self._free):
            return None
        got, self._free = self._free[:n], self._free[n:]
        return got

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if not 0 <= p < self.num_pages or p in self._free:
                raise ValueError(f"double/invalid free of page {p}")
        self._free.extend(pages)
