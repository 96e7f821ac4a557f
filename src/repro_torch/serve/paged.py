"""Paged KV-cache block manager: a shared pool of fixed-size pages with
per-slot page tables (a copy of ``repro.serve.paged`` over the port's own
``PagedLayout``).

This is the host-side half of the paged layout (the device-side half is the
pool tensors in the model cache and the CUDA kernel behind
``repro_torch.kernels.ops.paged_attention``): it decides WHICH pool page holds WHICH
(slot, position) and keeps the free list.  Three invariants:

* **Reservation-gated admission.**  A request reserves its worst case
  (``ceil((prompt + max_gen - 1) / page_size)`` pages) up front; admission is
  refused while the pool cannot cover it.  Pages are still *allocated* on
  write (prefill allocates the prompt's pages, decode allocates one page
  every ``page_size`` ticks), but the reservation guarantees a mid-flight
  request never starves — no preemption machinery needed.
* **Whole-table free.**  Retirement returns every page of the slot and zeroes
  its table row in one call — leak-free by construction, mirroring the dense
  engine's full-subtree-overwrite admission.
* **Determinism.**  The free list is LIFO, so identical workloads produce
  identical page tables (and bit-identical decode arithmetic) run to run.
"""

from __future__ import annotations

import numpy as np

from repro_torch.models.attention import PagedLayout

__all__ = ["PagedLayout", "PagePool"]


class PagePool:
    """Fixed pool of ``layout.n_pages`` KV pages shared by ``n_slots`` slots.

    ``table`` is the (n_slots, pages_per_slot) int32 page table the engine
    ships to the device (-1 = unallocated); all mutation goes through
    ``reserve_or_fail`` / ``allocate_prefix`` / ``ensure`` / ``release``."""

    def __init__(self, layout: PagedLayout, n_slots: int) -> None:
        self.layout = layout
        self.n_slots = n_slots
        self.table = np.full((n_slots, layout.pages_per_slot), -1, np.int32)
        self._free: list[int] = list(range(layout.n_pages - 1, -1, -1))  # LIFO, pops 0 first
        self._reserved = np.zeros(n_slots, np.int64)  # outstanding worst-case pages per slot
        self._allocated = np.zeros(n_slots, np.int64)
        self.dirty = False  # table changed since the engine last shipped it

    # -- capacity ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Pages not claimed by any outstanding reservation."""
        return self.layout.n_pages - int(self._reserved.sum())

    def pages_needed(self, prompt_len: int, max_gen: int) -> int:
        # positions written: prompt 0..L-1, then one per decode tick up to
        # max_gen - 1 more (the final sampled token is never fed back)
        return self.layout.pages_for(prompt_len + max_gen - 1)

    def fits(self, prompt_len: int, max_gen: int) -> bool:
        """Could this request EVER be admitted (empty pool, any slot)?"""
        need = self.pages_needed(prompt_len, max_gen)
        return need <= min(self.layout.n_pages, self.layout.pages_per_slot)

    def can_reserve(self, prompt_len: int, max_gen: int) -> bool:
        return self.pages_needed(prompt_len, max_gen) <= self.available_pages

    # -- lifecycle -----------------------------------------------------------

    def reserve_or_fail(self, slot: int, prompt_len: int, max_gen: int) -> None:
        need = self.pages_needed(prompt_len, max_gen)
        if not self.fits(prompt_len, max_gen):
            raise ValueError(
                f"request needs {need} pages but the pool holds "
                f"{self.layout.n_pages} (pages_per_slot={self.layout.pages_per_slot})"
            )
        if need > self.available_pages:
            raise RuntimeError(
                f"pool exhausted: need {need} pages, {self.available_pages} available "
                "— admission must be gated on can_reserve()"
            )
        if self._reserved[slot]:
            raise RuntimeError(f"slot {slot} already holds a reservation")
        self._reserved[slot] = need

    def allocate_prefix(self, slot: int, n_tokens: int) -> None:
        """Allocate pages covering positions 0..n_tokens-1 (prefill writes)."""
        for p in range(self.layout.pages_for(n_tokens)):
            if self.table[slot, p] < 0:
                self._take(slot, p)

    def ensure(self, slot: int, position: int) -> None:
        """Allocate-on-write: make sure ``position``'s page exists before the
        decode step writes it."""
        p = position // self.layout.page_size
        if self.table[slot, p] < 0:
            self._take(slot, p)

    def _take(self, slot: int, page_slot: int) -> None:
        # positions are written sequentially, so a slot's pages occupy table
        # slots 0..reserved-1; any higher index is past the reservation
        if page_slot >= self._reserved[slot]:
            raise RuntimeError(f"slot {slot} writing past its reservation")
        if not self._free:
            raise RuntimeError("free list empty despite reservation — accounting bug")
        self.table[slot, page_slot] = self._free.pop()
        self._allocated[slot] += 1
        self.dirty = True

    def release(self, slot: int) -> None:
        """Whole-table free: return every page and the reservation.

        A slot with neither a reservation nor pages has nothing to return —
        releasing it again is a stale caller (double release).  Silently
        accepting it used to be harmless only by luck: if the slot had been
        re-admitted in between, the stale release would hand the NEW
        occupant's pages back to the free list while the occupant still
        writes them — double-owned pages and a corrupt LIFO free list.  Fail
        loudly at the first double release instead.
        """
        row = self.table[slot]
        pages = [int(p) for p in row if p >= 0]
        if not pages and not self._reserved[slot]:
            raise RuntimeError(
                f"double release of slot {slot}: no reservation or pages outstanding "
                "— a stale caller releasing a re-admitted slot would free the new "
                "occupant's pages"
            )
        self._free.extend(reversed(pages))  # LIFO: most recent pages reused first
        row[:] = -1
        self._reserved[slot] = 0
        self._allocated[slot] = 0
        if pages:
            self.dirty = True

    # -- reporting -----------------------------------------------------------

    def slot_pages(self, slot: int) -> list[int]:
        return [int(p) for p in self.table[slot] if p >= 0]

    def check_leak_free(self) -> None:
        """Every page is either free or in exactly one table row.

        Raises ``RuntimeError`` (not ``assert`` — the check must survive
        ``python -O``) naming the held/free sets on violation.  The protocol
        model checker runs this on every reachable state; ``ServeEngine``
        runs it on every ``reset()``.
        """
        held = [int(p) for p in self.table.ravel() if p >= 0]
        seen = held + self._free
        if not (len(seen) == len(set(seen)) == self.layout.n_pages):
            raise RuntimeError(
                f"page accounting broken: held={sorted(held)} free={sorted(self._free)} "
                f"should partition 0..{self.layout.n_pages - 1}"
            )

    def fingerprint(self) -> tuple:
        """Canonical hashable state for the protocol model checker: the page
        table, the exact free-list ORDER (LIFO determinism is part of the
        contract), and the reservation/allocation accounting."""
        return (
            tuple(tuple(int(p) for p in row) for row in self.table),
            tuple(self._free),
            tuple(int(r) for r in self._reserved),
            tuple(int(a) for a in self._allocated),
        )

    def metrics(self) -> dict:
        return {
            "n_pages": self.layout.n_pages,
            "page_size": self.layout.page_size,
            "free_pages": self.free_pages,
            "reserved_pages": int(self._reserved.sum()),
            "allocated_pages": int(self._allocated.sum()),
        }
