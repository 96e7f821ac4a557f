"""Continuous-batching decode engine (the port of ``repro.serve.engine``).

One engine owns a fixed number of *slots* (the batch dimension of a per-slot
cache).  Admission runs the model's batched ``prefill`` over the
power-of-two-bucketed prompt on a batch-1 template, then splices the
resulting cache into the slot; every ``tick`` runs one ``decode_step`` over
all slots and retires the ones that hit EOS or their generation budget.
PyTorch runs eagerly where the reference jit-compiles each of these steps.

``attn_impl="paged"`` switches the KV layout to a shared page pool
(``serve.paged.PagePool`` + the paged-decode kernel): admission is gated on
page reservations, and per-tick decode reads each slot's live pages only.
A paged engine always prefills with naive attention into a non-windowed
template, then splices the template's positions into the slot's pages.
Recurrent (RWKV6, Mamba) layers keep a per-slot state in either layout,
and the splice overwrites the slot's row of it whole.  An embeds-input
model (llava) takes (L, d) float32 prompts, padded in a float32 bucket;
its decode feeds the sampled token's id, whose embedding row is what the
reference's engine feeds (``repro/serve/engine.py:147``).

Preemption (paged) keeps the evicted slot's cache: ``preempt`` copies its
live K/V rows (with an int8 cache's scale rows, and any recurrent row:
RWKV6's, Mamba's conv and SSM state) to host memory in the resume token,
with the prompt (token ids or embeddings), and releases its pages;
``restore`` copies them into freshly allocated pages.  The reference
re-prefills prompt + generated tokens instead (``repro/serve/engine.py:390``;
for an embeddings prompt, the prompt and the generated tokens' embedding
rows, ``:402``), which gives the generated positions prefill arithmetic in
place of decode arithmetic; in bfloat16 the two round apart, so only kept
rows continue token-identically.  A restore is
therefore no prefill here: ``prefills``/``prefill_tokens`` count admissions
only, where the reference's count restores too.

The engine holds the parameters in the compute dtype
(``models.transformer.compute_copy``, the same arithmetic as casting every
matrix at its use): a matrix it narrows is copied once at load, and every
other parameter is the caller's own tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import PagedLayout, compute_copy, decode_step, init_cache, init_params, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.serve.paged import PagePool

__all__ = ["ServeEngine", "bucket_len"]

# template-cache key -> paged-pool key for the admission splice (the scales of an int8 cache too)
_POOL_KEYS = (("k", "k_pool"), ("v", "v_pool"), ("k_scale", "k_scale_pool"), ("v_scale", "v_scale_pool"))


def bucket_len(n: int, lo: int = 8) -> int:
    """Smallest power-of-two bucket >= n (>= lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _splice_row(big: dict, tmpl: dict, b: int) -> None:
    """Overwrite slot ``b``'s row of every tensor of a per-slot layer cache with
    the batch-1 template's."""
    for key, buf in big.items():
        buf[b] = tmpl[key][0].to(buf.dtype)


@dataclasses.dataclass
class _Slot:
    rid: int | None = None
    max_gen: int = 0
    generated: int = 0
    out: list = dataclasses.field(default_factory=list)
    active: bool = False
    pos: int = 0  # host mirror of the device index clock (next position to write)
    prompt: np.ndarray | None = None  # kept for the resume token of a preemption


class ServeEngine:
    """Slot-based continuous batching over one model replica on one device."""

    def __init__(
        self,
        cfg: ModelConfig,
        params=None,
        *,
        n_slots: int = 4,
        max_seq: int = 64,
        eos_id: int | None = None,
        temperature: float = 0.0,
        seed: int = 0,
        attn_impl: str = "naive",
        wkv_impl: str = "kernel",
        page_size: int = 8,
        pool_pages: int | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        """``attn_impl``: "naive"/"flash" pick the prefill attention over the
        dense cache; "paged" switches the cache to the paged layout (prefill
        stays naive) and decodes through the paged kernel.  The default pool
        matches the dense layout's footprint (``n_slots * max_seq`` tokens).
        ``wkv_impl``: the RWKV layers' prefill route, "scan", "chunked" or
        "kernel" (the default: the CUDA kernel on the card, its plain
        sequential scan on the CPU); decode always runs the single-token
        recurrence.  The default departs from the reference's "chunked"
        (``repro/serve/engine.py:79``) so that serving on the card runs the
        ``rwkv6_scan`` kernel; ``wkv_chunked`` stays a tested route.
        ``params``: a ``Transformer`` on ``device`` (default: seeded from ``seed``)."""
        if attn_impl == "blocked":
            raise ValueError("attn_impl 'blocked' is ported for the training slice only; serve with naive/flash/paged")
        if attn_impl not in ("naive", "flash", "paged"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if wkv_impl not in ("scan", "chunked", "kernel"):
            raise ValueError(f"unknown wkv_impl {wkv_impl!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, seed, self.device)
        if params.embed.device != self.device:
            raise ValueError(f"params live on {params.embed.device}, the engine on {self.device}")
        self.params = compute_copy(params, cfg)
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.temperature = temperature
        self.attn_impl = attn_impl
        self.wkv_impl = wkv_impl
        self.seed = seed
        if attn_impl == "paged":
            n_pages = pool_pages if pool_pages is not None else -(-n_slots * max_seq // page_size)
            self.layout: PagedLayout | None = PagedLayout(page_size=page_size, n_pages=n_pages)
            # prefill template: non-windowed, so every prompt position is
            # present for the page splice (the pools keep positions below the
            # window and the kernel masks by window instead)
            self._fresh1 = init_cache(dataclasses.replace(cfg, windowed_cache=False), 1, max_seq, device=self.device)
            self._prefill_impl = "naive"
        else:
            self.layout = None
            self._fresh1 = init_cache(cfg, 1, max_seq, device=self.device)
            self._prefill_impl = attn_impl
        self.pool: PagePool | None = None
        self.reset()

    def reset(self, seed: int | None = None) -> None:
        """Return the engine to its just-constructed state: fresh cache, all
        slots free, counters zeroed (a paged pool is audited for leaks first).
        ``seed`` replaces the engine's seed, which reseeds the sampling generator."""
        if seed is not None:
            self.seed = seed
        self.slots = [_Slot() for _ in range(self.n_slots)]
        self.cache = None  # released before the new cache is allocated, so a reset never holds two
        self.cache = init_cache(self.cfg, self.n_slots, self.max_seq, paged=self.layout, device=self.device)
        if self.layout is not None:
            if self.pool is not None:
                self.pool.check_leak_free()
            self.pool = PagePool(self.layout, self.n_slots)
        self.last_tok = torch.zeros((self.n_slots,), dtype=torch.long, device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self.ticks = self.prefills = self.prefill_tokens = 0
        self.tokens_out = self.active_slot_ticks = 0
        self.preemptions = self.restores = 0
        # analytic decode-cost counter: KV positions attended per attention
        # layer, summed over ticks and slots (dense: the full cache every tick;
        # paged: each active slot's live tokens rounded up to pages)
        self.attended_key_tokens = 0
        # the most recent tick's slice of the two counters above — what a
        # per-tick cost model (obs) reads without differencing
        self.last_tick_attended = self.last_tick_active = 0

    # -- state ---------------------------------------------------------------

    @property
    def has_active(self) -> bool:
        return any(s.active for s in self.slots)

    @property
    def free_slots(self) -> list[int]:
        return [b for b, s in enumerate(self.slots) if not s.active]

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature > 0.0:
            probs = torch.softmax(logits.float() / self.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    def _ship_table(self) -> None:
        """Copy the host page table to the device cache when it changed (once
        per admission or tick at most, never per layer)."""
        if self.pool is not None and self.pool.dirty:
            self.cache["pages"].copy_(torch.from_numpy(self.pool.table))
            self.pool.dirty = False

    # -- admission -----------------------------------------------------------

    def admissible(self, prompt_len: int, max_gen: int) -> bool:
        """Could this request EVER run on this engine (regardless of current
        load)?  Dense: ``prompt + max_gen <= max_seq``.  Paged: the prompt
        fits the prefill buffer and the pages fit the pool."""
        if prompt_len < 1 or max_gen < 1:
            return False
        if self.pool is not None:
            return prompt_len <= self.max_seq and self.pool.fits(prompt_len, max_gen)
        return prompt_len + max_gen <= self.max_seq

    def can_admit_now(self, prompt_len: int, max_gen: int) -> bool:
        """Admissible AND a slot is free AND (paged) the pool can cover the
        worst-case page reservation right now."""
        if not self.admissible(prompt_len, max_gen) or not self.free_slots:
            return False
        if self.pool is not None:
            return self.pool.can_reserve(prompt_len, max_gen)
        return True

    def admit(self, rid: int, prompt: np.ndarray, max_gen: int) -> tuple[int, tuple | None]:
        """Prefill ``prompt`` ((L,) int32 token ids, or (L, d) float embeddings
        for ``cfg.embeds_input`` archs) into a free slot.  Returns
        (slot, finished) where ``finished`` is ``(rid, tokens)`` if the request
        already retired at admission (max_gen == 1 or instant EOS), else None."""
        free = self.free_slots
        if not free:
            raise RuntimeError("no free slot — admission must be gated on free_slots")
        L = int(prompt.shape[0])
        if max_gen < 1:
            raise ValueError("max_gen must be >= 1")
        b = free[0]
        if self.pool is not None:
            if L < 1 or L > self.max_seq:
                raise ValueError(f"prompt_len {L} exceeds the prefill buffer ({self.max_seq})")
            self.pool.reserve_or_fail(b, L, max_gen)
            self.pool.allocate_prefix(b, L)
        elif L < 1 or L + max_gen > self.max_seq:
            raise ValueError(f"prompt_len {L} + max_gen {max_gen} exceeds max_seq {self.max_seq}")
        first = self._prefill_into_slot(b, prompt)
        st = self.slots[b]
        st.rid, st.max_gen, st.generated, st.out, st.active = rid, max_gen, 1, [first], True
        st.pos = L
        st.prompt = prompt
        self.tokens_out += 1
        if (self.eos_id is not None and first == self.eos_id) or st.generated >= st.max_gen:
            st.active = False
            if self.pool is not None:
                self.pool.release(b)
            return b, (rid, st.out)
        return b, None

    def _prefill_into_slot(self, b: int, tokens: np.ndarray) -> int:
        """Run the bucketed batch-1 prefill of ``tokens`` (ids, or (L, d)
        embeddings padded in a float32 bucket) and splice its cache into slot
        ``b`` (a paged slot's pages must already be reserved and
        prefix-allocated).  Returns the sampled token."""
        L = int(tokens.shape[0])
        bucket = bucket_len(L)
        if self.cfg.embeds_input:
            padded = np.zeros((1, bucket, tokens.shape[1]), np.float32)
        else:
            padded = np.zeros((1, bucket), np.int64)
        padded[0, :L] = tokens
        toks = torch.from_numpy(padded).to(self.device)
        lengths = torch.tensor([L], dtype=torch.int32, device=self.device)
        logits, small = prefill(self.params, self._fresh1, toks, lengths, self.cfg, self._prefill_impl, self.wkv_impl)
        tok = self._sample(logits)[0]
        self.cache["index"][b] = small["index"][0]
        if self.pool is not None:
            # attention layers: template positions 0..W-1 go to the slot's
            # pages; pad positions (p >= L) go to the trailing scratch page,
            # so the scatter's only repeated indices land there.  Recurrent
            # layers: the slot's row, whole.
            W = min(bucket, self.max_seq)
            dest_t, offs_t = self._page_rows(b, W, L)
            for big, tmpl in zip(self.cache["layers"], small["layers"]):
                if "k_pool" in big:
                    for src, dst in _POOL_KEYS:
                        if dst in big:
                            big[dst][dest_t, offs_t] = tmpl[src][0, :W].to(big[dst].dtype)
                else:
                    _splice_row(big, tmpl, b)
            self._ship_table()
        else:
            for big, tmpl in zip(self.cache["layers"], small["layers"]):
                _splice_row(big, tmpl, b)
        self.last_tok[b] = tok
        self.prefills += 1
        self.prefill_tokens += L
        return int(tok)

    def _page_rows(self, b: int, n: int, live: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(page, offset) device indices of slot ``b``'s positions 0..n-1 in
        the pools; positions from ``live`` on go to the trailing scratch page.
        The table lookup is clamped: ``n`` may span more page slots than the
        table row has."""
        ps = self.layout.page_size
        pidx = np.arange(n)
        row = self.pool.table[b]
        dest = np.where(pidx < live, row[np.minimum(pidx // ps, row.shape[0] - 1)], self.layout.n_pages)
        return (torch.from_numpy(dest.astype(np.int64)).to(self.device),
                torch.from_numpy(pidx % ps).to(self.device))

    # -- preemption (paged: the slot's K/V rows travel with the resume token) ----

    def can_preempt(self, slot: int) -> bool:
        """An active PAGED slot whose live prefix still fits the prefill
        buffer can be evicted now (the reference's rule, which restores by
        re-prefill) and restored token-identically later."""
        st = self.slots[slot]
        return self.pool is not None and st.active and st.pos <= self.max_seq

    def preempt(self, slot: int) -> dict:
        """Evict an active slot: copy its live cache to host memory, release
        its pages back to the pool and return the resume token.  ``cache``
        holds, per layer, the K/V rows of positions 0..pos-1 and, in an int8
        cache, their scale rows (attention), or the slot's row of the
        recurrent state; :meth:`restore` copies them back and re-seats the
        saved last token."""
        if not self.can_preempt(slot):
            raise RuntimeError(f"slot {slot} cannot be preempted (inactive, dense, or prefix past the prefill buffer)")
        st = self.slots[slot]
        dest_t, offs_t = self._page_rows(slot, st.pos, st.pos)
        cache = []
        for big in self.cache["layers"]:
            if "k_pool" in big:
                cache.append({key: pool[dest_t, offs_t].cpu() for key, pool in big.items()})
            else:  # a copy, not a view of the row the next occupant overwrites
                cache.append({key: buf[slot].to("cpu", copy=True) for key, buf in big.items()})
        self.pool.release(slot)
        state = {
            "rid": st.rid,
            "prompt": st.prompt,
            "out": list(st.out),
            "generated": st.generated,
            "max_gen": st.max_gen,
            "pos": st.pos,
            "cache": cache,
        }
        self.slots[slot] = _Slot()
        self.preemptions += 1
        return state

    def can_restore(self, state: dict) -> bool:
        if self.pool is None or not self.free_slots or state["pos"] > self.max_seq:
            return False
        return self.pool.can_reserve(state["pos"], state["max_gen"] - state["generated"] + 1)

    def restore(self, state: dict) -> int:
        """Re-seat a preempted request: reserve pages for the remaining budget
        (the original admission's worst case), copy the saved K/V rows into
        the new pages and any recurrent row into the slot, and re-seat the
        saved last token.  The continuation is token-identical to the run
        without eviction.  Returns the slot."""
        if self.pool is None:
            raise RuntimeError("restore requires a paged engine")
        free = self.free_slots
        if not free:
            raise RuntimeError("no free slot — restore must be gated on can_restore")
        b = free[0]
        prompt, out, pos = state["prompt"], state["out"], state["pos"]
        if len(prompt) + len(out) - 1 != pos:
            raise RuntimeError(f"corrupt resume state: prefix {len(prompt) + len(out) - 1} != pos {pos}")
        self.pool.reserve_or_fail(b, pos, state["max_gen"] - state["generated"] + 1)
        self.pool.allocate_prefix(b, pos)
        dest_t, offs_t = self._page_rows(b, pos, pos)
        for big, saved in zip(self.cache["layers"], state["cache"], strict=True):
            if "k_pool" in big:
                for key, rows in saved.items():
                    big[key][dest_t, offs_t] = rows.to(self.device)
            else:
                for key, row in saved.items():
                    big[key][b] = row.to(self.device)
        self.cache["index"][b] = pos
        self._ship_table()
        self.last_tok[b] = int(out[-1])  # the saved token, not a resample
        st = self.slots[b]
        st.rid, st.max_gen, st.generated, st.active = state["rid"], state["max_gen"], state["generated"], True
        st.out = list(out)
        st.pos = pos
        st.prompt = state["prompt"]
        self.restores += 1
        return b

    # -- decode --------------------------------------------------------------

    def tick(self) -> list[tuple]:
        """One decode step over all slots; returns [(rid, tokens), ...] for
        requests that retired this tick."""
        n_active = sum(s.active for s in self.slots)
        attended = 0
        if self.pool is not None:
            ps = self.layout.page_size
            for b, st in enumerate(self.slots):
                if st.active:
                    self.pool.ensure(b, st.pos)  # allocate-on-write for this tick's K/V
                    attended += self.layout.pages_for(st.pos + 1) * ps
            self._ship_table()
        else:
            attended = self.n_slots * self.max_seq
        self.attended_key_tokens += attended
        self.last_tick_attended = attended
        self.last_tick_active = n_active
        logits, self.cache = decode_step(self.params, self.cache, self.last_tok, self.cfg)
        self.last_tok = self._sample(logits)
        self.ticks += 1
        self.active_slot_ticks += n_active
        tok_host = self.last_tok.cpu().numpy()
        finished = []
        for b, st in enumerate(self.slots):
            if not st.active:
                continue
            st.pos += 1
            t = int(tok_host[b])
            st.out.append(t)
            st.generated += 1
            self.tokens_out += 1
            if (self.eos_id is not None and t == self.eos_id) or st.generated >= st.max_gen:
                st.active = False
                if self.pool is not None:
                    self.pool.release(b)
                finished.append((st.rid, st.out))
        return finished

    # -- reporting -----------------------------------------------------------

    def metrics(self) -> dict:
        m = {
            "n_slots": self.n_slots,
            "ticks": self.ticks,
            "prefills": self.prefills,
            "prefill_tokens": self.prefill_tokens,
            "tokens_out": self.tokens_out,
            "preemptions": self.preemptions,
            "restores": self.restores,
            "attended_key_tokens": self.attended_key_tokens,
            "slot_utilization": self.active_slot_ticks / (self.ticks * self.n_slots) if self.ticks else 0.0,
        }
        if self.pool is not None:
            m["pool"] = self.pool.metrics()
        return m
