"""Protocol model of paged-KV admission, driving the REAL production
classes: :class:`~repro_torch.serve.paged.PagePool` and
:class:`~repro_torch.serve.scheduler.Scheduler` (the JAX package's
``analysis/protocol/serve_model.py`` over the port's classes).

The device half of the serve engine (prefill/decode) is replaced by
:class:`_ModelEngine`, a host-side twin that performs exactly the pool and
slot bookkeeping ``ServeEngine`` performs — same call sequence
(``reserve_or_fail`` + ``allocate_prefix`` at admission, ``ensure`` then
position/counter increments at each tick — every slot's ``ensure`` before
any retirement, as the engine's decode writes them all — whole-table ``release`` on
EOS/max_gen retirement, retire-at-admission for ``max_gen == 1``) — so the
real ``Scheduler.admit`` drives it through the identical engine protocol
(``free_slots`` / ``has_active`` / ``admissible`` / ``can_admit_now`` /
``admit`` / ``n_slots``).  Token VALUES never influence pool accounting, so
the twin covers the full admission/retire state machine without a device.

The model interleaves submit / admit / tick / EOS-retire / reset actions
and machine-checks on EVERY reachable state:

* ``PagePool.check_leak_free()`` — every page free or held exactly once;
* **no stale occupancy**: a slot with no active request holds no pages and
  no reservation (catches the drop-release bug class: ``check_leak_free``
  alone cannot, because a leaked page is still held exactly once);
* **reservation-gated admission never strands a request**: every active
  slot's outstanding need (reserved − allocated pages) is covered by the
  free list, so an admitted request can always run to its generation
  budget — the paper-level guarantee the reservation exists to provide;
* reservation/allocation accounting per slot matches the slot's position
  (``allocated == pages_for(pos)``, never past the reservation).

FIFO backpressure deadlocks surface through the explorer's deadlock
detection: ``quiescent`` is "queue empty and no active slot", so a state
where queued work can never admit and nothing can tick is reported with a
shortest replayable script.

:func:`replay_on_engines` holds the twin to that claim: it replays a script
on the twin and on real paged ``ServeEngine`` instances (one a replica) and
compares the pool fingerprints, slots and resume tokens after every action.
That check found the JAX package's twin ensuring and retiring slot by slot
within a tick, where the engine ensures every slot first; the twin here
follows the engine, so the clean ``ServeModel`` graph has 518 states where
the JAX package's has 498.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from repro_torch.models.attention import PagedLayout
from repro_torch.serve.paged import PagePool
from repro_torch.analysis.protocol.explorer import format_script
from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig

__all__ = [
    "ServeModel",
    "ServeState",
    "ServeFaultModel",
    "ServeFaultState",
    "engine_kwargs",
    "leaf_scripts",
    "replay_on_engines",
    "solo_tokens",
]

# (prompt_len, max_gen) menu — shapes the submit action can enqueue.  All
# admissible for the default pool; (5, 1) also covers retire-at-admission.
_DEFAULT_SHAPES = ((1, 3), (3, 2), (5, 1))


@dataclasses.dataclass
class _SlotRT:
    """Host bookkeeping of one active slot, mirroring ``ServeEngine._Slot``:
    ``pos`` = next KV position to write, ``generated`` counts sampled
    tokens, ``eos`` marks that this slot's next sampled token is EOS."""

    rid: int
    pos: int
    generated: int
    max_gen: int
    eos: bool = False


class _ModelEngine:
    """ServeEngine's admission/retire bookkeeping with the device removed —
    the object handed to the REAL ``Scheduler.admit``."""

    def __init__(self, layout: PagedLayout, n_slots: int, buggy: str | None = None) -> None:
        self.layout = layout
        self.n_slots = n_slots
        self.pool = PagePool(layout, n_slots)
        self.slots: dict[int, _SlotRT] = {}
        self.buggy = buggy

    @property
    def has_active(self) -> bool:
        return bool(self.slots)

    @property
    def free_slots(self) -> list[int]:
        return [b for b in range(self.n_slots) if b not in self.slots]

    def admissible(self, prompt_len: int, max_gen: int) -> bool:
        return prompt_len >= 1 and max_gen >= 1 and self.pool.fits(prompt_len, max_gen)

    def can_admit_now(self, prompt_len: int, max_gen: int) -> bool:
        if not self.admissible(prompt_len, max_gen) or not self.free_slots:
            return False
        return self.pool.can_reserve(prompt_len, max_gen)

    def admit(self, rid: int, prompt: np.ndarray, max_gen: int) -> tuple[int, tuple | None]:
        b = self.free_slots[0]
        L = int(prompt.shape[0])
        self.pool.reserve_or_fail(b, L, max_gen)
        self.pool.allocate_prefix(b, L)
        if max_gen <= 1:  # retires at admission, like ServeEngine.admit
            self._retire(b)
            return b, (rid, [0])
        self.slots[b] = _SlotRT(rid=rid, pos=L, generated=1, max_gen=max_gen)
        return b, None

    def tick(self) -> list[tuple]:
        # every active slot's page first, then the retirements: the decode
        # step writes all slots' K/V before any slot retires, so a page
        # released this tick cannot back another slot's write of this tick
        # (``ServeEngine.tick``).  The JAX package's twin interleaves the two
        # per slot, so its free list and tables part from the engine's.
        for b in sorted(self.slots):
            self.pool.ensure(b, self.slots[b].pos)  # allocate-on-write for this tick's K/V
        finished = []
        for b in sorted(self.slots):
            st = self.slots[b]
            st.pos += 1
            st.generated += 1
            if st.eos or st.generated >= st.max_gen:
                del self.slots[b]
                self._retire(b)
                finished.append((st.rid, st.generated))
        return finished

    def reset(self) -> None:
        """Mirror ``ServeEngine.reset``: audit the outgoing pool's accounting
        (``check_leak_free``), then rebuild it and free every slot."""
        self.pool.check_leak_free()
        self.pool = PagePool(self.layout, self.n_slots)
        self.slots = {}

    # preemption twin: the same pool call sequence as ServeEngine.preempt/
    # restore (release everything; later reserve the identical worst case
    # pages_for(pos + rem - 1) and re-allocate the pos-prefix)

    def preempt(self, b: int) -> dict:
        st = self.slots.pop(b)
        self.pool.release(b)
        return {"rid": st.rid, "pos": st.pos, "generated": st.generated, "max_gen": st.max_gen, "eos": st.eos}

    def can_restore(self, state: dict) -> bool:
        if not self.free_slots:
            return False
        return self.pool.can_reserve(state["pos"], state["max_gen"] - state["generated"] + 1)

    def restore(self, state: dict) -> int:
        b = self.free_slots[0]
        self.pool.reserve_or_fail(b, state["pos"], state["max_gen"] - state["generated"] + 1)
        self.pool.allocate_prefix(b, state["pos"])
        self.slots[b] = _SlotRT(
            rid=state["rid"],
            pos=state["pos"],
            generated=state["generated"],
            max_gen=state["max_gen"],
            eos=state["eos"],
        )
        return b

    def _retire(self, b: int) -> None:
        if self.buggy != "drop-release":
            self.pool.release(b)

    def fingerprint(self) -> tuple:
        return (
            self.pool.fingerprint(),
            tuple(
                (b, st.pos, st.generated, st.max_gen, st.eos)
                for b, st in sorted(self.slots.items())
            ),
        )


@dataclasses.dataclass
class ServeState:
    sched: Scheduler
    engine: _ModelEngine
    submits_left: int
    resets_left: int
    next_rid: int = 0  # bookkeeping only — excluded from the fingerprint


class ServeModel:
    """Bounded model of submit -> admit -> tick -> retire over the real pool
    and scheduler.

    ``buggy="drop-release"`` seeds the known-bad variant for the CLI
    selftest: retirement forgets ``PagePool.release``, so a finished slot
    keeps its reservation and pages — caught by the stale-occupancy
    invariant (and, once the pool is starved dry, by deadlock detection).
    """

    def __init__(
        self,
        page_size: int = 2,
        n_pages: int = 4,
        n_slots: int = 2,
        shapes=_DEFAULT_SHAPES,
        submits: int = 3,
        resets: int = 1,
        buggy: str | None = None,
    ) -> None:
        if buggy not in (None, "drop-release"):
            raise ValueError(f"unknown buggy variant {buggy!r}")
        self.layout = PagedLayout(page_size=page_size, n_pages=n_pages)
        self.n_slots = n_slots
        self.shapes = tuple(shapes)
        self.submits = submits
        self.resets = resets
        self.buggy = buggy
        for L, G in self.shapes:
            if not self.layout.pages_for(L + G - 1) <= min(n_pages, self.layout.pages_per_slot):
                raise ValueError(f"shape ({L}, {G}) can never be admitted — bad model config")

    # -- model interface -----------------------------------------------------

    def initial(self) -> ServeState:
        return ServeState(
            sched=Scheduler(SchedulerConfig(max_waiting_prefill=1, continuous=True)),
            engine=_ModelEngine(self.layout, self.n_slots, buggy=self.buggy),
            submits_left=self.submits,
            resets_left=self.resets,
        )

    def actions(self, s: ServeState) -> list[str]:
        acts: list[str] = []
        if s.submits_left > 0:
            for L, G in self.shapes:
                acts.append(f"submit:{L}x{G}")
        if s.sched.queue:
            head = s.sched.queue[0]
            # enabled only when the real admit would make progress — a
            # blocked head with nothing ticking is then a detectable deadlock
            if s.engine.can_admit_now(int(head.prompt.shape[0]), head.max_gen):
                acts.append("admit")
        if s.engine.has_active:
            acts.append("tick")
            for b, st in sorted(s.engine.slots.items()):
                if st.generated + 1 < st.max_gen:  # EOS before the natural retire tick
                    acts.append(f"eos:{b}")
        if s.resets_left > 0:
            acts.append("reset")
        return sorted(acts)

    def apply(self, state: ServeState, action: str) -> ServeState:
        s = copy.deepcopy(state)
        kind, _, spec = action.partition(":")
        if kind == "submit":
            left, _, right = spec.partition("x")
            L, G = int(left), int(right)
            s.sched.submit(Request(rid=s.next_rid, prompt=np.zeros(L, np.int32), max_gen=G))
            s.next_rid += 1
            s.submits_left -= 1
        elif kind == "admit":
            s.sched.admit(s.engine, now=0.0)
        elif kind == "tick":
            s.engine.tick()
        elif kind == "eos":
            s.engine.slots[int(spec)].eos = True
        elif kind == "reset":
            s.engine.reset()
            s.resets_left -= 1
        else:
            raise ValueError(f"unknown action {action!r}")
        return s

    def fingerprint(self, s: ServeState) -> tuple:
        return (
            s.sched.fingerprint(),
            s.engine.fingerprint(),
            s.submits_left,
            s.resets_left,
        )

    def invariants(self, s: ServeState) -> list[str]:
        return _pool_invariants(s.engine, self.layout)

    def quiescent(self, s: ServeState) -> bool:
        # remaining submit/reset budget is an option, not an obligation — a
        # run is complete once the queue drained and every slot retired
        return not s.sched.queue and not s.engine.has_active


def _pool_invariants(engine: _ModelEngine, layout: PagedLayout, who: str = "") -> list[str]:
    """The paged-accounting invariants shared by both serve models: leak-free
    pool, no stale occupancy, admission always reservation-gated, allocation
    matches the slot position, reservations covered by the free list."""
    msgs: list[str] = []
    pool = engine.pool
    try:
        pool.check_leak_free()
    except RuntimeError as e:
        msgs.append(f"{who}{e}")
    strand_need = 0
    for b in range(engine.n_slots):
        reserved = int(pool._reserved[b])
        allocated = int(pool._allocated[b])
        pages = pool.slot_pages(b)
        st = engine.slots.get(b)
        if st is None:
            if pages or reserved or allocated:
                msgs.append(
                    f"{who}slot {b} has no active request but holds pages={pages} "
                    f"reserved={reserved} allocated={allocated} — retirement "
                    "leaked its reservation (missing release?)"
                )
            continue
        if reserved <= 0:
            msgs.append(f"{who}active slot {b} has no reservation — admission was not gated")
        if allocated != layout.pages_for(st.pos) or allocated != len(pages):
            msgs.append(
                f"{who}slot {b} accounting drift: pos={st.pos} expects "
                f"{layout.pages_for(st.pos)} pages, allocated={allocated}, "
                f"table holds {len(pages)}"
            )
        strand_need += max(reserved - allocated, 0)
    if strand_need > pool.free_pages:
        msgs.append(
            f"{who}reservation not covered: active slots still need {strand_need} "
            f"page(s) but only {pool.free_pages} are free — an admitted "
            "request can be stranded mid-generation"
        )
    return msgs


# ---------------------------------------------------------------------------
# fault-tolerant delivery model: replicas, retry, hedging, preemption
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeFaultState:
    engines: list[_ModelEngine]
    alive: list[bool]
    queues: list[list[int]]  # per-replica FIFO of rids
    pending: list[int]  # router pool: fresh submits + orphans awaiting (re)dispatch
    stash: list[list[dict]]  # per-replica preempted resume tokens
    shape_of: dict[int, tuple[int, int]]
    delivered: dict[int, int]  # rid -> completions delivered to the caller
    suppressed: int  # duplicate completions suppressed by rid
    hedged: set[int]
    restored_log: list[tuple]  # ((saved pos, gen, max_gen), (restored ...)) pairs
    submits_left: int
    deaths_left: int
    hedges_left: int
    preempts_left: int
    next_rid: int = 0


class ServeFaultModel:
    """Bounded model of the fault-tolerant delivery protocol: N replicas
    (each a :class:`_ModelEngine` over a real :class:`PagePool`), a router
    retry pool, hedged duplicates with first-completion-wins suppression,
    and paged preemption — exhaustively interleaved.

    Actions: ``submit`` (a request enters the router pool), ``retry:R``
    (the pool head is (re)dispatched onto replica R — initial routing and
    post-death retry are the same protocol step; mirroring the router, the
    copy is DROPPED instead when the rid is already in flight on a live
    replica, so two copies of one rid never co-locate), ``admit:R`` /
    ``tick:R``
    (replica R makes progress), ``replica_die:R`` (R is killed mid-flight:
    its queued, in-flight, AND preempted requests are orphaned back to the
    pool; the engine resets like ``EngineReplica.kill``), ``hedge:R`` (the
    lowest-rid unhedged in-flight request gains a duplicate on R),
    ``preempt:R`` / ``restore:R`` (R evicts its busiest slot to the pool
    stash and later re-seats it).

    Invariants on every reachable state:

    * **no request lost** — every submitted rid is delivered or still held
      somewhere (pool, a queue, a slot, a stash);
    * **no request completed twice** — at most one completion per rid is
      delivered; extra copies (hedge losers, post-death duplicates) are
      suppressed.  ``buggy="double-deliver"`` skips the suppression and is
      caught here — the CLI selftest's known-bad model;
    * **preempted state restores exactly** — every restore re-seats the
      saved (pos, generated, max_gen) unchanged;
    * the shared paged-accounting invariants, per replica.
    """

    def __init__(
        self,
        n_replicas: int = 2,
        page_size: int = 2,
        n_pages: int = 2,
        shapes=((1, 3), (2, 1)),
        submits: int = 2,
        deaths: int = 1,
        hedges: int = 1,
        preempts: int = 1,
        buggy: str | None = None,
    ) -> None:
        if buggy not in (None, "double-deliver"):
            raise ValueError(f"unknown buggy variant {buggy!r}")
        if n_replicas < 2:
            raise ValueError("the delivery protocol needs >= 2 replicas")
        self.n_replicas = n_replicas
        self.layout = PagedLayout(page_size=page_size, n_pages=n_pages)
        self.shapes = tuple(shapes)
        self.submits = submits
        self.deaths = deaths
        self.hedges = hedges
        self.preempts = preempts
        self.buggy = buggy
        for L, G in self.shapes:
            if not self.layout.pages_for(L + G - 1) <= min(n_pages, self.layout.pages_per_slot):
                raise ValueError(f"shape ({L}, {G}) can never be admitted — bad model config")

    def initial(self) -> ServeFaultState:
        return ServeFaultState(
            engines=[_ModelEngine(self.layout, 1) for _ in range(self.n_replicas)],
            alive=[True] * self.n_replicas,
            queues=[[] for _ in range(self.n_replicas)],
            pending=[],
            stash=[[] for _ in range(self.n_replicas)],
            shape_of={},
            delivered={},
            suppressed=0,
            hedged=set(),
            restored_log=[],
            submits_left=self.submits,
            deaths_left=self.deaths,
            hedges_left=self.hedges,
            preempts_left=self.preempts,
        )

    def _hedge_candidate(self, s: ServeFaultState, to: int) -> int | None:
        """Lowest-rid undelivered request held by another ALIVE replica and
        not already duplicated onto ``to`` (one clone per rid)."""
        held: list[int] = []
        for i in range(self.n_replicas):
            if not s.alive[i] or i == to:
                continue
            held.extend(s.queues[i])
            held.extend(st.rid for st in s.engines[i].slots.values())
        on_to = set(s.queues[to]) | {st.rid for st in s.engines[to].slots.values()}
        cands = [rid for rid in held if rid not in s.hedged and rid not in on_to and not s.delivered.get(rid)]
        return min(cands) if cands else None

    def actions(self, s: ServeFaultState) -> list[str]:
        acts: list[str] = []
        alive = [i for i in range(self.n_replicas) if s.alive[i]]
        if s.submits_left > 0:
            for L, G in self.shapes:
                acts.append(f"submit:{L}x{G}")
        for i in alive:
            eng = s.engines[i]
            if s.pending:
                acts.append(f"retry:{i}")
            if s.queues[i]:
                L, G = s.shape_of[s.queues[i][0]]
                if eng.can_admit_now(L, G):
                    acts.append(f"admit:{i}")
            if eng.has_active:
                acts.append(f"tick:{i}")
            if s.deaths_left > 0 and len(alive) > 1:
                acts.append(f"replica_die:{i}")
            if s.hedges_left > 0 and self._hedge_candidate(s, i) is not None:
                acts.append(f"hedge:{i}")
            if s.preempts_left > 0 and eng.has_active:
                acts.append(f"preempt:{i}")
            if s.stash[i] and eng.can_restore(s.stash[i][0]):
                acts.append(f"restore:{i}")
        return sorted(acts)

    def _deliver(self, s: ServeFaultState, rid: int) -> None:
        if s.delivered.get(rid, 0) >= 1 and self.buggy != "double-deliver":
            s.suppressed += 1  # first completion won; this copy is a duplicate
            return
        s.delivered[rid] = s.delivered.get(rid, 0) + 1

    def apply(self, state: ServeFaultState, action: str) -> ServeFaultState:
        s = copy.deepcopy(state)
        kind, _, spec = action.partition(":")
        if kind == "submit":
            left, _, right = spec.partition("x")
            s.shape_of[s.next_rid] = (int(left), int(right))
            s.pending.append(s.next_rid)
            s.next_rid += 1
            s.submits_left -= 1
            return s
        i = int(spec)
        eng = s.engines[i]
        if kind == "retry":
            rid = s.pending.pop(0)
            held = any(
                rid in s.queues[j]
                or any(st.rid == rid for st in s.engines[j].slots.values())
                or any(t["rid"] == rid for t in s.stash[j])
                for j in range(self.n_replicas)
                if s.alive[j]
            )
            # router drop rule: if another copy of this rid (a hedge clone,
            # or the original when the clone's replica died) is still in
            # flight on a live replica, the orphan is dropped instead of
            # re-dispatched — re-dispatch could co-locate two copies of one
            # rid on one replica, which rid-keyed slot bookkeeping cannot
            # represent.  Not a loss: the surviving copy delivers.
            if not held:
                s.queues[i].append(rid)
        elif kind == "admit":
            rid = s.queues[i].pop(0)
            L, G = s.shape_of[rid]
            _, fin = eng.admit(rid, np.zeros(L, np.int32), G)
            if fin is not None:
                self._deliver(s, rid)
        elif kind == "tick":
            for rid, _gen in eng.tick():
                self._deliver(s, rid)
        elif kind == "replica_die":
            # orphan everything the replica held — queued, in-flight, and
            # preempted-evicted — back to the router pool (the prompt is the
            # checkpoint); the engine resets like EngineReplica.kill()
            orphans = list(s.queues[i])
            orphans += [st.rid for _, st in sorted(eng.slots.items())]
            orphans += [t["rid"] for t in s.stash[i]]
            s.queues[i] = []
            s.stash[i] = []
            eng.reset()
            s.alive[i] = False
            s.pending.extend(orphans)
            s.deaths_left -= 1
        elif kind == "hedge":
            rid = self._hedge_candidate(s, i)
            s.hedged.add(rid)
            s.queues[i].append(rid)
            s.hedges_left -= 1
        elif kind == "preempt":
            b = min(eng.slots)
            s.stash[i].append(eng.preempt(b))
            s.preempts_left -= 1
        elif kind == "restore":
            t = s.stash[i].pop(0)
            b = eng.restore(t)
            got = eng.slots[b]
            s.restored_log.append(
                ((t["pos"], t["generated"], t["max_gen"]), (got.pos, got.generated, got.max_gen))
            )
        else:
            raise ValueError(f"unknown action {action!r}")
        return s

    def fingerprint(self, s: ServeFaultState) -> tuple:
        return (
            tuple(s.alive),
            tuple(
                e.fingerprint() + (tuple(sorted((b, st.rid) for b, st in e.slots.items())),) for e in s.engines
            ),
            tuple(tuple(q) for q in s.queues),
            tuple(s.pending),
            tuple(tuple(tuple(sorted(t.items())) for t in r) for r in s.stash),
            tuple(sorted(s.shape_of.items())),
            tuple(sorted(s.delivered.items())),
            s.suppressed,
            tuple(sorted(s.hedged)),
            tuple(s.restored_log),
            (s.submits_left, s.deaths_left, s.hedges_left, s.preempts_left, s.next_rid),
        )

    def invariants(self, s: ServeFaultState) -> list[str]:
        msgs: list[str] = []
        for i, eng in enumerate(s.engines):
            msgs.extend(_pool_invariants(eng, self.layout, who=f"replica {i}: "))
        held = set(s.pending)
        for i in range(self.n_replicas):
            held.update(s.queues[i])
            held.update(st.rid for st in s.engines[i].slots.values())
            held.update(t["rid"] for t in s.stash[i])
        for rid in range(s.next_rid):
            if s.delivered.get(rid, 0) == 0 and rid not in held:
                msgs.append(f"request {rid} lost: never delivered and held nowhere")
            if s.delivered.get(rid, 0) > 1:
                msgs.append(f"request {rid} completed twice: delivered {s.delivered[rid]} times")
        for saved, got in s.restored_log:
            if saved != got:
                msgs.append(f"preempted state restored inexactly: saved {saved}, restored {got}")
        return msgs

    def quiescent(self, s: ServeFaultState) -> bool:
        # remaining fault budget is an option, not an obligation — a run is
        # complete once nothing is pending, queued, in flight, or stashed
        return (
            not s.pending
            and not any(s.queues)
            and not any(e.has_active for e in s.engines)
            and not any(s.stash)
        )


# ---------------------------------------------------------------------------
# the twin against the real engine
# ---------------------------------------------------------------------------


def engine_kwargs(model) -> dict:
    """``ServeEngine`` keywords whose paged pool and slots are ``model``'s
    twin's: the same page size and pool, the model's slots (one a replica in
    :class:`ServeFaultModel`), and a prefill buffer spanning a slot's whole
    page row, so ``max_seq`` refuses nothing the twin admits."""
    layout = model.layout
    return dict(
        attn_impl="paged",
        page_size=layout.page_size,
        pool_pages=layout.n_pages,
        n_slots=model.n_slots if isinstance(model, ServeModel) else 1,
        max_seq=layout.page_size * layout.pages_per_slot,
    )


def leaf_scripts(model, max_depth: int) -> list[tuple[str, ...]]:
    """The action paths of the leaves of ``model``'s breadth-first
    shortest-path tree to ``max_depth``, in discovery order, with ``eos:B``
    left out of the search (the real engine's EOS depends on the sampled
    token, so it has no scripted counterpart)."""
    init = model.initial()
    fp0 = model.fingerprint(init)
    parent = {fp0: None}
    queue = [(init, fp0, 0)]
    for state, fp, d in queue:
        if d >= max_depth:
            continue
        for action in model.actions(state):
            if action.startswith("eos:"):
                continue
            nxt = model.apply(state, action)
            nfp = model.fingerprint(nxt)
            if nfp not in parent:
                parent[nfp] = (fp, action)
                queue.append((nxt, nfp, d + 1))
    inner = {p[0] for p in parent.values() if p is not None}
    scripts = []
    for _, fp, _ in queue:
        if fp in inner:
            continue
        steps = []
        while parent[fp] is not None:
            fp, action = parent[fp]
            steps.append(action)
        scripts.append(tuple(reversed(steps)))
    return scripts


def _slots_view(engine) -> tuple:
    """(slot, rid, pos, generated, max_gen) of every active slot, from a twin
    or a real engine."""
    if isinstance(engine, _ModelEngine):
        return tuple((b, st.rid, st.pos, st.generated, st.max_gen) for b, st in sorted(engine.slots.items()))
    return tuple((b, st.rid, st.pos, st.generated, st.max_gen) for b, st in enumerate(engine.slots) if st.active)


def _stash_view(stash: list[dict]) -> tuple:
    return tuple((t["rid"], t["pos"], t["generated"], t["max_gen"]) for t in stash)


def _same(what: str, real, twin) -> None:
    if real != twin:  # raised, not asserted: the check must hold under ``python -O`` too
        raise AssertionError(f"{what} {real} != twin {twin}")


def replay_on_engines(model, script, make_engine) -> dict:
    """Replay ``script`` on ``model``'s twin and on real paged engines, and
    raise ``AssertionError`` at the first action after which they differ.

    ``make_engine()`` returns a fresh (or reset) ``ServeEngine`` with
    :func:`engine_kwargs` (the caller picks the model, weights and device).
    :class:`ServeModel`: one engine behind a real ``Scheduler`` with the
    twin's policy; ``submit`` enqueues a request whose prompt is drawn from
    a generator seeded by its rid.  :class:`ServeFaultModel`: one engine a replica;
    ``admit:R``, ``tick:R``, ``preempt:R``, ``restore:R`` and
    ``replica_die:R`` (a reset) run on replica R's engine, the real resume
    tokens kept per replica as the model's stash; routing, hedging and
    delivery stay the model's.  After every action the pools'
    ``fingerprint()``, the active slots' (rid, pos, generated, max_gen),
    the scheduler's fingerprint (ServeModel) and the stashes' (rid, pos,
    generated, max_gen) (ServeFaultModel) must be equal.

    Returns ``{"finished": [(action index, replica, rid, tokens)],
    "restored": rids restored at least once, "prompts": {rid: prompt},
    "actions": len(script)}``."""
    faults = isinstance(model, ServeFaultModel)
    if not faults and not isinstance(model, ServeModel):
        raise TypeError(f"no real engine mirrors {type(model).__name__}")
    state = model.initial()
    engines = [make_engine() for _ in range(model.n_replicas if faults else 1)]
    for eng in engines:
        want = engine_kwargs(model)
        got = dict(attn_impl=eng.attn_impl, page_size=eng.layout.page_size, pool_pages=eng.layout.n_pages,
                   n_slots=eng.n_slots, max_seq=eng.max_seq)
        if got != want:
            raise ValueError(f"engine geometry {got} is not the twin's {want}")
    sched = None if faults else Scheduler(state.sched.config)
    stash: list[list[dict]] = [[] for _ in engines]
    prompts: dict[int, np.ndarray] = {}
    finished: list[tuple] = []
    restored: set[int] = set()

    def prompt(rid: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(rid)
        prompts[rid] = rng.integers(0, engines[0].cfg.vocab_size, n).astype(np.int32)
        return prompts[rid]

    for i, action in enumerate(script):
        if action not in model.actions(state):
            raise ValueError(f"action {i} {action!r} is not enabled in the twin")
        kind, _, spec = action.partition(":")
        if kind == "eos":
            raise ValueError("eos has no real counterpart: the engine's EOS depends on the sampled token")
        if kind == "submit":
            L, G = (int(x) for x in spec.split("x"))
            toks = prompt(state.next_rid, L)
            if not faults:
                sched.submit(Request(rid=state.next_rid, prompt=toks, max_gen=G))
        elif not faults:
            eng = engines[0]
            if kind == "admit":
                done = sched.admit(eng, now=0.0)
            elif kind == "tick":
                done = eng.tick()
            elif kind == "reset":
                eng.reset()
                done = []
            else:
                raise ValueError(f"unknown action {action!r}")
            finished += [(i, 0, rid, list(toks)) for rid, toks in done]
        else:
            r = int(spec)
            eng = engines[r]
            if kind == "admit":
                rid = state.queues[r][0]
                _, fin = eng.admit(rid, prompts[rid], state.shape_of[rid][1])
                finished += [(i, r, fin[0], list(fin[1]))] if fin is not None else []
            elif kind == "tick":
                finished += [(i, r, rid, list(toks)) for rid, toks in eng.tick()]
            elif kind == "replica_die":
                eng.reset()
                stash[r] = []
            elif kind == "preempt":
                stash[r].append(eng.preempt(min(b for b, st in enumerate(eng.slots) if st.active)))
            elif kind == "restore":
                t = stash[r].pop(0)
                eng.restore(t)
                restored.add(t["rid"])
            elif kind not in ("retry", "hedge"):
                raise ValueError(f"unknown action {action!r}")
        state = model.apply(state, action)
        twins = state.engines if faults else [state.engine]
        where = f"after action {i} {action!r} of {format_script(script)}"
        for r, (twin, eng) in enumerate(zip(twins, engines)):
            _same(f"{where}, replica {r}: pool", eng.pool.fingerprint(), twin.pool.fingerprint())
            _same(f"{where}, replica {r}: slots", _slots_view(eng), _slots_view(twin))
            if faults:
                _same(f"{where}, replica {r}: stash", _stash_view(stash[r]), _stash_view(state.stash[r]))
        if not faults:
            _same(f"{where}: scheduler", sched.fingerprint(), state.sched.fingerprint())
    return {"finished": finished, "restored": restored, "prompts": prompts, "actions": len(script)}


def solo_tokens(engine, prompt: np.ndarray, max_gen: int) -> list[int]:
    """``prompt``'s tokens on ``engine`` (reset first) with no other request
    and no eviction: what a replayed request must give."""
    engine.reset()
    _, fin = engine.admit(0, prompt, max_gen)
    while fin is None:
        done = engine.tick()
        fin = done[0] if done else None
    return list(fin[1])
