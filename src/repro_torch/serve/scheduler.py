"""Request queue, admission policy, and the serve loop (a copy of
``repro.serve.scheduler``, less the protocol model checker's
``Scheduler.fingerprint``).

Time is measured in *ticks* (one engine decode step == 1.0): deterministic
on CPU, and the unit the router's virtual clocks scale by replica speed.
Wall-clock seconds are reported alongside for real-throughput numbers.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from repro_torch.obs.hooks import NULL_SERVE_OBS

__all__ = ["Request", "SchedulerConfig", "Scheduler", "serve_loop", "summarize"]


@dataclasses.dataclass
class Request:
    """One generation request.  ``prompt``: (L,) int32 token ids (or (L, d)
    float32 embeddings for embeds-input archs)."""

    rid: int
    prompt: np.ndarray
    max_gen: int
    arrival: float = 0.0
    # filled by the serve loop:
    output: list | None = None
    t_admit: float | None = None
    t_finish: float | None = None

    @property
    def latency(self) -> float | None:
        return None if self.t_finish is None else self.t_finish - self.arrival

    @property
    def wait(self) -> float | None:
        return None if self.t_admit is None else self.t_admit - self.arrival


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """FIFO admission policy.

    max_waiting_prefill   admissions (prefills) per tick in continuous mode —
                          bounds how long decode stalls behind prefill work.
    continuous            False: static-batch baseline — admit only when the
                          engine is fully idle, then fill every slot (the old
                          serve driver's behavior, kept as the bench baseline).
    preempt               graceful degradation (paged engines): under pool
                          pressure, evict the active slot with the MOST
                          remaining generation budget back to the page pool
                          (pages are the checkpoint) so the blocked head can
                          enter; the victim restores token-identically once
                          pressure clears.
    """

    max_waiting_prefill: int = 2
    continuous: bool = True
    preempt: bool = False

    def __post_init__(self) -> None:
        if self.max_waiting_prefill < 1:
            raise ValueError("max_waiting_prefill must be >= 1 (0 would stall admission forever)")


class Scheduler:
    """FIFO queue + admission.  Retirement (EOS / max_gen) lives in the
    engine; the scheduler decides only who enters a slot and when."""

    def __init__(self, config: SchedulerConfig | None = None, obs=None) -> None:
        self.config = config or SchedulerConfig()
        self.queue: collections.deque[Request] = collections.deque()
        self.preempted: list[dict] = []  # evicted resume tokens, FIFO
        self.counters = {"retries": 0, "hedges_won": 0, "hedges_lost": 0, "preemptions": 0, "evicted_restored": 0}
        self.obs = obs if obs is not None else NULL_SERVE_OBS

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def admit(self, engine, now: float) -> list[tuple]:
        """Admit FIFO-ordered requests into free slots; returns [(rid, tokens)]
        for requests that finished already at admission.

        Backpressure: if the FIFO head cannot be admitted *right now* (paged
        engine with an exhausted page pool) it stays queued — head-of-line
        blocking keeps FIFO fairness — and admission resumes once retiring
        slots free their pages.  A request the engine could NEVER admit
        raises immediately instead of stalling the queue forever."""
        cfg = self.config
        if not cfg.continuous and engine.has_active:
            return []
        cap = cfg.max_waiting_prefill if cfg.continuous else engine.n_slots
        finished = []
        admits = 0
        # preempted work gets first claim on free slots — best-effort, not a
        # barrier: if the pool cannot cover the restore yet, younger queued
        # requests may still admit below.  That is the point of preemption
        # (interactive arrivals run ahead of the evicted batch hog); the
        # victim's re-entry is a bounded latency penalty, never a loss — the
        # serve loop cannot finish while ``preempted`` is non-empty.
        while self.preempted and engine.free_slots and admits < cap:
            state = self.preempted[0]
            if not engine.can_restore(state):
                break
            self.preempted.pop(0)
            slot = engine.restore(state)
            self.counters["evicted_restored"] += 1
            self.obs.on_restore(state["rid"], slot, now)
            admits += 1
        while self.queue and engine.free_slots and admits < cap:
            req = self.queue[0]
            L, G = int(req.prompt.shape[0]), req.max_gen
            if not engine.can_admit_now(L, G):
                if not engine.admissible(L, G):
                    raise ValueError(
                        f"request {req.rid} (prompt {L}, max_gen {G}) can never be "
                        "admitted by this engine"
                    )
                if cfg.preempt and self._preempt_for(engine, G, now):
                    continue  # pages freed — re-check the head this same call
                self.obs.on_defer("pool", now)
                break  # transient pressure (page pool) — retry next tick
            self.queue.popleft()
            slot, fin = engine.admit(req.rid, req.prompt, req.max_gen)
            req.t_admit = now
            self.obs.on_admit(req, slot, now)
            admits += 1
            if fin is not None:
                finished.append(fin)
        if self.queue and engine.free_slots and admits >= cap:
            self.obs.on_defer("prefill_cap", now)
        return finished

    def _preempt_for(self, engine, incoming_gen: int, now: float) -> bool:
        """Evict the active slot with the most remaining generation budget IF
        it strictly exceeds the incoming request's — interactive work preempts
        batch work, never the reverse, and the strict inequality rules out
        eviction cycles.  Returns True if a victim's pages were freed."""
        victim, rem = None, incoming_gen
        for b, st in enumerate(engine.slots):
            if not st.active or not engine.can_preempt(b):
                continue
            r = st.max_gen - st.generated
            if r > rem:
                victim, rem = b, r
        if victim is None:
            return False
        state = engine.preempt(victim)
        self.preempted.append(state)
        self.counters["preemptions"] += 1
        self.obs.on_preempt(state["rid"], victim, now)
        return True


def serve_loop(
    engine,
    requests: list[Request],
    config: SchedulerConfig | None = None,
    *,
    obs=None,
    tick_cost=None,
) -> dict:
    """Drive ``engine`` through ``requests`` (arrivals in tick time).

    Mutates each request's ``output``/``t_admit``/``t_finish`` in place and
    returns ``summarize(...)`` of the run.

    ``obs`` (a :class:`repro_torch.obs.ServeObs`) receives admit/defer/tick/finish
    hooks on the tick clock.  ``tick_cost``, if given, maps ``engine`` (after
    its decode step) to that tick's duration in seconds — a cost model, or
    the wall seconds the tick took; the default keeps 1 tick == 1.0,
    bit-identical to the uninstrumented loop."""
    obs = obs if obs is not None else NULL_SERVE_OBS
    sched = Scheduler(config, obs=obs)
    pending = collections.deque(sorted(requests, key=lambda r: r.arrival))
    by_rid = {r.rid: r for r in requests}
    if len(by_rid) != len(requests):
        raise ValueError("duplicate request ids")
    clock = 0.0
    t0 = time.time()

    def complete(rid: int, toks: list, now: float) -> None:
        r = by_rid[rid]
        r.output = toks
        r.t_finish = now
        obs.on_finish(r, now)

    while pending or sched.queue or sched.preempted or engine.has_active:
        while pending and pending[0].arrival <= clock + 1e-9:
            sched.submit(pending.popleft())
        for rid, toks in sched.admit(engine, clock):
            complete(rid, toks, clock)
        if engine.has_active:
            retired = engine.tick()
            dt = 1.0 if tick_cost is None else float(tick_cost(engine))
            clock += dt
            for rid, toks in retired:
                complete(rid, toks, clock)
            obs.on_tick(clock, dt, engine, len(sched.queue))
        elif pending:
            clock = max(clock, pending[0].arrival)
        elif sched.queue or sched.preempted:  # idle engine + parked work: admit next loop pass
            continue
    wall_s = time.time() - t0
    return summarize(requests, engine, clock, wall_s, counters=sched.counters)


def summarize(
    requests: list[Request], engine, ticks_elapsed: float, wall_s: float, counters: dict | None = None
) -> dict:
    lat = np.array([r.latency for r in requests if r.latency is not None], np.float64)
    wait = np.array([r.wait for r in requests if r.wait is not None], np.float64)
    gen_tokens = sum(len(r.output) for r in requests if r.output is not None)
    m = engine.metrics()
    robust = {"retries": 0, "hedges_won": 0, "hedges_lost": 0, "preemptions": 0, "evicted_restored": 0}
    robust.update(counters or {})
    return {
        "requests": len(requests),
        "completed": int((lat >= 0).sum()),
        "gen_tokens": gen_tokens,
        "ticks": m["ticks"],
        "ticks_elapsed": ticks_elapsed,
        "wall_s": round(wall_s, 3),
        "throughput_tok_per_s": round(gen_tokens / wall_s, 1) if wall_s > 0 else None,
        "throughput_tok_per_tick": round(gen_tokens / max(ticks_elapsed, 1e-9), 3),
        "latency_ticks_p50": float(np.percentile(lat, 50)) if lat.size else None,
        "latency_ticks_p95": float(np.percentile(lat, 95)) if lat.size else None,
        "wait_ticks_p50": float(np.percentile(wait, 50)) if wait.size else None,
        "slot_utilization": round(m["slot_utilization"], 3),
        "prefills": m["prefills"],
        "prefill_tokens": m["prefill_tokens"],
        **robust,
    }
