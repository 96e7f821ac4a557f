"""Heterogeneity-aware traffic router — the paper's allocator as a plug-in
(the port of ``repro.serve.router``: the same arithmetic, and every decision
in the same order, so a routed run's summary equals the reference's).

The paper closes by claiming the adaptive allocation algorithm "can be used
as a plug-in for AllReduce and its variant algorithms".  Serving realizes
the same claim for inference: replace per-worker *microbatch counts* with
per-replica *traffic shares*, and per-worker gradient-compute times with
measured per-replica tokens/sec.  The controller is literally the training
one (``AdaptiveAllocationController``): each observation window we convert
the measured speed v_i into the time t_i = w_i / v_i that replica i would
need for its current share w_i — exactly the timing interface the training
loop feeds — and the eq. 10 update returns the next share vector.

Replicas run on *virtual clocks*: a real (or modeled) engine processes real
tokens, but a tick costs ``1/speed`` virtual seconds on a replica of
relative ``speed`` — the same modeled-hardware device this repo uses for
heterogeneous training on one CPU (``core/hetero.py``).  Replica
add/remove/replace mirror the elastic runtime's fig. 11 membership changes,
warm-starting the controller with measured survivor speeds via ``resize``.

Fault tolerance: ``run_router(faults=...)`` drives the fault grammar of ``traces.faults``
against the fleet — ``slow``/``netdeg`` scale per-replica tick cost through
``FaultyReplicaClock`` (the serving mirror of ``FaultyTimingSource``), and
``outage``/``fail`` kill live replicas mid-flight.  A killed replica's
unfinished requests (queued AND in-flight) are re-queued and re-dispatched:
the prompt is the checkpoint, so a deterministic re-prefill on a survivor
reproduces the exact tokens the fault-free run would have produced.
Stalled requests past ``hedge_timeout`` are hedged to a second replica;
the first completion wins and the duplicate is suppressed by request id —
the delivery protocol the ``ServeFaultModel`` checker proves exactly-once.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.controller import AdaptiveAllocationController, ControllerConfig
from repro_torch.core.hetero import GPU_RELATIVE_THROUGHPUT, normalize_gpu
from repro_torch.serve.scheduler import Request
from repro_torch.traces.faults import FaultInjector, FaultyReplicaClock, parse_faults

__all__ = ["RouterConfig", "TrafficRouter", "EngineReplica", "ModelReplica", "run_router"]


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    policy: str = "adaptive"  # "adaptive" (Algorithm 1) or "equal" (baseline)
    total_shares: int = 32  # the controller's C — granularity of the split
    window: int = 8  # assignments between controller observations
    ema_beta: float = 0.3

    def __post_init__(self) -> None:
        if self.policy not in ("adaptive", "equal"):
            raise ValueError(f"unknown router policy {self.policy!r}")
        if self.window < 1:
            raise ValueError("window must be >= 1")


class TrafficRouter:
    """Weighted-deficit request assignment driven by controller shares."""

    def __init__(self, n_replicas: int, config: RouterConfig | None = None) -> None:
        self.config = config or RouterConfig()
        self._ctl: AdaptiveAllocationController | None = None
        if self.config.policy == "adaptive":
            self._ctl = AdaptiveAllocationController(
                ControllerConfig(
                    total=self.config.total_shares,
                    n_workers=n_replicas,
                    ema_beta=self.config.ema_beta,
                )
            )
        self.n = n_replicas
        self.shares = np.full(n_replicas, 1.0 / n_replicas)
        self._credits = np.zeros(n_replicas)
        self._last_v: np.ndarray | None = None
        self.shares_history: list[list[float]] = [self.shares.tolist()]

    def route(self) -> int:
        """Pick the replica for the next request (deficit round-robin: exact
        proportional split in the long run, no starvation)."""
        self._credits += self.shares
        i = int(np.argmax(self._credits))
        self._credits[i] -= 1.0
        return i

    def observe(self, tok_per_s: list) -> None:
        """Feed one window's measured per-replica tokens/sec (None for a
        replica idle in the window — its last known speed is reused)."""
        if self._ctl is None:
            return
        v = np.array(
            [
                m if m is not None and m > 0 else (self._last_v[i] if self._last_v is not None else 0.0)
                for i, m in enumerate(tok_per_s)
            ],
            np.float64,
        )
        if np.any(v <= 0):  # no measurement yet for some replica: keep shares
            return
        self._last_v = v
        w = self._ctl.allocation.astype(np.float64)
        alloc = self._ctl.observe(np.maximum(w, 1.0) / v)  # t_i = w_i / v_i
        self.shares = alloc / alloc.sum()
        self.shares_history.append(self.shares.tolist())

    def resize(self, n_replicas: int, carry_tok_per_s: list | None = None) -> None:
        """Membership change (add/remove/replace): re-target the controller,
        warm-starting from measured survivor speeds when provided."""
        if self._ctl is not None:
            alloc = self._ctl.resize(n_replicas, carry_speeds=carry_tok_per_s)
            self.shares = alloc / alloc.sum()
        else:
            self.shares = np.full(n_replicas, 1.0 / n_replicas)
        self.n = n_replicas
        self._credits = np.zeros(n_replicas)
        self._last_v = None
        self.shares_history.append(self.shares.tolist())


# ---------------------------------------------------------------------------
# replicas (virtual-clock serving workers)
# ---------------------------------------------------------------------------


class _ReplicaBase:
    """Slot bookkeeping + virtual clock shared by engine-backed and modeled
    replicas.  ``speed`` scales virtual time: a decode tick costs 1/speed,
    a prefill of L tokens costs prefill_cost_per_token * L / speed."""

    def __init__(self, name: str, speed: float, prefill_cost_per_token: float = 0.05) -> None:
        if speed <= 0:
            raise ValueError("speed must be positive")
        self.name = name
        self.speed = speed
        self.prefill_cost_per_token = prefill_cost_per_token
        self.clock = 0.0
        self.busy = 0.0
        self.tick_scale = 1.0  # fault-injected virtual slowdown (FaultyReplicaClock)
        self.tokens_done = 0
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self._by_rid: dict[int, Request] = {}
        self._win_tokens0 = 0
        self._win_busy0 = 0.0

    # subclass interface ----------------------------------------------------

    def _has_active(self) -> bool:
        raise NotImplementedError

    def _can_admit(self) -> bool:
        raise NotImplementedError

    def _admit(self, req: Request) -> list[tuple]:
        """Returns [(rid, n_tokens)] finished at admission."""
        raise NotImplementedError

    def _tick(self) -> tuple[int, list[tuple]]:
        """Returns (tokens_produced, [(rid, n_tokens) finished])."""
        raise NotImplementedError

    def _abort_active(self) -> None:
        """Discard all in-flight slot state (replica killed mid-request)."""
        raise NotImplementedError

    # driver ----------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if not self._has_active() and not self.queue:
            self.clock = max(self.clock, req.arrival)  # idle replica wakes at arrival
        self.queue.append(req)
        self._by_rid[req.rid] = req

    def _complete(self, rid: int, n_tokens: int) -> None:
        r = self._by_rid.pop(rid)
        r.t_finish = self.clock
        if r.output is None:
            r.output = [0] * n_tokens  # modeled replicas synthesize token counts only
        self.finished.append(r)

    def _step(self) -> None:
        while self.queue and self._can_admit():
            req = self.queue.pop(0)
            req.t_admit = self.clock
            cost = self.prefill_cost_per_token * len(req.prompt) * self.tick_scale / self.speed
            self.clock += cost
            self.busy += cost
            for rid, n in self._admit(req):
                self._complete(rid, n)
        if self._has_active():
            made, fins = self._tick()
            dt = self.tick_scale / self.speed
            self.clock += dt
            self.busy += dt
            self.tokens_done += made
            for rid, n in fins:
                self._complete(rid, n)

    def run_until(self, t: float) -> None:
        while self.clock < t and (self.queue or self._has_active()):
            self._step()

    def drain(self, max_ticks: int = 1_000_000) -> None:
        """Run to completion.  Bounded: a slot that never retires (exactly
        the hang a fault can trigger) raises with the stuck request ids
        instead of spinning the virtual clock forever."""
        for _ in range(max_ticks):
            if not (self.queue or self._has_active()):
                return
            self._step()
        raise RuntimeError(
            f"replica {self.name!r} did not drain within {max_ticks} ticks; stuck request ids: {sorted(self._by_rid)}"
        )

    # fault handling --------------------------------------------------------

    def take_queue(self) -> list[Request]:
        """Remove and return queued-but-not-admitted requests so a
        membership change can redistribute the backlog to survivors."""
        taken, self.queue = self.queue, []
        for r in taken:
            del self._by_rid[r.rid]
        return taken

    def kill(self) -> list[Request]:
        """Hard failure: drop every unfinished request (queued and
        in-flight) and return them reset to pre-admission state.  The
        prompt is the checkpoint — a deterministic re-prefill on another
        replica reproduces the exact tokens a fault-free run would have."""
        orphans = list(self._by_rid.values())
        self._by_rid.clear()
        self.queue.clear()
        self._abort_active()
        for r in orphans:
            r.t_admit = None
            r.t_finish = None
            r.output = None
        return orphans

    # measurement -----------------------------------------------------------

    def harvest_window(self) -> float | None:
        """Measured tokens/sec (virtual) since the last harvest; None if the
        replica did no work in the window."""
        dt_tok = self.tokens_done - self._win_tokens0
        dt_busy = self.busy - self._win_busy0
        self._win_tokens0 = self.tokens_done
        self._win_busy0 = self.busy
        if dt_tok <= 0 or dt_busy <= 0:
            return None
        return dt_tok / dt_busy

    def lifetime_tok_per_s(self) -> float | None:
        return self.tokens_done / self.busy if self.busy > 0 and self.tokens_done > 0 else None


class EngineReplica(_ReplicaBase):
    """A real ``ServeEngine`` behind a virtual clock: tokens are actually
    generated by the model; only the *time* they take is scaled by speed.

    ``_tick`` counts the tokens of ``engine.tick()`` only, so an admission's
    first token (made by prefill) is not in ``tokens_done``, where
    ``ModelReplica._admit`` counts it: the reference's accounting, kept so
    that the summaries agree."""

    def __init__(self, name: str, engine, speed: float = 1.0, prefill_cost_per_token: float = 0.05):
        super().__init__(name, speed, prefill_cost_per_token)
        self.engine = engine

    def _has_active(self) -> bool:
        return self.engine.has_active

    def _can_admit(self) -> bool:
        return bool(self.engine.free_slots)

    def _admit(self, req: Request) -> list[tuple]:
        _, fin = self.engine.admit(req.rid, req.prompt, req.max_gen)
        if fin is not None:
            rid, toks = fin
            self._by_rid[rid].output = list(toks)
            return [(rid, len(toks))]
        return []

    def _tick(self) -> tuple[int, list[tuple]]:
        before = self.engine.tokens_out
        fins = self.engine.tick()
        out = []
        for rid, toks in fins:
            self._by_rid[rid].output = list(toks)
            out.append((rid, len(toks)))
        return self.engine.tokens_out - before, out

    def _abort_active(self) -> None:
        self.engine.reset()


class ModelReplica(_ReplicaBase):
    """Pure speed-model replica (no engine): each active slot yields one
    token per tick.  Used by unit tests and quick router studies where only
    traffic dynamics matter."""

    def __init__(self, name: str, speed: float = 1.0, n_slots: int = 4, prefill_cost_per_token: float = 0.05):
        super().__init__(name, speed, prefill_cost_per_token)
        self.n_slots = n_slots
        self._active: dict[int, tuple[int, int]] = {}  # rid -> (remaining, total)

    def _has_active(self) -> bool:
        return bool(self._active)

    def _can_admit(self) -> bool:
        return len(self._active) < self.n_slots

    def _admit(self, req: Request) -> list[tuple]:
        if req.max_gen <= 1:
            self.tokens_done += 1
            return [(req.rid, 1)]
        self._active[req.rid] = (req.max_gen - 1, req.max_gen)
        self.tokens_done += 1  # prefill emits the first token
        return []

    def _tick(self) -> tuple[int, list[tuple]]:
        made = len(self._active)
        fins = []
        for rid in list(self._active):
            rem, total = self._active[rid]
            rem -= 1
            if rem <= 0:
                del self._active[rid]
                fins.append((rid, total))
            else:
                self._active[rid] = (rem, total)
        return made, fins

    def _abort_active(self) -> None:
        self._active.clear()


# ---------------------------------------------------------------------------
# routed serving run (with elastic membership events)
# ---------------------------------------------------------------------------


def _carried_speeds(replicas: list) -> tuple[list, float]:
    """Measured per-replica speeds with fleet-mean fill for the unmeasured."""
    carried = [r.lifetime_tok_per_s() for r in replicas]
    known = [c for c in carried if c]
    mean_v = sum(known) / len(known) if known else 1.0
    return [c if c else mean_v for c in carried], mean_v


def _apply_event(ev: dict, replicas: list, router: TrafficRouter, make_replica, graveyard: list) -> list[Request]:
    """Membership event at assignment time: {"at": k, "kind": "add"|"remove"|
    "replace", ...}.  A decommissioned replica's *queued* backlog is taken
    first (the caller redistributes it through the router — not dropped),
    its in-flight work drains in place (graceful decommission), and it
    retires into ``graveyard`` so its work stays in the accounting; then
    the controller re-targets with measured survivor speeds — the serving
    mirror of the elastic runtime's fig. 11 scenarios.  Returns the taken
    backlog."""
    kind = ev["kind"]
    orphaned: list[Request] = []
    if kind == "replace":
        i = ev["index"]
        orphaned = replicas[i].take_queue()
        replicas[i].drain()
        carried, mean_v = _carried_speeds(replicas)
        old = replicas[i]
        graveyard.append(old)
        replicas[i] = make_replica(ev.get("name", f"{old.name}+"), ev["speed"])
        replicas[i].clock = old.clock
        carried[i] = mean_v  # newcomer starts at fleet-mean speed estimate
        router.resize(len(replicas), carried)
    elif kind == "add":
        carried, mean_v = _carried_speeds(replicas)
        replicas.append(make_replica(ev.get("name", f"replica{len(replicas)}"), ev["speed"]))
        router.resize(len(replicas), [*carried, mean_v])
    elif kind == "remove":
        i = ev["index"]
        orphaned = replicas[i].take_queue()
        replicas[i].drain()
        graveyard.append(replicas.pop(i))
        carried, _ = _carried_speeds(replicas)
        router.resize(len(replicas), carried)
    else:
        raise ValueError(f"unknown membership event kind {kind!r}")
    return orphaned


def run_router(
    replicas: list,
    requests: list[Request],
    config: RouterConfig | None = None,
    events: list[dict] | None = None,
    make_replica=None,
    obs=None,
    faults=None,
    hedge_timeout: float | None = None,
) -> dict:
    """Route ``requests`` across ``replicas`` and drain.

    ``events``: membership changes keyed on assignment index (see
    ``_apply_event``); requires ``make_replica(name, speed)`` for add/replace.
    ``faults``: a fault schedule (grammar string or ``FaultEvent``
    list) whose *steps are assignment indices* — ``slow``/``netdeg`` scale
    replica tick cost via ``FaultyReplicaClock``; ``fail``/``outage`` kill
    live replicas mid-flight (orphans re-dispatched; an outage with a
    duration rejoins its members ``duration`` assignments later, which
    needs ``make_replica``); ``add``/``replace`` join/crash-swap with the
    GPU throughput table supplying the speed.
    ``hedge_timeout``: virtual seconds after which an unfinished dispatch
    is hedged onto a second replica — first completion wins, the duplicate
    is suppressed by request id.
    ``obs`` (a :class:`repro_torch.obs.RouterObs`) gets the share trajectory,
    fault/retry/hedge instants, and a post-run per-request span/histogram
    pass over the fleet.  Returns summary metrics incl. the share
    trajectory and the fault counters."""
    config = config or RouterConfig()
    router = TrafficRouter(len(replicas), config)
    events = sorted(events or [], key=lambda e: e["at"])
    if isinstance(faults, str):
        faults = parse_faults(faults)
    faults = sorted(faults or [], key=lambda f: f.step)
    ev_i = 0
    fault_i = 0
    graveyard: list = []
    originals = {r.rid: r for r in requests}
    counters = {"retries": 0, "redistributed": 0, "hedges": 0, "hedges_won": 0, "hedges_lost": 0, "replica_deaths": 0}
    step_box = [0]  # current fault step = assignment index
    injector = FaultInjector(len(replicas))
    fclock = FaultyReplicaClock(injector, lambda: step_box[0])
    rejoins: list[dict] = []  # {"at": step, "members": [(name, speed), ...]}
    dispatch: dict[int, float] = {}  # rid -> virtual time of latest dispatch
    hedged: dict[int, Request] = {}  # rid -> its hedge clone

    def redistribute(orphans: list[Request], retry: bool) -> None:
        for r in sorted(orphans, key=lambda q: q.rid):
            if any(r.rid in rep._by_rid for rep in replicas):
                # another copy of this rid (its hedge clone, or the original
                # when the clone's replica died) is still in flight on a
                # survivor.  Re-dispatching would co-locate two copies of one
                # rid on one replica — submit/_by_rid are keyed by rid, so
                # the second completion would be lost or double-delivered.
                # Drop the orphan: the surviving copy delivers, and first-
                # completion-wins reconciliation puts its result on the
                # caller's Request.
                continue
            counters["retries" if retry else "redistributed"] += 1
            tgt = replicas[router.route()]
            tgt.submit(r)
            dispatch[r.rid] = tgt.clock
            if obs is not None:
                obs.on_retry(r.rid, tgt.name, step_box[0], retry=retry)

    def kill_members(victims: list[int], ev, rejoin: bool) -> None:
        if max(victims) >= len(replicas):
            raise ValueError(f"fault {ev.spec()!r}: replica index out of range for fleet of {len(replicas)}")
        if len(replicas) - len(victims) < 1:
            raise ValueError(f"fault {ev.spec()!r} would kill the entire fleet")
        members = [(replicas[i].name, replicas[i].speed) for i in victims]
        orphans: list[Request] = []
        for i in sorted(victims, reverse=True):
            rep = replicas.pop(i)
            orphans.extend(rep.kill())
            graveyard.append(rep)
            counters["replica_deaths"] += 1
            if obs is not None:
                obs.on_death(rep.name, step_box[0])
        n_before = len(replicas) + len(victims)
        injector.rescale([i for i in range(n_before) if i not in victims], 0)
        carried, _ = _carried_speeds(replicas)
        router.resize(len(replicas), carried)
        if rejoin and ev.duration is not None:
            # clamp to the schedule end: the step counter tops out at
            # len(requests) before the drain tail, so an outage outliving
            # the request schedule must still heal there — unclamped it
            # would never rejoin and the fleet would stay silently shrunk
            rejoins.append({"at": min(ev.step + ev.duration, len(requests)), "members": members})
        redistribute(orphans, retry=True)

    def join_member(name: str, speed: float, clock: float = 0.0) -> None:
        rep = make_replica(name, speed)
        rep.clock = clock
        replicas.append(rep)
        injector.rescale(list(range(len(replicas) - 1)), 1)
        carried, _ = _carried_speeds(replicas)
        router.resize(len(replicas), carried)

    def apply_fault(ev) -> None:
        if ev.kind in ("slow", "netdeg"):
            injector.apply(ev)
        elif ev.kind == "fail":
            kill_members([ev.index], ev, rejoin=False)
        elif ev.kind == "outage":
            kill_members(sorted(ev.workers), ev, rejoin=True)
        elif ev.kind == "add":
            join_member(f"replica{len(replicas)}+", GPU_RELATIVE_THROUGHPUT[normalize_gpu(ev.gpu)])
        elif ev.kind == "replace":  # crash-swap: kill the slot, join the newcomer
            kill_members([ev.index], ev, rejoin=False)
            join_member(f"replica{len(replicas)}+", GPU_RELATIVE_THROUGHPUT[normalize_gpu(ev.gpu)])

    def process_rejoins() -> None:
        due = [rj for rj in rejoins if rj["at"] <= step_box[0]]
        if not due:
            return
        rejoins[:] = [rj for rj in rejoins if rj["at"] > step_box[0]]
        frontier = max((r.clock for r in replicas), default=0.0)
        for rj in due:
            for name, speed in rj["members"]:
                join_member(f"{name}'", speed, clock=frontier)

    def maybe_hedge(now: float) -> None:
        if hedge_timeout is None or len(replicas) < 2:
            return
        for rid, t0 in list(dispatch.items()):
            orig = originals[rid]
            if rid in hedged or orig.t_finish is not None or now - t0 <= hedge_timeout:
                continue
            src = next((rep for rep in replicas if rid in rep._by_rid), None)
            if src is None:
                continue
            # the clone must land on a replica NOT already holding this rid
            # (co-locating two copies of one rid on a replica corrupts its
            # rid-keyed slot bookkeeping) — round-robin past any holder
            j = router.route()
            for _ in range(len(replicas)):
                if rid not in replicas[j]._by_rid:
                    break
                j = (j + 1) % len(replicas)
            else:
                continue  # every replica holds a copy: nothing to hedge onto
            clone = Request(rid=rid, prompt=orig.prompt, max_gen=orig.max_gen, arrival=now)
            hedged[rid] = clone
            counters["hedges"] += 1
            replicas[j].submit(clone)
            dispatch[rid] = replicas[j].clock
            if obs is not None:
                obs.on_hedge(rid, replicas[j].name, step_box[0])

    for k, req in enumerate(sorted(requests, key=lambda r: r.arrival)):
        step_box[0] = k
        while ev_i < len(events) and events[ev_i]["at"] <= k:
            redistribute(_apply_event(events[ev_i], replicas, router, make_replica, graveyard), retry=False)
            ev_i += 1
        while fault_i < len(faults) and faults[fault_i].step <= k:
            apply_fault(faults[fault_i])
            fault_i += 1
        process_rejoins()
        if faults:
            fclock.apply(replicas)
        for r in replicas:
            r.run_until(req.arrival)
        maybe_hedge(req.arrival)
        tgt = replicas[router.route()]
        tgt.submit(req)
        dispatch[req.rid] = tgt.clock
        if (k + 1) % config.window == 0:
            router.observe([r.harvest_window() for r in replicas])
            if obs is not None:
                obs.on_shares(len(router.shares_history) - 1, router.shares)
    step_box[0] = len(requests)
    while ev_i < len(events):  # events past the last assignment
        redistribute(_apply_event(events[ev_i], replicas, router, make_replica, graveyard), retry=False)
        ev_i += 1
    while fault_i < len(faults):
        apply_fault(faults[fault_i])
        fault_i += 1
    process_rejoins()
    if faults:
        fclock.apply(replicas)
    if hedge_timeout is None:
        for r in replicas:
            r.drain()
    else:
        # staged drain: advance the whole fleet in lockstep time quanta so
        # stalled requests can still be hedged onto faster survivors
        horizon = max((r.clock for r in replicas), default=0.0)
        quantum = max(hedge_timeout / 4.0, 1e-6)
        for _ in range(1_000_000):
            if not any(r.queue or r._has_active() for r in replicas):
                break
            horizon += quantum
            for r in replicas:
                r.run_until(horizon)
            maybe_hedge(horizon)
        else:
            stuck = sorted(rid for rep in replicas for rid in rep._by_rid)
            raise RuntimeError(f"staged drain did not converge; stuck request ids: {stuck}")

    fleet = [*replicas, *graveyard]
    # first-completion-wins reconciliation: a hedged rid may have finished on
    # two replicas — the earlier virtual completion is delivered (its result
    # copied onto the caller's Request), the duplicate suppressed by rid.
    for rid, clone in hedged.items():
        orig = originals[rid]
        cands = [r for r in (orig, clone) if r.t_finish is not None]
        if not cands:
            continue
        win = min(cands, key=lambda r: r.t_finish)
        if win is clone:
            counters["hedges_won"] += 1
            orig.output = list(clone.output or [])
            orig.t_admit = clone.t_admit
            orig.t_finish = clone.t_finish
        else:
            counters["hedges_lost"] += 1
    if obs is not None:
        obs.on_done(fleet)
    delivered: dict[int, Request] = {}
    completions: dict[int, int] = {}
    for rep in fleet:
        for r in rep.finished:
            completions[r.rid] = completions.get(r.rid, 0) + 1
            if r.rid not in delivered:
                delivered[r.rid] = originals.get(r.rid, r)
    done = list(delivered.values())
    suppressed = sum(c - 1 for c in completions.values())
    # exactly-once audit: a hedged rid may legitimately complete twice (the
    # loser was suppressed above); any completion beyond that — or a repeat
    # of a never-hedged rid — is a delivery-protocol violation, counted here
    # so the CI duplicates==0 gate can actually catch a regression
    duplicates = sum(max(0, c - (2 if rid in hedged else 1)) for rid, c in completions.items())
    lat = np.array([r.latency for r in done], np.float64)
    total_tokens = sum(rep.tokens_done for rep in fleet)
    makespan = max((rep.clock for rep in fleet), default=0.0)
    return {
        "policy": config.policy,
        "replicas": [
            {
                "name": rep.name,
                "speed": rep.speed,
                "tokens": rep.tokens_done,
                "busy": round(rep.busy, 3),
                "tok_per_s": round(rep.lifetime_tok_per_s() or 0.0, 3),
                "completed": len(rep.finished),
                "retired": rep in graveyard,
            }
            for rep in fleet
        ],
        "completed": len(done),
        "duplicates": duplicates,
        "suppressed": suppressed,
        **counters,
        "total_tokens": total_tokens,
        "makespan": round(makespan, 3),
        "throughput_tok_per_s": round(total_tokens / makespan, 3) if makespan > 0 else None,
        "latency_p50": float(np.percentile(lat, 50)) if lat.size else None,
        "latency_p95": float(np.percentile(lat, 95)) if lat.size else None,
        "final_shares": router.shares.tolist(),
        "shares_history": router.shares_history,
    }
