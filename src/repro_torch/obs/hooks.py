"""Instrumentation hook bundles for the training driver and the serve stack.

Hot paths never talk to the tracer/registry directly: they call typed hook
methods on a :class:`TrainObs` / :class:`ServeObs` / :class:`RouterObs`
bundle.  A bundle constructed with no outputs has ``enabled=False`` and
every hook returns after one attribute check — observability off means the
instrumented code paths do no measurable extra work and produce
bit-identical results.

Timestamps are virtual: the trainer's clock advances by modeled (simulated
or measured-and-attributed) epoch durations, the serve clock by decode
ticks (or the bench's analytic tick-cost model).  Under seeded simulated
timing both the Perfetto trace and the metrics snapshot are deterministic
byte-for-byte.
"""

from __future__ import annotations

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER, Tracer, VirtualClock

__all__ = ["TrainObs", "ServeObs", "RouterObs", "NULL_SERVE_OBS"]


class _ObsBase:
    """Shared construction/export: file paths or prebuilt sinks."""

    def __init__(
        self,
        trace_out: str | None = None,
        metrics_out: str | None = None,
        tracer: Tracer | None = None,
        metrics: MetricsRegistry | None = None,
    ) -> None:
        self.trace_out = trace_out
        self.metrics_out = metrics_out
        if tracer is None and trace_out:
            # virtual clock: event times come from the caller, never the host
            tracer = Tracer(clock=VirtualClock())
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else (MetricsRegistry() if metrics_out else None)
        self.enabled = bool(self.tracer.enabled or self.metrics is not None)

    def close(self) -> None:
        """Export whatever file outputs were requested."""
        if self.trace_out and self.tracer.enabled:
            self.tracer.export(self.trace_out)
        if self.metrics_out and self.metrics is not None:
            self.metrics.export(self.metrics_out)


class TrainObs(_ObsBase):
    """ElasticTrainer hooks: per-worker compute/wait/collective spans per
    aggregation, allocation-share counters, membership/checkpoint instants,
    fault windows as spans, straggler flags, collective bytes."""

    def __init__(self, trace_out=None, metrics_out=None, tracer=None, metrics=None) -> None:
        super().__init__(trace_out, metrics_out, tracer, metrics)
        self._vt = 0.0  # virtual seconds: sum of modeled aggregation makespans
        self._step_t: dict[int, float] = {}  # global step -> vt at step start
        self._windows: list[tuple[str, int, int | None, dict]] = []  # open fault windows

    def on_epoch(self, epoch, step_end, steps_run, t_s, t_c, alloc, gpus, per_agg, coll_bytes) -> None:
        """One finished epoch measurement.  ``t_s``: per-worker seconds — per
        aggregation when ``per_agg`` (simulated), whole-epoch accumulated
        otherwise (measured; split evenly over ``steps_run``)."""
        if not self.enabled or steps_run <= 0:
            return
        n = len(t_s)
        t_agg = [float(t) if per_agg else float(t) / steps_run for t in t_s]
        T = max(t_agg)
        m = self.metrics
        if m is not None:
            m.counter("train.steps").inc(steps_run)
            m.counter("train.epochs").inc()
            m.counter("train.collective_bytes").inc(steps_run * coll_bytes)
            agg_h = m.histogram("train.agg_makespan_s")
            comp_h = m.histogram("train.worker_compute_s")
            wait_h = m.histogram("train.worker_wait_s")
            for _ in range(steps_run):
                agg_h.record(T + t_c)
            for i in range(n):
                for _ in range(steps_run):
                    comp_h.record(t_agg[i])
                    wait_h.record(T - t_agg[i])
        tr = self.tracer
        if not tr.enabled:
            self._vt += steps_run * (T + t_c)
            return
        tr.counter("train/allocation", "allocation", self._vt, {f"w{i}": int(alloc[i]) for i in range(n)})
        step0 = step_end - steps_run
        for k in range(steps_run):
            t0 = self._vt
            self._step_t[step0 + k] = t0
            for i in range(n):
                track = f"train/worker {i}"
                args = {"alloc": int(alloc[i]), "gpu": gpus[i], "epoch": int(epoch)}
                tr.span(track, "compute", t0, t_agg[i], args)
                wait = T - t_agg[i]
                if wait > 0.0:
                    tr.span(track, "wait", t0 + t_agg[i], wait)
                if t_c > 0.0:
                    tr.span(track, "collective", t0 + T, t_c, {"bytes": coll_bytes})
            self._vt = t0 + T + t_c

    def on_flags(self, epoch, step_end, flags) -> None:
        if not self.enabled:
            return
        if self.metrics is not None:
            self.metrics.counter("train.straggler_flags").inc(len(flags))
        for f in flags:
            self.tracer.instant(
                f"train/worker {f.worker}",
                "straggler",
                self._vt,
                {"z": round(f.z_score, 2), "persistent": f.persistent, "epoch": int(epoch), "step": int(step_end)},
            )

    def on_membership(self, step, spec, gpus, alloc) -> None:
        if not self.enabled:
            return
        if self.metrics is not None:
            self.metrics.counter("train.membership_events").inc()
        self.tracer.instant(
            "train/events",
            f"rescale {spec}",
            self._vt,
            {"step": int(step), "gpus": list(gpus), "alloc": [int(a) for a in alloc]},
        )

    def on_fault(self, step, spec, duration) -> None:
        """A degradation window opens at ``step`` for ``duration`` steps (None
        = unbounded).  Recorded now, emitted as a span at :meth:`close` once
        the step -> virtual-time mapping is complete."""
        if not self.enabled:
            return
        if self.metrics is not None:
            self.metrics.counter("train.fault_windows").inc()
        self.tracer.instant("train/events", f"fault {spec}", self._vt, {"step": int(step)})
        end = None if duration is None else int(step) + int(duration)
        self._windows.append((spec, int(step), end, {"step": int(step), "duration": duration}))

    def on_checkpoint(self, step) -> None:
        if not self.enabled:
            return
        if self.metrics is not None:
            self.metrics.counter("train.checkpoints").inc()
        self.tracer.instant("train/events", "checkpoint", self._vt, {"step": int(step)})

    def _t_of_step(self, step: int) -> float:
        """Virtual time of a global step: exact when the step was measured,
        else the nearest measured step after it (clamped to the end)."""
        t = self._step_t.get(step)
        if t is not None:
            return t
        later = [s for s in self._step_t if s > step]
        if later:
            return self._step_t[min(later)]
        return self._vt

    def close(self) -> None:
        if self.tracer.enabled:
            for spec, s0, s1, args in self._windows:
                t0 = self._t_of_step(s0)
                t1 = self._vt if s1 is None else self._t_of_step(s1)
                self.tracer.span("train/events", f"fault window {spec}", t0, max(t1 - t0, 0.0), args)
            self._windows = []
        super().close()


class ServeObs(_ObsBase):
    """ServeEngine/Scheduler hooks: per-slot request spans, TTFT and
    per-token latency histograms, queue-depth / slot-occupancy / page-pool
    counters, prefill-cap and pool-backpressure defers."""

    def __init__(self, trace_out=None, metrics_out=None, tracer=None, metrics=None) -> None:
        super().__init__(trace_out, metrics_out, tracer, metrics)
        self._slot_of: dict[int, int] = {}  # rid -> slot while in flight

    def on_admit(self, req, slot, now) -> None:
        if not self.enabled:
            return
        self._slot_of[req.rid] = slot
        if self.metrics is not None:
            self.metrics.counter("serve.prefills").inc()
            self.metrics.counter("serve.prefill_tokens").inc(int(req.prompt.shape[0]))
        self.tracer.instant(
            f"serve/slot {slot}",
            f"admit rid={req.rid}",
            now,
            {"prompt_len": int(req.prompt.shape[0]), "max_gen": int(req.max_gen), "wait": now - req.arrival},
        )

    def on_defer(self, kind, now) -> None:
        """Admission deferred this tick: ``kind`` is "pool" (page-pool
        backpressure) or "prefill_cap" (per-tick prefill budget)."""
        if not self.enabled:
            return
        if self.metrics is not None:
            self.metrics.counter(f"serve.defers.{kind}").inc()
        self.tracer.instant("serve/scheduler", f"defer ({kind})", now)

    def on_tick(self, now, dt, engine, queue_depth) -> None:
        if not self.enabled:
            return
        active = int(getattr(engine, "last_tick_active", 0))
        m = self.metrics
        if m is not None:
            m.counter("serve.ticks").inc()
            m.histogram("serve.queue_depth", min_value=1.0).record(queue_depth)
            m.histogram("serve.active_slots", min_value=1.0).record(active)
            m.histogram("serve.tick_cost").record(dt)
        tr = self.tracer
        if tr.enabled:
            tr.counter("serve/scheduler", "queue_depth", now, {"queued": int(queue_depth)})
            tr.counter("serve/scheduler", "active_slots", now, {"active": active, "slots": engine.n_slots})
        if engine.pool is not None:
            pm = engine.pool.metrics()
            util = 1.0 - pm["free_pages"] / pm["n_pages"]
            if m is not None:
                m.gauge("serve.pool_utilization").set(round(util, 6))
            if tr.enabled:
                tr.counter(
                    "serve/pool",
                    "pages",
                    now,
                    {"free": pm["free_pages"], "reserved": pm["reserved_pages"], "allocated": pm["allocated_pages"]},
                )

    def on_preempt(self, rid, slot, now) -> None:
        """Slot evicted back to the page pool (pages are the checkpoint)."""
        if not self.enabled:
            return
        self._slot_of.pop(rid, None)
        if self.metrics is not None:
            self.metrics.counter("serve.preemptions").inc()
        self.tracer.instant(f"serve/slot {slot}", f"preempt rid={rid}", now)

    def on_restore(self, rid, slot, now) -> None:
        """Preempted request re-seated (its K/V rows copied back into pages)."""
        if not self.enabled:
            return
        self._slot_of[rid] = slot
        if self.metrics is not None:
            self.metrics.counter("serve.restores").inc()
        self.tracer.instant(f"serve/slot {slot}", f"restore rid={rid}", now)

    def on_finish(self, req, now) -> None:
        if not self.enabled:
            return
        slot = self._slot_of.pop(req.rid, None)
        n_tok = len(req.output or [])
        ttft = (req.t_admit - req.arrival) if req.t_admit is not None else None
        m = self.metrics
        if m is not None:
            m.counter("serve.completed").inc()
            m.counter("serve.tokens_out").inc(n_tok)
            if ttft is not None:
                m.histogram("serve.ttft").record(ttft)
            if req.t_admit is not None and n_tok > 1:
                m.histogram("serve.per_token").record((now - req.t_admit) / (n_tok - 1))
            m.histogram("serve.e2e_latency").record(now - req.arrival)
        if self.tracer.enabled and slot is not None and req.t_admit is not None:
            self.tracer.span(
                f"serve/slot {slot}",
                f"req {req.rid}",
                req.t_admit,
                now - req.t_admit,
                {"tokens": n_tok, "ttft": ttft},
            )


class RouterObs(_ObsBase):
    """TrafficRouter hooks: per-replica request spans on virtual clocks,
    share-trajectory counters, fleet-level latency histograms."""

    def on_shares(self, window_idx, shares) -> None:
        if not self.enabled:
            return
        self.tracer.counter(
            "router/controller",
            "shares",
            float(window_idx),
            {f"r{i}": round(float(s), 6) for i, s in enumerate(shares)},
        )

    def on_death(self, name, step) -> None:
        """A replica was killed mid-flight (fail/outage fault)."""
        if not self.enabled:
            return
        if self.metrics is not None:
            self.metrics.counter("router.replica_deaths").inc()
        self.tracer.instant("router/events", f"replica {name} died", float(step))

    def on_retry(self, rid, to_name, step, retry=True) -> None:
        """An orphaned request re-dispatched (``retry=True``: its replica
        died mid-flight; ``False``: graceful-decommission backlog move)."""
        if not self.enabled:
            return
        if self.metrics is not None:
            self.metrics.counter("router.retries" if retry else "router.redistributed").inc()
        self.tracer.instant("router/events", f"{'retry' if retry else 'redistribute'} rid={rid} -> {to_name}", float(step))

    def on_hedge(self, rid, to_name, step) -> None:
        """A stalled request hedged onto a second replica."""
        if not self.enabled:
            return
        if self.metrics is not None:
            self.metrics.counter("router.hedges").inc()
        self.tracer.instant("router/events", f"hedge rid={rid} -> {to_name}", float(step))

    def on_done(self, fleet) -> None:
        """Post-run pass over the fleet (live replicas + graveyard): emit one
        span per completed request on its replica's track and fill the
        latency histograms from the virtual-clock stamps."""
        if not self.enabled:
            return
        m = self.metrics
        for rep in fleet:
            for r in rep.finished:
                n_tok = len(r.output or [])
                if m is not None:
                    if r.wait is not None:
                        m.histogram("router.ttft").record(r.wait)
                    if r.t_admit is not None and r.t_finish is not None and n_tok > 1:
                        m.histogram("router.per_token").record((r.t_finish - r.t_admit) / (n_tok - 1))
                    if r.latency is not None:
                        m.histogram("router.e2e_latency").record(r.latency)
                if self.tracer.enabled and r.t_admit is not None and r.t_finish is not None:
                    self.tracer.span(
                        f"router/{rep.name}",
                        f"req {r.rid}",
                        r.t_admit,
                        r.t_finish - r.t_admit,
                        {"tokens": n_tok},
                    )
            if m is not None and rep.busy > 0:
                m.gauge(f"router.replica.{rep.name}.tok_per_s").set(round(rep.lifetime_tok_per_s() or 0.0, 6))


NULL_SERVE_OBS = ServeObs()
