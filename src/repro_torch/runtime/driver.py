"""ElasticTrainer — the elastic self-adaptive training loop (paper fig. 11).

The port of ``repro.runtime.driver``: the controller / sampler /
heterogeneous-step loop behind ``python -m repro_torch.launch.train``.

* **Measurement-driven adaptation.** The controller consumes a
  ``TimingSource``: by default ``MeasuredTimingSource``, per-step wall clocks
  (each step ends on a host read of its loss, so the clock covers the device
  work) attributed to ranks by the microbatches each computed; with
  ``hetero_gpus``, ``SimulatedTimingSource`` and the GPU speed table, so one
  card exercises the heterogeneous trajectories.  A ``StragglerMonitor``
  rides along on the same measurements.
* **Membership changes.** A scripted event stream (``events="fail@8:3,
  add@16:v100,replace@24:0=v100"``, ``runtime.elastic.parse_events``) drives
  the rescale path: ``RescalePlan`` with survivor speeds carried -> rebuild
  step + batcher for the new worker count -> continue at the same global
  step.  ``fail`` events go through the ``FailureDetector`` (missed
  heartbeats), as in the reference.

One process holds every rank (the reference's single-device (1, 1) mesh),
so there is no state to reshard on a rebuild.  Checkpoint and exact resume
(``ckpt_dir``/``resume``), fault injection (``faults``) and the observability
outputs (``trace_out``/``metrics_out``) wait for later slices: setting one
raises ``NotImplementedError``.

Epoch semantics: one "epoch" is one pass over the dataset —
``steps_per_epoch`` aggregations by default (``dataset_size`` overrides).
The controller reallocates at epoch boundaries only (paper Alg. 1); a
membership change mid-epoch ends the epoch early.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import (
    AdaptiveAllocationController,
    ClusterSpec,
    ControllerConfig,
    equal_allocation,
    static_allocation,
)
from repro_torch.core.hetero import normalize_gpu
from repro_torch.data import HeteroBatcher, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.dist import HeteroStepConfig, build_train_step, init_train_state
from repro_torch.optim import warmup_cosine
from repro_torch.runtime.elastic import (
    ElasticCoordinator,
    FailureDetector,
    MembershipEvent,
    parse_events,
    validate_schedule,
)
from repro_torch.runtime.monitor import MeasuredTimingSource, SimulatedTimingSource, StragglerMonitor

__all__ = ["DriverConfig", "ElasticTrainer"]

# Simulated collective seconds per aggregation (eq. 2's t_c; matches the
# reference's benchmark harness).  Measured mode folds collective time into
# the wall clock and reports t_c=0.
_T_C_SIM = 0.1

# options of the reference's driver that a later slice of the port brings
_LATER = {
    "ckpt_dir": "checkpoint and exact resume",
    "resume": "checkpoint and exact resume",
    "faults": "fault injection",
    "trace_out": "the observability outputs",
    "metrics_out": "the observability outputs",
}


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    """Everything the CLI can say, as data (the reference's fields plus ``device``)."""

    arch: str
    smoke: bool = False
    steps: int = 40
    seq: int = 64
    n_workers: int = 4
    micro_bs: int = 4
    total_micro: int = 16  # C: microbatches per aggregation, constant (eq. 4)
    w_max: int = 0  # 0 -> auto (2C/n, grown on demand)
    policy: str = "adaptive"  # "adaptive" | "equal" | "static"
    static_ratio: str | None = None
    mode: str = "masked"  # "masked" | "while"
    hetero_gpus: str | None = None  # comma GPU names -> simulated timing
    steps_per_epoch: int = 4  # aggregations per dataset pass (epoch)
    dataset_size: int = 0  # 0 -> total_micro * micro_bs * steps_per_epoch
    lr: float = 3e-4
    ckpt_dir: str | None = None
    resume: bool = False
    seed: int = 0
    events: str | None = None  # scripted membership schedule
    faults: str | None = None
    heartbeat_patience: int = 3
    log_every: int = 10
    verbose: bool = True
    trace_out: str | None = None
    metrics_out: str | None = None
    device: str = "cuda"


class ElasticTrainer:
    """One training job: fixed C, elastic membership.  Construct, then :meth:`run`.

    ``state``: a train state to start from (``dist.init_train_state``'s
    layout, e.g. ``models.convert.train_state_from_jax`` of the reference's)
    instead of the seeded one; it is trained in place."""

    def __init__(self, cfg: DriverConfig, state: dict | None = None) -> None:
        if cfg.policy not in ("adaptive", "equal", "static"):
            raise ValueError(f"policy must be adaptive/equal/static, got {cfg.policy!r}")
        if cfg.policy == "static" and not cfg.static_ratio:
            raise ValueError("policy='static' requires static_ratio (e.g. '6,4')")
        if cfg.heartbeat_patience < 1:
            raise ValueError(
                "heartbeat_patience must be >= 1 — with zero patience the failure "
                "detector never declares anyone dead and fail events become silent no-ops"
            )
        for name, what in _LATER.items():
            if getattr(cfg, name):
                raise NotImplementedError(f"{name}: {what} waits for a later slice of the port")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model_cfg = smoke_config(cfg.arch, seq=cfg.seq) if cfg.smoke else get_config(cfg.arch)
        self.C = cfg.total_micro
        self.seq_len = cfg.seq if cfg.smoke else self.model_cfg.max_seq
        self.simulated = cfg.hetero_gpus is not None

        self.events: list = validate_schedule(parse_events(cfg.events) if cfg.events else [])
        self._event_idx = 0

        # -- initial membership ------------------------------------------------
        gpus = (cfg.hetero_gpus or ",".join(["rtx2080ti"] * cfg.n_workers)).split(",")
        self.gpus = [normalize_gpu(g) for g in gpus]
        if cfg.hetero_gpus is not None and len(self.gpus) != cfg.n_workers:
            raise ValueError(
                f"hetero_gpus lists {len(self.gpus)} workers but n_workers={cfg.n_workers}; "
                "make them agree — the GPU list defines the fleet, so a silent mismatch "
                "would train the wrong worker count"
            )
        self.ctl = AdaptiveAllocationController(ControllerConfig(total=self.C, n_workers=len(self.gpus), w_min=1))
        if cfg.policy == "static":
            ratios = [float(x) for x in (cfg.static_ratio or "").split(",")]
            self.alloc = static_allocation(ratios, self.C)
        else:
            self.alloc = self.ctl.allocation

        # -- data: one dataset object outlives every membership ---------------
        size = cfg.dataset_size or self.C * cfg.micro_bs * max(cfg.steps_per_epoch, 1)
        if size % cfg.micro_bs or size < self.C * cfg.micro_bs:
            raise ValueError(
                f"dataset_size={size} must be a multiple of micro_bs={cfg.micro_bs} "
                f"and hold at least one aggregation ({self.C * cfg.micro_bs} samples)"
            )
        self.dataset = SyntheticLM(
            vocab_size=self.model_cfg.vocab_size, seq_len=self.seq_len, n_sequences=size, seed=cfg.seed
        )

        # -- position + bookkeeping -------------------------------------------
        self.step_i = 0
        self.epoch = 0
        self.agg_index = 0
        self.losses: list[float] = []
        self.step_log: list[dict] = []  # per step: loss, allocation, wall seconds, tokens
        self.epoch_log: list[dict] = []
        self.membership_log: list[dict] = []
        self.straggler_flags = 0
        self.straggler_log: list[dict] = []
        self.fd = FailureDetector(len(self.gpus), patience=cfg.heartbeat_patience)
        like_scfg = HeteroStepConfig(w_max=1, micro_bs=cfg.micro_bs, seq_len=self.seq_len, optimizer="adamw")
        self.state = state or init_train_state(self.model_cfg, like_scfg, cfg.seed, device=self.device)
        self._build()

    # -- membership-dependent construction ------------------------------------

    def _build(self) -> None:
        """(Re)build what depends on the membership: step config/function,
        batcher, timing source, monitor."""
        cfg = self.cfg
        n = len(self.gpus)
        auto = max(2 * self.C // n, self.C // n + 1)
        self.w_max = max(cfg.w_max or auto, int(np.max(self.alloc)))
        self.scfg = HeteroStepConfig(
            w_max=self.w_max,
            micro_bs=cfg.micro_bs,
            seq_len=self.seq_len,
            mode=cfg.mode,
            alloc_axis="data",
            optimizer="adamw",
        )
        self.step_fn = build_train_step(self.model_cfg, self.scfg, lr_fn=warmup_cosine(cfg.lr, 10, cfg.steps))
        self.batcher = HeteroBatcher(self.dataset, n, cfg.micro_bs, self.w_max, seed=cfg.seed)
        self._rebuild_monitoring()

    def _rebuild_monitoring(self) -> None:
        """(Re)create the timing source + straggler monitor for the current fleet."""
        n = len(self.gpus)
        if self.simulated:
            self.timing = SimulatedTimingSource(ClusterSpec.from_gpus(self.gpus, seed=self.cfg.seed))
        else:
            self.timing = MeasuredTimingSource(n)
        self.straggler = StragglerMonitor(n)

    # -- membership events -------------------------------------------------------

    def _event_due(self) -> bool:
        return self._event_idx < len(self.events) and self.events[self._event_idx].step <= self.step_i

    def _apply_due_events(self) -> bool:
        applied = False
        while self._event_due():
            self._apply_event(self.events[self._event_idx])
            self._event_idx += 1
            applied = True
        return applied

    def _est_speed(self, gpu: str) -> float | None:
        """Joiner speed estimate in the units of the controller's log: the
        speed table under simulated timing, the fleet mean otherwise."""
        if self.simulated:
            return ClusterSpec.from_gpus([gpu]).workers[0].throughput
        return None

    def _apply_event(self, ev: MembershipEvent) -> None:
        n = len(self.gpus)
        if ev.kind in ("fail", "replace") and not (0 <= ev.index < n):
            raise ValueError(f"event {ev}: worker index out of range for membership size {n}")
        if ev.kind == "fail" and n == 1:
            raise ValueError(f"event {ev}: cannot fail the last remaining worker — the fleet would be empty")

        coord = ElasticCoordinator(self.ctl)
        if ev.kind == "fail":
            # through the detector: the worker stops heartbeating and is
            # declared dead after `patience` missed intervals
            dead: list[int] = []
            for _ in range(self.fd.patience):
                for w in range(self.fd.n_workers):
                    if w != ev.index and self.fd.alive[w]:
                        self.fd.heartbeat(w)
                dead = self.fd.tick() or dead
            plan = coord.remove(dead, restore_step=self.step_i)
            new_gpus = [self.gpus[i] for i in plan.survivors]
        elif ev.kind == "add":
            plan = coord.add(1, est_speed=self._est_speed(ev.gpu))
            new_gpus = self.gpus + [ev.gpu]
        else:  # replace
            plan = coord.replace(ev.index, est_speed=self._est_speed(ev.gpu))
            new_gpus = list(self.gpus)
            new_gpus[ev.index] = ev.gpu

        self.fd.rescale(plan.survivors, plan.n_new)
        if ev.kind == "replace":
            self.fd.heartbeat(ev.index)  # fresh card in that slot: clean miss count
        self.gpus = new_gpus
        if self.cfg.policy == "equal":
            self.alloc = equal_allocation(len(new_gpus), self.C)
        else:
            self.alloc = np.asarray(plan.allocation, dtype=np.int64)
        if self.agg_index:
            # mid-epoch: the remaining partition belongs to the old membership
            self.epoch += 1
            self.agg_index = 0
        self.membership_log.append(
            {
                "step": self.step_i,
                "event": f"{ev.kind}@{ev.step}",
                "detail": {"index": ev.index, "gpu": ev.gpu},
                "gpus": list(self.gpus),
                "allocation": self.alloc.tolist(),
            }
        )
        self._log(f"[elastic] step {self.step_i}: {ev.kind} -> fleet {self.gpus}, allocation {self.alloc.tolist()}")
        if len(self.gpus) == n and int(np.max(self.alloc)) <= self.w_max:
            # same worker count and the allocation fits the buffers: the step
            # and batcher stay valid, only the speed model follows the fleet
            self._rebuild_monitoring()
        else:
            self._build()

    # -- the loop -----------------------------------------------------------------

    def run(self) -> dict:
        cfg = self.cfg
        t_wall = time.time()
        while self.step_i < cfg.steps:
            if self._apply_due_events():
                continue
            self._run_epoch()
        return {
            "arch": self.model_cfg.name,
            "steps": self.step_i,
            "epoch": self.epoch,
            "agg_index": self.agg_index,
            "first_loss": self.losses[0] if self.losses else None,
            "last_loss": self.losses[-1] if self.losses else None,
            "loss_drop": (self.losses[0] - self.losses[-1]) if self.losses else None,
            "final_allocation": np.asarray(self.alloc).tolist(),
            "n_workers": len(self.gpus),
            "gpus": list(self.gpus),
            "controller_frozen": self.ctl.frozen,
            "timing": "simulated" if self.simulated else "measured",
            "epoch_log": self.epoch_log,
            "epoch_summary": self._epoch_summary(),
            "memberships": self.membership_log,
            "events_applied": self._event_idx,
            "events_pending": len(self.events) - self._event_idx,
            "straggler_flags": self.straggler_flags,
            "straggler_log": self.straggler_log,
            "fault_log": [],
            "wall_s": round(time.time() - t_wall, 1),
        }

    def _run_epoch(self) -> None:
        """Train until the epoch completes, an event comes due, or the step
        budget runs out.  Controller updates happen only on complete epochs."""
        cfg = self.cfg
        alloc = np.asarray(self.alloc)
        n_agg = self.batcher.aggregations_per_epoch(alloc)
        steps_run = 0
        for batch_np in self.batcher.epoch(self.epoch, alloc, start=self.agg_index):
            if self.step_i >= cfg.steps or self._event_due():
                return  # leave agg_index where it is; caller decides
            batch = {
                "inputs": torch.from_numpy(batch_np["inputs"]).to(self.device).long(),
                "targets": torch.from_numpy(batch_np["targets"]).to(self.device).long(),
                "alloc": batch_np["alloc"],
            }
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = metrics["loss"].item()  # host sync: the wall clock covers the device work
            wall = time.perf_counter() - t0
            self.timing.record_step(wall, batch_np["alloc"])
            self.losses.append(loss)
            self.step_i += 1
            self.agg_index += 1
            steps_run += 1
            tokens = float(metrics["tokens"])
            self.step_log.append({"step": self.step_i, "loss": loss, "alloc": np.asarray(batch_np["alloc"]).tolist(),
                                  "wall_s": wall, "tokens": tokens})
            if self.step_i % cfg.log_every == 0 or self.step_i == 1:
                self._log(f"step {self.step_i:5d} loss {loss:.4f} tokens {tokens:.0f} alloc {alloc.tolist()}")
        if self.agg_index >= n_agg:
            self._finish_epoch(steps_run, n_agg)

    def _finish_epoch(self, steps_run: int, n_agg: int) -> None:
        """Epoch boundary: read the timing source, update the controller
        (Alg. 1 steps 1-3), advance the data position."""
        alloc = np.asarray(self.alloc)
        if self.timing.ready:
            t_s = self.timing.epoch_times(alloc, self.epoch)
            t_c = _T_C_SIM if self.simulated else 0.0
            flags = self.straggler.observe(t_s / np.maximum(alloc, 1), epoch=self.epoch, step=self.step_i)
            self.straggler_flags += len(flags)
            for f in flags:
                self.straggler_log.append(
                    {
                        "epoch": self.epoch,
                        "step_end": self.step_i,
                        "worker": f.worker,
                        "z": round(f.z_score, 2),
                        "persistent": f.persistent,
                        "observed": round(f.observed, 6),
                        "baseline": round(f.baseline, 6),
                    }
                )
                self._log(
                    f"[straggler] epoch {self.epoch}: worker {f.worker} z={f.z_score:.1f} persistent={f.persistent}"
                )
            # per-aggregation makespan: simulated t_s is per aggregation,
            # measured t_s is the epoch's accumulated wall per rank
            agg_s = float(np.max(t_s)) + t_c
            if not self.simulated and steps_run > 0:
                agg_s = float(np.max(t_s)) / steps_run
            if steps_run > 0:
                self.epoch_log.append(
                    {
                        "epoch": self.epoch,
                        "n_workers": len(self.gpus),
                        "gpus": list(self.gpus),
                        "alloc": alloc.tolist(),
                        "agg_s": agg_s,
                        "epoch_s": agg_s * n_agg,
                        "steps": steps_run,
                        "step_end": self.step_i,
                    }
                )
            if self.cfg.policy == "adaptive":
                self.alloc = self.ctl.observe(t_s, t_c=t_c)
                if int(np.max(self.alloc)) > self.w_max:
                    self._log(f"[capacity] allocation {self.alloc.tolist()} > w_max={self.w_max}; rebuilding")
                    self._build()
        else:
            self.timing.reset()
        self.epoch += 1
        self.agg_index = 0

    def _epoch_summary(self) -> dict:
        times = [e["epoch_s"] for e in self.epoch_log]
        return {
            "epochs": len(times),
            "total_s": float(np.sum(times)) if times else 0.0,
            "first_epoch_s": times[0] if times else None,
            "last_epoch_s": times[-1] if times else None,
            "improvement": float(1.0 - times[-1] / times[0]) if len(times) > 1 and times[0] > 0 else 0.0,
        }

    def _log(self, msg: str) -> None:
        if self.cfg.verbose:
            print(msg, flush=True)
