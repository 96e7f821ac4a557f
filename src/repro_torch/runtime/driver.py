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
* **Fault injection.** ``faults="slow@8:2*3~6,netdeg@20:4~8,outage@30:1+2~5"``
  (``traces.faults.parse_faults``) layers degradation on the membership
  schedule: ``slow``/``netdeg`` windows scale what the timing source
  reports, and a correlated ``outage`` takes several workers through the
  failure detector in one rescale, rejoining them as adds when it heals.
* **Exact resume.** Checkpoints (``ckpt_dir``, every ``ckpt_every`` steps,
  before each membership change and at the end) hold the train state in the
  reference's format (``checkpoint.checkpointer``) with the controller
  state, the data position, the fleet, the event cursor and the fault
  windows, so ``resume`` continues the run where it stopped; the guards
  refuse a resume under another policy, timing mode or data stream.
* **Observability.** ``trace_out``/``metrics_out`` write the Perfetto trace
  and the metrics snapshot of ``obs.TrainObs`` on the virtual clock of the
  modelled aggregation times.
* **One process per rank.** Outside a process group one process holds every
  rank (the reference's single-device (1, 1) mesh).  Inside one (the train
  CLI under ``torchrun``) every process runs this loop, and the mesh is the
  reference's: ``(n, 1)`` over the first n processes when ``1 < n <= world``,
  else ``(1, 1)``; the processes past the mesh sit the step out, and the
  gradient reduce over the mesh is the paper's Ring AllReduce.  A
  membership change rebuilds the mesh and re-places the state, as the
  reference's ``_reshard_state`` does: under ``fsdp="gather"`` it is gathered
  on the old mesh, broadcast from rank 0 to the new mesh's processes that
  did not hold it, and sharded on the new one.  Every process takes the same
  decisions: rank 0's loss, tokens and step wall are broadcast before
  anything reads them, and each epoch checks that every process holds the
  same allocation, fleet and position.  Rank 0 alone writes checkpoints (the
  full tree, gathered first under ``fsdp="gather"``), the trace and the
  metrics; every process restores from the same files and takes its shards.

Epoch semantics: one "epoch" is one pass over the dataset —
``steps_per_epoch`` aggregations by default (``dataset_size`` overrides).
The controller reallocates at epoch boundaries only (paper Alg. 1); a
membership change mid-epoch ends the epoch early.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager, as_train_state
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
from repro_torch.dist.collectives import CommMeter, axis_sizes, ring_allreduce_bytes
from repro_torch.dist.hetero_step import broadcast_train_state, gather_train_state, shard_train_state
from repro_torch.dist.sharding import param_specs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import train_state_spec, train_state_to_jax
from repro_torch.models.transformer import Transformer
from repro_torch.obs import TrainObs, region
from repro_torch.optim import warmup_cosine
from repro_torch.runtime.elastic import (
    ElasticCoordinator,
    FailureDetector,
    MembershipEvent,
    parse_events,
    validate_schedule,
)
from repro_torch.runtime.monitor import MeasuredTimingSource, SimulatedTimingSource, StragglerMonitor
from repro_torch.traces.faults import FaultEvent, FaultInjector, FaultyTimingSource, parse_faults

__all__ = ["DriverConfig", "ElasticTrainer"]

# Simulated collective seconds per aggregation (eq. 2's t_c; matches the
# reference's benchmark harness).  Measured mode folds collective time into
# the wall clock and reports t_c=0.
_T_C_SIM = 0.1


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
    fsdp: str = "none"  # "none" | "gather"
    hetero_gpus: str | None = None  # comma GPU names -> simulated timing
    steps_per_epoch: int = 4  # aggregations per dataset pass (epoch)
    dataset_size: int = 0  # 0 -> total_micro * micro_bs * steps_per_epoch
    lr: float = 3e-4
    ckpt_dir: str | None = None
    ckpt_every: int = 20
    resume: bool = False
    seed: int = 0
    events: str | None = None  # scripted membership schedule
    faults: str | None = None  # scripted fault schedule (slow/netdeg/outage + membership)
    heartbeat_patience: int = 3
    log_every: int = 10
    verbose: bool = True
    trace_out: str | None = None  # Perfetto trace-event JSON path
    metrics_out: str | None = None  # metrics snapshot JSON path
    device: str = "cuda"


class ElasticTrainer:
    """One training job: fixed C, elastic membership.  Construct, then :meth:`run`.

    ``state``: a train state to start from (``dist.init_train_state``'s
    layout, e.g. ``models.convert.train_state_from_jax`` of the reference's)
    instead of the seeded one; it is trained in place.  ``model_cfg``: the
    model's configuration instead of ``cfg.arch``'s (e.g. a shorter
    ``max_seq``, the sequence length outside smoke runs).  With ``cfg.resume``
    the constructor restores the latest checkpoint instead, including its
    membership, which wins over ``cfg.n_workers`` if events had reshaped the
    fleet before the restart."""

    def __init__(self, cfg: DriverConfig, state: dict | None = None, model_cfg: ModelConfig | None = None) -> None:
        if cfg.policy not in ("adaptive", "equal", "static"):
            raise ValueError(f"policy must be adaptive/equal/static, got {cfg.policy!r}")
        if cfg.policy == "static" and not cfg.static_ratio:
            raise ValueError("policy='static' requires static_ratio (e.g. '6,4')")
        if cfg.fsdp not in ("none", "gather"):
            raise ValueError(f"fsdp must be 'none' or 'gather', got {cfg.fsdp!r}")
        if cfg.fsdp == "gather" and cfg.mode != "while":
            raise ValueError("fsdp='gather' pairs with mode='while'")
        if cfg.heartbeat_patience < 1:
            raise ValueError(
                "heartbeat_patience must be >= 1 — with zero patience the failure "
                "detector never declares anyone dead and fail events become silent no-ops"
            )
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        # the process group (the train CLI joins it under torchrun); without one, one process holds every rank
        self.rank, self.world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
        # host-side agreement (rank 0's step scalars, the per-epoch check) rides its own gloo group
        self._ctrl = dist.new_group(backend="gloo") if self.world > 1 else None
        self.model_cfg = model_cfg or (smoke_config(cfg.arch, seq=cfg.seq) if cfg.smoke else get_config(cfg.arch))
        self.C = cfg.total_micro
        self.seq_len = cfg.seq if cfg.smoke else self.model_cfg.max_seq
        self.simulated = cfg.hetero_gpus is not None

        scripted: list = parse_events(cfg.events) if cfg.events else []
        if cfg.faults:
            scripted = scripted + parse_faults(cfg.faults)
        # one validated schedule: a --faults step colliding with an --events
        # step is exactly as order-dependent as two --events terms colliding
        self.events: list = validate_schedule(scripted)
        self._schedule_specs = [e.spec() for e in self.events]  # static schedule (fingerprint)
        self._event_idx = 0

        # -- initial membership ------------------------------------------------
        gpus = (cfg.hetero_gpus or ",".join(["rtx2080ti"] * cfg.n_workers)).split(",")
        self.gpus = [normalize_gpu(g) for g in gpus]
        self.gpus0 = list(self.gpus)  # the job's initial fleet (resume fingerprint)
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
        self.step_log: list[dict] = []  # per step: loss, allocation, wall seconds, tokens, MoE choices kept/made
        self.epoch_log: list[dict] = []
        self.membership_log: list[dict] = []
        self.straggler_flags = 0
        self.straggler_log: list[dict] = []
        self.fd = FailureDetector(len(self.gpus), patience=cfg.heartbeat_patience)
        self.injector = FaultInjector(len(self.gpus)) if cfg.faults else None
        self.fault_log: list[dict] = []
        self.ckpt_log: list[dict] = []  # per save and restore: op, step, seconds, bytes

        # -- checkpointing / resume -------------------------------------------
        self.mgr = CheckpointManager(cfg.ckpt_dir, save_every=cfg.ckpt_every) if cfg.ckpt_dir else None
        like_scfg = HeteroStepConfig(w_max=1, micro_bs=cfg.micro_bs, seq_len=self.seq_len, optimizer="adamw")
        self.state = state or init_train_state(self.model_cfg, like_scfg, cfg.seed, device=self.device)
        # observability: virtual-clock spans/metrics, no-op unless requested
        self.obs = TrainObs(cfg.trace_out, cfg.metrics_out) if self.rank == 0 else TrainObs(None, None)
        self._param_bytes = sum(p.numel() * p.element_size() for p in self.state["params"].parameters())
        if self.mgr and cfg.resume and self.mgr.latest_step() is not None:
            self._restore()
        # the processes on the mesh hold the state: every process, whole, until the first mesh
        self.mesh, self._meshes, self._mesh_size, self._pspecs = None, {}, self.world, None
        self._meters: list[CommMeter] = []
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
            fsdp="gather" if cfg.fsdp == "gather" else False,
            fsdp_axes=("data",),
            optimizer="adamw",
            collective="ring",  # the paper's reduce; the identity on one process
        )
        if dist.is_initialized():
            shape = (n, 1) if 1 < n <= self.world else (1, 1)
            if shape not in self._meshes:  # building a mesh's groups is collective: every process, same order
                self._meshes[shape] = make_test_mesh(shape, ("data", "model"), self.device.type)
            if self._meshes[shape] is not self.mesh:
                self._reshard_state(self._meshes[shape], shape[0])
        self.step_fn = build_train_step(self.model_cfg, self.scfg, lr_fn=warmup_cosine(cfg.lr, 10, cfg.steps),
                                        mesh=self.mesh if self.member else None)
        self._meters.append(self.step_fn.meter)
        self.batcher = HeteroBatcher(self.dataset, n, cfg.micro_bs, self.w_max, seed=cfg.seed)
        self._rebuild_monitoring()

    def _rebuild_monitoring(self) -> None:
        """(Re)create the timing source + straggler monitor for the current fleet."""
        n = len(self.gpus)
        if self.simulated:
            self.timing = SimulatedTimingSource(ClusterSpec.from_gpus(self.gpus, seed=self.cfg.seed))
        else:
            self.timing = MeasuredTimingSource(n)
        # a fresh measured source covers steps from the current data position
        # on; _finish_epoch must not take a from-mid-epoch accumulation
        # (after a resume) for a whole epoch's measurement
        self._timing_from_agg = self.agg_index
        if self.injector is not None:
            # fault windows perturb what the controller measures, whatever the
            # inner source is: injected stragglers ride the real path
            self.timing = FaultyTimingSource(self.timing, self.injector, lambda: self.step_i)
        self.straggler = StragglerMonitor(n)

    # -- placement on the mesh ----------------------------------------------------

    @property
    def member(self) -> bool:
        """Does this process run the step (is it on the mesh)?"""
        return self.rank < self._mesh_size

    @property
    def comm(self) -> CommMeter:
        """This process's ring bytes, ring reduce steps and collective seconds over every step function it built."""
        return CommMeter(*(sum(getattr(m, f.name) for m in self._meters) for f in dataclasses.fields(CommMeter)))

    def _reshard_state(self, mesh, members: int) -> None:
        """Place the state for a new mesh over the first ``members`` processes:
        gather it on the old mesh where it was sharded, broadcast it from rank
        0 to the new mesh's processes that did not hold it, and take this
        process's shards where ``fsdp="gather"`` shards it."""
        if self._pspecs is not None:  # this process holds shards of the old mesh
            gather_train_state(self.state, self._pspecs, self.mesh)
            self._pspecs = None
        if self.rank < members and members > self._mesh_size:
            broadcast_train_state(self.state, mesh.get_group("data"))
        self.mesh, self._mesh_size = mesh, members
        if self.cfg.fsdp == "gather" and members > 1 and self.member:
            skeleton = Transformer(self.model_cfg, device="meta")
            self._pspecs = param_specs(skeleton, axis_sizes(mesh), self.model_cfg, fsdp=True)
            shard_train_state(self.state, self._pspecs, mesh)

    def _from_rank0(self, *values: float) -> list[float]:
        """Rank 0's values on every process (the controller's inputs must agree bit for bit)."""
        if self._ctrl is None:
            return list(values)
        t = torch.tensor(values, dtype=torch.float64)
        dist.broadcast(t, src=0, group=self._ctrl)
        return t.tolist()

    def _check_agreement(self) -> None:
        """Every process holds the same allocation, fleet and position (once an epoch)."""
        if self._ctrl is None:
            return
        mine = json.dumps([np.asarray(self.alloc).tolist(), self.gpus, self.step_i, self.epoch, self._event_idx])
        h = torch.tensor([zlib.crc32(mine.encode())], dtype=torch.int64)
        every = [torch.zeros_like(h) for _ in range(self.world)]
        dist.all_gather(every, h, group=self._ctrl)
        if any(int(x) != int(h) for x in every):
            raise RuntimeError(f"rank {self.rank}: the processes disagree on the allocation/fleet/position {mine}")

    # -- checkpoints ---------------------------------------------------------------

    def _metadata(self) -> dict:
        meta = {
            "controller": self.ctl.state_dict(),
            "epoch": self.epoch,
            "agg_index": self.agg_index,
            "gpus": list(self.gpus),
            "alloc": np.asarray(self.alloc).tolist(),
            "events_applied": self._event_idx,
            "policy": self.cfg.policy,
            "timing": "simulated" if self.simulated else "measured",
            "data": self._data_fingerprint(),
        }
        if self.injector is not None:
            # the live schedule (static + the recovery adds an outage
            # scheduled) and the open fault windows: the event cursor indexes
            # into this schedule, not the static one
            meta["faults"] = {
                "injector": self.injector.state_dict(),
                "schedule": [e.spec() for e in self.events],
            }
        return meta

    def _data_fingerprint(self) -> dict:
        """What defines the run a checkpoint's position points into: the data
        stream, the initial fleet (the current one drifts with events) and the
        event schedule (the saved cursor indexes into it)."""
        return {
            "seed": self.cfg.seed,
            "dataset_size": len(self.dataset),
            "total_micro": self.C,
            "micro_bs": self.cfg.micro_bs,
            "seq_len": self.seq_len,
            "gpus0": list(self.gpus0),
            "events": list(self._schedule_specs),
        }

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _log_io(self, op: str, t0: float) -> None:
        path = self.mgr._step_dir(self.step_i)
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        self.ckpt_log.append({"op": op, "step": self.step_i, "seconds": time.perf_counter() - t0, "bytes": size})

    def _save(self) -> None:
        """Rank 0 writes the full tree; under ``fsdp="gather"`` the mesh gathers it first."""
        self._sync()
        t0 = time.perf_counter()
        if self._pspecs is not None:
            gather_train_state(self.state, self._pspecs, self.mesh)
        if self.rank == 0:
            self.mgr.save(self.step_i, train_state_to_jax(self.state, self.model_cfg), metadata=self._metadata())
            self._log_io("save", t0)
        if self._pspecs is not None:
            shard_train_state(self.state, self._pspecs, self.mesh)
        self.obs.on_checkpoint(self.step_i)

    def _restore(self) -> None:
        t0 = time.perf_counter()
        like = train_state_spec(self.state, self.model_cfg)
        opt_dtypes = {k: [t.dtype for t in v] for k, v in self.state["opt"].items() if isinstance(v, list)}
        self.step_i, tree, meta = self.mgr.restore(like)
        self.state = None  # the live state leaves the device before the restored one arrives
        self.state = as_train_state(tree, self.model_cfg, self.device, opt_dtypes)
        self._sync()
        self._log_io("restore", t0)
        ctl_state = meta["controller"]
        if isinstance(ctl_state, str):  # the reference's early checkpoints json.dumps'd it
            ctl_state = json.loads(ctl_state)
        self.ctl = AdaptiveAllocationController.from_state_dict(ctl_state)
        ckpt_policy = meta.get("policy", self.cfg.policy)
        if ckpt_policy != self.cfg.policy:
            raise ValueError(
                f"checkpoint was written under policy={ckpt_policy!r} but this run asks "
                f"for policy={self.cfg.policy!r}; resuming would train on an allocation "
                "the flags never requested — restart without --resume to switch policy"
            )
        this_timing = "simulated" if self.simulated else "measured"
        ckpt_timing = meta.get("timing", this_timing)
        if ckpt_timing != this_timing:
            raise ValueError(
                f"checkpoint was written under {ckpt_timing} timing but this run uses "
                f"{this_timing} (--hetero-gpus changed?); the restored controller log "
                "carries the other mode's speed units — resume with the original flags"
            )
        this_data = self._data_fingerprint()
        ckpt_data = meta.get("data", this_data)
        if ckpt_data != this_data:
            diff = {k: (v, this_data[k]) for k, v in ckpt_data.items() if this_data.get(k) != v}
            raise ValueError(
                f"checkpoint's data stream does not match this run's flags: "
                f"{{field: (checkpoint, now)}} = {diff}; the restored epoch/aggregation "
                "position (and event cursor) would point into a different run — resume "
                "with the original seed/dataset/batch/fleet/--events flags"
            )
        self.epoch = int(meta.get("epoch", 0))
        self.agg_index = int(meta.get("agg_index", 0))
        self.gpus = list(meta.get("gpus", self.gpus))
        self.alloc = np.asarray(meta.get("alloc", self.ctl.allocation), dtype=np.int64)
        self._event_idx = int(meta.get("events_applied", 0))
        if self.injector is not None and "faults" in meta:
            # the saved schedule may carry recovery adds the static --faults
            # string does not; the cursor indexes into it
            self.injector = FaultInjector.from_state_dict(meta["faults"]["injector"])
            sched = ",".join(meta["faults"]["schedule"])
            self.events = parse_faults(sched) if sched else []
        if self._event_idx > len(self.events):
            raise ValueError(
                f"checkpoint had {self._event_idx} events applied but --events "
                f"lists only {len(self.events)}; resume with the original schedule"
            )
        self.fd = FailureDetector(len(self.gpus), patience=self.cfg.heartbeat_patience)
        self._log(
            f"[resume] step {self.step_i}, epoch {self.epoch} agg {self.agg_index}, "
            f"fleet {self.gpus}, allocation {np.asarray(self.alloc).tolist()}"
        )

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

    def _apply_event(self, ev: MembershipEvent | FaultEvent) -> None:
        if ev.kind in ("slow", "netdeg"):
            # timing faults perturb measurements, not membership: no barrier
            # checkpoint, no early epoch boundary, no rebuild
            self.injector.apply(ev)
            self.fault_log.append({"step": self.step_i, "fault": ev.spec()})
            self.obs.on_fault(self.step_i, ev.spec(), getattr(ev, "duration", None))
            self._log(f"[fault] step {self.step_i}: {ev.spec()} active")
            return

        n = len(self.gpus)
        victims = sorted(getattr(ev, "workers", ()))
        if ev.kind in ("fail", "replace") and not (0 <= ev.index < n):
            raise ValueError(f"event {ev}: worker index out of range for membership size {n}")
        if ev.kind == "outage" and (not victims or victims[-1] >= n):
            raise ValueError(f"event {ev}: outage workers {victims} out of range for membership size {n}")
        if (ev.kind == "fail" and n == 1) or (ev.kind == "outage" and len(victims) >= n):
            raise ValueError(f"event {ev}: cannot fail the last remaining worker — the fleet would be empty")

        # barrier checkpoint with the pre-event metadata: a crash during the
        # rebuild resumes just before the event and applies it again
        if self.mgr:
            self._save()
        if ev.kind == "outage":
            # an outage is both a membership change and a fault window
            self.obs.on_fault(self.step_i, ev.spec(), getattr(ev, "duration", None))

        coord = ElasticCoordinator(self.ctl)
        if ev.kind in ("fail", "outage"):
            # through the detector: the silent workers stop heartbeating and
            # are declared dead after `patience` missed intervals; an outage
            # is the correlated case, one rescale for the whole group
            silent = set(victims or [ev.index])
            dead: list[int] = []
            for _ in range(self.fd.patience):
                for w in range(self.fd.n_workers):
                    if w not in silent and self.fd.alive[w]:
                        self.fd.heartbeat(w)
                dead = self.fd.tick() or dead
            plan = coord.remove(dead, restore_step=self.step_i)
            new_gpus = [self.gpus[i] for i in plan.survivors]
            if ev.kind == "outage" and ev.duration is not None:
                # the outage heals: victims rejoin as adds with their own GPU
                # types, `duration` steps out
                self._schedule_recovery([self.gpus[i] for i in sorted(silent)], self.step_i + ev.duration)
        elif ev.kind == "add":
            plan = coord.add(1, est_speed=self._est_speed(ev.gpu))
            new_gpus = self.gpus + [ev.gpu]
        else:  # replace
            plan = coord.replace(ev.index, est_speed=self._est_speed(ev.gpu))
            new_gpus = list(self.gpus)
            new_gpus[ev.index] = ev.gpu

        self.fd.rescale(plan.survivors, plan.n_new)
        if self.injector is not None:
            # slow windows are slot-indexed like the detector's miss counts
            self.injector.rescale(plan.survivors, plan.n_new)
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
        detail: dict = {"index": ev.index, "gpu": ev.gpu}
        if victims:
            detail["workers"] = victims
        self.membership_log.append(
            {
                "step": self.step_i,
                "event": f"{ev.kind}@{ev.step}",
                "detail": detail,
                "gpus": list(self.gpus),
                "allocation": self.alloc.tolist(),
            }
        )
        self.obs.on_membership(self.step_i, f"{ev.kind}@{ev.step}", self.gpus, self.alloc)
        self._log(f"[elastic] step {self.step_i}: {ev.kind} -> fleet {self.gpus}, allocation {self.alloc.tolist()}")
        if len(self.gpus) == n and int(np.max(self.alloc)) <= self.w_max:
            # same worker count and the allocation fits the buffers: the step
            # and batcher stay valid, only the speed model follows the fleet
            self._rebuild_monitoring()
        else:
            self._build()

    def _schedule_recovery(self, gpus: list[str], at_step: int) -> None:
        """Insert dynamic ``add`` events for healed outage victims, each on its
        own free step (the validated schedule owns every step), keeping the
        applied prefix of ``self.events`` untouched."""
        used = {e.step for e in self.events}
        step = max(at_step, self.step_i + 1)
        for gpu in gpus:
            while step in used:
                step += 1
            used.add(step)
            ev = FaultEvent(step=step, kind="add", gpu=gpu)
            self.events.append(ev)
            self.fault_log.append({"step": self.step_i, "fault": f"recovery scheduled: {ev.spec()}"})
            self._log(f"[fault] step {self.step_i}: outage heals at step {step} ({gpu} rejoins)")
        # re-sort the pending tail; applied events all precede step_i < the
        # new steps, so the cursor's prefix is stable and steps stay unique
        self.events = validate_schedule(self.events)

    # -- the loop -----------------------------------------------------------------

    def run(self) -> dict:
        cfg = self.cfg
        t_wall = time.time()
        while self.step_i < cfg.steps:
            if self._apply_due_events():
                continue
            self._run_epoch()
        if self.mgr:
            # terminal checkpoint: a later --resume with more --steps continues
            # from here instead of the last periodic save
            self._save()
        self.obs.close()
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
            "fault_log": self.fault_log,
            "wall_s": round(time.time() - t_wall, 1),
        }

    def _run_epoch(self) -> None:
        """Train until the epoch completes, an event comes due, or the step
        budget runs out.  Controller updates happen only on complete epochs.
        Under a profiler each batch's draw and copies to the device run in a
        ``repro.driver.batch`` range (``obs.ranges``)."""
        cfg = self.cfg
        alloc = np.asarray(self.alloc)
        n_agg = self.batcher.aggregations_per_epoch(alloc)
        steps_run = 0
        batches = self.batcher.epoch(self.epoch, alloc, start=self.agg_index)
        while True:
            with region("repro.driver.batch"):
                batch_np = next(batches, None)
                stop = batch_np is not None and (self.step_i >= cfg.steps or self._event_due())
                if batch_np is not None and not stop:
                    batch = {
                        "inputs": torch.from_numpy(batch_np["inputs"]).to(self.device).long(),
                        "targets": torch.from_numpy(batch_np["targets"]).to(self.device).long(),
                        "alloc": batch_np["alloc"],
                    }
            if batch_np is None:
                break
            if stop:
                return  # leave agg_index where it is; caller decides
            t0 = time.perf_counter()
            loss = tokens = grad_norm = moe_kept = moe_choices = 0.0
            if self.member:
                self.state, metrics = self.step_fn(self.state, batch)
                loss = metrics["loss"].item()  # host sync: the wall clock covers the device work
                tokens, grad_norm = float(metrics["tokens"]), float(metrics["grad_norm"])
                # this process's counted microbatches (each process its own rows)
                moe_kept, moe_choices = float(metrics["moe_kept"]), float(metrics["moe_choices"])
            wall = time.perf_counter() - t0
            loss, tokens, grad_norm, wall = self._from_rank0(loss, tokens, grad_norm, wall)
            self.timing.record_step(wall, batch_np["alloc"])
            self.losses.append(loss)
            self.step_i += 1
            self.agg_index += 1
            steps_run += 1
            self.step_log.append({"step": self.step_i, "loss": loss, "alloc": np.asarray(batch_np["alloc"]).tolist(),
                                  "wall_s": wall, "tokens": tokens, "moe_kept": moe_kept,
                                  "moe_choices": moe_choices, "grad_norm": grad_norm})
            # the metadata (controller state_dict + log tail) is serialized
            # only on steps that save
            if self.mgr and self.mgr.is_due(self.step_i):
                self._save()
            if self.step_i % cfg.log_every == 0 or self.step_i == 1:
                self._log(f"step {self.step_i:5d} loss {loss:.4f} tokens {tokens:.0f} alloc {alloc.tolist()}")
        if self.agg_index >= n_agg:
            self._finish_epoch(steps_run, n_agg)

    def _finish_epoch(self, steps_run: int, n_agg: int) -> None:
        """Epoch boundary: read the timing source, update the controller
        (Alg. 1 steps 1-3), advance the data position."""
        self._check_agreement()
        alloc = np.asarray(self.alloc)
        complete = self.simulated or self._timing_from_agg == 0
        if self.timing.ready and complete:
            t_s = self.timing.epoch_times(alloc, self.epoch)
            t_c = _T_C_SIM if self.simulated else 0.0
            # an active netdeg fault scales the collective model (measured
            # mode folds collectives into the wall clock; nothing to scale)
            t_c *= getattr(self.timing, "last_collective_scale", 1.0)
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
                # a resume can land on an epoch's last aggregation (saved after
                # the step, before _finish_epoch): the controller update below
                # is still due, but a 0-step epoch is not logged
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
            if self.obs.enabled and steps_run > 0:
                self.obs.on_epoch(
                    self.epoch,
                    self.step_i,
                    steps_run,
                    [float(t) for t in t_s],
                    t_c,
                    alloc,
                    self.gpus,
                    per_agg=self.simulated,
                    coll_bytes=ring_allreduce_bytes(self._param_bytes, len(self.gpus)),
                )
                self.obs.on_flags(self.epoch, self.step_i, flags)
            if self.cfg.policy == "adaptive":
                self.alloc = self.ctl.observe(t_s, t_c=t_c)
                if int(np.max(self.alloc)) > self.w_max:
                    self._log(f"[capacity] allocation {self.alloc.tolist()} > w_max={self.w_max}; rebuilding")
                    self._build()
        else:
            # a resume landed mid-epoch: the wall time before the restart is
            # gone, so skip one controller update rather than feed it a
            # truncated measurement, and drop the partial accumulation
            self.timing.reset()
        self.epoch += 1
        self.agg_index = 0
        self._timing_from_agg = 0

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
        if self.cfg.verbose and self.rank == 0:
            print(msg, flush=True)
