"""Self-adaptive allocation controller — the paper's Algorithm 1 as a service.

The controller is the host-side state machine that

1. collects per-worker gradient-compute times ``t_s`` after each epoch
   (step 1 of Alg. 1 — in a multi-controller deployment every worker
   broadcasts its own timing; here the monitor hands us the gathered vector),
2. computes the next allocation via eq. 10 (step 2),
3. tells the data pipeline to re-shard (step 3),
4. detects stabilization and freezes ("Step 2 and step 3 could be cancelled
   when the ratio is not fluctuating" — paper observes ~4–5 epochs),
5. (beyond-paper) re-opens adaptation if a frozen allocation drifts out of
   balance — the paper stops permanently, which cannot handle the transient
   stragglers its own fig. 13 discusses; we add a watchdog with hysteresis.
6. (beyond-paper) supports elastic resize: workers joining/leaving re-enter
   adaptation with a proportional warm start (the paper's fig. 11
   add/replace-worker experiment, automated).

The controller is deliberately framework-agnostic: it sees timings in,
allocations out.  ``dist/hetero_step.py`` consumes its allocation as the
per-rank trip-count vector; ``data/sampler.py`` consumes it as sampling
weights.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import allocation as alloc_lib
from repro_torch.core.timing import EpochTiming, TimingLog

__all__ = ["ControllerConfig", "AdaptiveAllocationController"]


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    total: int  # C — microbatches per global step, constant (eq. 4)
    n_workers: int
    w_min: int = 1  # every worker keeps >= w_min microbatches
    ema_beta: float = 0.5  # smoothing on t_s measurements (0 = no smoothing)
    freeze_rel_change: float = 0.05  # |u|_1 / C below this counts as stable
    freeze_patience: int = 2  # consecutive stable epochs before freezing
    reopen_imbalance: float = 0.25  # watchdog: re-adapt if t_s imbalance exceeds
    reopen_patience: int = 2  # ... for this many consecutive epochs
    max_step_frac: float = 1.0  # trust region: cap |u_i| <= frac * w_i (1.0 = off)

    def __post_init__(self) -> None:
        if self.total < self.n_workers * self.w_min:
            raise ValueError("total too small for w_min floor")
        if not (0.0 <= self.ema_beta < 1.0):
            raise ValueError("ema_beta in [0,1)")


@dataclasses.dataclass
class _State:
    w: np.ndarray
    epoch: int = 0
    frozen: bool = False
    stable_count: int = 0
    drift_count: int = 0
    t_s_ema: np.ndarray | None = None


class AdaptiveAllocationController:
    """Algorithm 1 state machine.  One instance per training job."""

    def __init__(
        self,
        config: ControllerConfig,
        initial_allocation: Sequence[int] | None = None,
    ) -> None:
        self.config = config
        if initial_allocation is None:
            w0 = alloc_lib.equal_allocation(config.n_workers, config.total)
        else:
            w0 = np.asarray(initial_allocation, dtype=np.int64)
            if w0.shape != (config.n_workers,):
                raise ValueError("initial allocation has wrong length")
            if int(w0.sum()) != config.total:
                raise ValueError(f"initial allocation sums to {w0.sum()} != C={config.total}")
        self._s = _State(w=w0)
        self.log = TimingLog()

    # -- read-only views -----------------------------------------------------

    @property
    def allocation(self) -> np.ndarray:
        """Current integer allocation w (length n_workers, sums to C)."""
        return self._s.w.copy()

    @property
    def frozen(self) -> bool:
        return self._s.frozen

    @property
    def epoch(self) -> int:
        return self._s.epoch

    @property
    def ratios(self) -> np.ndarray:
        return self._s.w / self._s.w.sum()

    # -- Algorithm 1 ----------------------------------------------------------

    def observe(self, t_s: Sequence[float], t_c: float = 0.0) -> np.ndarray:
        """Feed one epoch's measured compute times; returns next allocation.

        This is steps 1–3 of Algorithm 1 plus the freeze/reopen logic.  The
        caller is responsible for actually re-sharding data / trip counts with
        the returned allocation.
        """
        cfg = self.config
        t = np.asarray(t_s, dtype=np.float64)
        if t.shape != (cfg.n_workers,):
            raise ValueError(f"t_s must have length {cfg.n_workers}")
        if np.any(t <= 0):
            raise ValueError("t_s must be positive")

        self.log.append(EpochTiming(epoch=self._s.epoch, alloc=self._s.w.copy(), t_s=t, t_c=t_c))

        # EMA smoothing (beyond-paper: raw single-epoch times are noisy; the
        # paper's jittered measurements make the raw update oscillate).
        if self._s.t_s_ema is None or cfg.ema_beta == 0.0:
            self._s.t_s_ema = t
        else:
            self._s.t_s_ema = cfg.ema_beta * self._s.t_s_ema + (1 - cfg.ema_beta) * t
        t_eff = self._s.t_s_ema

        if self._s.frozen:
            self._watchdog(t)
            self._s.epoch += 1
            return self.allocation

        result = alloc_lib.adaptive_update(self._s.w, t_eff, w_min=cfg.w_min)
        w_next = result.w
        if cfg.max_step_frac < 1.0:
            w_next = self._trust_region(self._s.w, w_next)

        rel_change = float(np.abs(w_next - self._s.w).sum()) / cfg.total
        self._s.w = w_next
        if rel_change <= cfg.freeze_rel_change:
            self._s.stable_count += 1
            if self._s.stable_count >= cfg.freeze_patience:
                self._s.frozen = True  # revert to static allocation (paper §III.B.3)
        else:
            self._s.stable_count = 0
        self._s.epoch += 1
        return self.allocation

    def _trust_region(self, w_old: np.ndarray, w_new: np.ndarray) -> np.ndarray:
        """Cap per-worker change to ``max_step_frac * w_old`` then re-apportion."""
        cfg = self.config
        cap = np.maximum(np.round(cfg.max_step_frac * w_old), 1).astype(np.int64)
        clipped = np.clip(w_new, w_old - cap, w_old + cap)
        return alloc_lib.largest_remainder_round(clipped.astype(np.float64), cfg.total, cfg.w_min)

    def _watchdog(self, t_s: np.ndarray) -> None:
        """Re-open adaptation when a frozen allocation goes stale (beyond-paper)."""
        cfg = self.config
        imb = float((np.max(t_s) - np.min(t_s)) / np.max(t_s)) if np.max(t_s) > 0 else 0.0
        if imb > cfg.reopen_imbalance:
            self._s.drift_count += 1
            if self._s.drift_count >= cfg.reopen_patience:
                self._s.frozen = False
                self._s.stable_count = 0
                self._s.drift_count = 0
                self._s.t_s_ema = None  # stale smoothing would fight the new regime
        else:
            self._s.drift_count = 0

    # -- elastic resize (paper fig. 11, automated) -----------------------------

    def resize(self, n_workers: int, carry_speeds: Sequence[float] | None = None) -> np.ndarray:
        """Re-target the controller at a new worker count (add/remove/replace).

        ``carry_speeds`` — optional speed estimates for the *new* worker set
        (e.g. surviving workers keep their measured v_i; joiners get the mean).
        Without it the new allocation starts equal.  C is preserved so the
        optimizer schedule does not change (paper eq. 4).
        """
        cfg = self.config
        if n_workers < 1:
            raise ValueError("need at least one worker")
        if carry_speeds is not None:
            v = np.asarray(carry_speeds, dtype=np.float64)
            if v.shape != (n_workers,) or np.any(v <= 0):
                raise ValueError("carry_speeds must be positive, length n_workers")
            target = cfg.total * v / v.sum()
            w0 = alloc_lib.largest_remainder_round(target, cfg.total, cfg.w_min)
        else:
            w0 = alloc_lib.equal_allocation(n_workers, cfg.total)
        self.config = dataclasses.replace(cfg, n_workers=n_workers)
        self._s = _State(w=w0)
        # Rebase the timing log onto the new membership: stale old-length
        # entries would make the NEXT membership change read len(n_old)
        # speeds (ElasticCoordinator indexes log[-1].speeds with new-world
        # ids — a misindex or crash).  Carried speeds become one synthetic
        # observation so a second rescale still warm-starts.
        self.log = TimingLog()
        if carry_speeds is not None:
            # the synthetic alloc uses max(w0,1): with w_min=0 a zero-share
            # worker would otherwise read back speed 0 (= alloc/t_s) and the
            # positivity gate in ElasticCoordinator._speeds would throw away
            # ALL carried speeds on the next rescale
            w_syn = np.maximum(w0, 1)
            self.log.append(EpochTiming(epoch=0, alloc=w_syn, t_s=w_syn / v, t_c=0.0))
        return self.allocation

    # -- checkpointing ---------------------------------------------------------

    # Entries of the timing log bundled into state_dict: enough for the
    # elastic coordinator's warm start (it reads log[-1].speeds) plus context
    # for post-restore monitoring, without growing checkpoints with the run.
    LOG_TAIL = 8

    def state_dict(self) -> dict:
        return {
            "w": self._s.w.tolist(),
            "epoch": self._s.epoch,
            "frozen": self._s.frozen,
            "stable_count": self._s.stable_count,
            "drift_count": self._s.drift_count,
            "t_s_ema": None if self._s.t_s_ema is None else self._s.t_s_ema.tolist(),
            "config": dataclasses.asdict(self.config),
            # without this, every post-restart membership change fell back to
            # a cold equal allocation (ElasticCoordinator._speeds() -> None)
            "log_tail": [r.to_dict() for r in self.log.records[-self.LOG_TAIL :]],
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "AdaptiveAllocationController":
        cfg = ControllerConfig(**state["config"])
        ctl = cls(cfg, initial_allocation=state["w"])
        ctl._s.epoch = state["epoch"]
        ctl._s.frozen = state["frozen"]
        ctl._s.stable_count = state["stable_count"]
        ctl._s.drift_count = state["drift_count"]
        ctl._s.t_s_ema = None if state["t_s_ema"] is None else np.asarray(state["t_s_ema"])
        for rec in state.get("log_tail", []):
            ctl.log.append(EpochTiming.from_dict(rec))
        return ctl
