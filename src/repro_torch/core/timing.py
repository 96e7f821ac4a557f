"""Epoch timing records shared by the controller, simulator and monitor.

Vocabulary follows the paper §III.B.1:

* ``t_s`` — per-worker gradient compute time for one aggregation
* ``t_c`` — AllReduce + parameter-update time (equal across workers, eq. 2)
* ``t_w`` — synchronization wait, ``max_j t_s^j - t_s^i``
* ``T``   — total per-aggregation time, ``t_s + t_w + t_c`` (equal, eq. 3)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["EpochTiming", "TimingLog"]


@dataclasses.dataclass(frozen=True)
class EpochTiming:
    epoch: int
    alloc: np.ndarray  # w_i used this epoch (int)
    t_s: np.ndarray  # per-worker compute seconds
    t_c: float  # collective seconds (scalar, eq. 2)

    def __post_init__(self) -> None:
        if self.alloc.shape != self.t_s.shape:
            raise ValueError("alloc / t_s shape mismatch")

    @property
    def t_w(self) -> np.ndarray:
        return np.max(self.t_s) - self.t_s

    @property
    def makespan(self) -> float:
        """Wall-clock for one aggregation = slowest compute + collective."""
        return float(np.max(self.t_s) + self.t_c)

    @property
    def total_wait(self) -> float:
        """Paper eq. 6 objective (up to pairing): total wasted worker-seconds."""
        return float(np.sum(self.t_w))

    @property
    def speeds(self) -> np.ndarray:
        return self.alloc / self.t_s

    @property
    def imbalance(self) -> float:
        mx = float(np.max(self.t_s))
        return 0.0 if mx == 0 else float((mx - np.min(self.t_s)) / mx)

    # -- checkpoint serialization (controller state_dict bundles a log tail) --

    def to_dict(self) -> dict:
        return {
            "epoch": int(self.epoch),
            "alloc": np.asarray(self.alloc).tolist(),
            "t_s": np.asarray(self.t_s).tolist(),
            "t_c": float(self.t_c),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EpochTiming":
        return cls(
            epoch=int(d["epoch"]),
            alloc=np.asarray(d["alloc"], dtype=np.int64),
            t_s=np.asarray(d["t_s"], dtype=np.float64),
            t_c=float(d["t_c"]),
        )


@dataclasses.dataclass
class TimingLog:
    """Append-only per-epoch log; the benchmark figures read from this."""

    records: list[EpochTiming] = dataclasses.field(default_factory=list)

    def append(self, rec: EpochTiming) -> None:
        self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> EpochTiming:
        return self.records[i]

    @property
    def makespans(self) -> np.ndarray:
        return np.array([r.makespan for r in self.records])

    @property
    def allocations(self) -> np.ndarray:
        return np.stack([r.alloc for r in self.records])

    @property
    def compute_times(self) -> np.ndarray:
        return np.stack([r.t_s for r in self.records])

    def total_time(self) -> float:
        return float(self.makespans.sum())

    def summary(self) -> dict:
        m = self.makespans
        return {
            "epochs": len(self.records),
            "total_s": float(m.sum()),
            "first_epoch_s": float(m[0]) if len(m) else float("nan"),
            "last_epoch_s": float(m[-1]) if len(m) else float("nan"),
            "improvement": float(1.0 - m[-1] / m[0]) if len(m) > 1 and m[0] > 0 else 0.0,
        }
