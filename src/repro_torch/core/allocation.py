"""Task-allocation mathematics from the paper (§III + Appendix A).

The paper's quantities, in this module's vocabulary:

* ``w`` — integer vector, ``w[i]`` = number of gradient-accumulation
  microbatches worker *i* executes per global step ("one gradient
  aggregation").  ``C = sum(w)`` is held constant so the SGD update is
  invariant (paper eq. 1/4).
* ``t_s`` — measured per-worker gradient-compute time for the last epoch.
* ``v[i] = w[i] / t_s[i]`` — realized speed (microbatches / second).
* eq. 10 — the self-adaptive update:
  ``w'[i] = C * (w[i]/t_s[i]) / sum_j (w[j]/t_s[j])``.
* Appendix A — the same update derived as the unique solution of the
  wait-equalization linear system ``A @ u = b``; implemented in
  :func:`appendix_solve` and property-tested against the closed form.

Everything here is plain NumPy: the allocation runs on the host between
epochs, never inside a jitted step.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "equal_allocation",
    "static_allocation",
    "speeds",
    "closed_form_target",
    "adaptive_update",
    "appendix_solve",
    "largest_remainder_round",
    "makespan",
    "waiting_times",
    "allocation_imbalance",
    "AllocationResult",
]


def _as_float(x) -> np.ndarray:
    a = np.asarray(x, dtype=np.float64)
    if a.ndim != 1:
        raise ValueError(f"expected 1-D array, got shape {a.shape}")
    return a


# ---------------------------------------------------------------------------
# Static allocation (§III.A)
# ---------------------------------------------------------------------------


def equal_allocation(n_workers: int, total: int) -> np.ndarray:
    """Classic Ring-AllReduce split: every worker gets ``total/n`` microbatches.

    Remainder (when ``total % n != 0``) is spread over the first workers with
    largest-remainder rounding so that ``sum == total`` exactly.
    """
    if n_workers <= 0:
        raise ValueError("n_workers must be positive")
    if total < n_workers:
        raise ValueError(f"total={total} < n_workers={n_workers}: every worker needs >=1")
    return largest_remainder_round(np.full(n_workers, total / n_workers), total, w_min=1)


def static_allocation(ratios: Sequence[float], total: int, w_min: int = 1) -> np.ndarray:
    """Paper §III.A: allocate ``total`` microbatches by a hand-chosen ratio.

    ``ratios`` is e.g. ``[6, 4]`` for the paper's "6:4" group; any positive
    weights work.  Result is integral, sums to ``total`` and respects
    ``w_min`` (the paper requires every worker to train at least one
    microbatch so no worker is starved out of the ring).
    """
    r = _as_float(ratios)
    if np.any(r <= 0):
        raise ValueError("ratios must be strictly positive")
    target = total * r / r.sum()
    return largest_remainder_round(target, total, w_min=w_min)


# ---------------------------------------------------------------------------
# Self-adaptive allocation (§III.B)
# ---------------------------------------------------------------------------


def speeds(w: Sequence[float], t_s: Sequence[float]) -> np.ndarray:
    """Realized speed ``v_i = w_i / t_s^i`` (paper notation §III.B.1).

    ``t_s`` entries must be positive; a worker that reported 0 time has not
    produced a measurement yet and the caller should not adapt on it.
    """
    w_ = _as_float(w)
    t = _as_float(t_s)
    if w_.shape != t.shape:
        raise ValueError(f"shape mismatch {w_.shape} vs {t.shape}")
    if np.any(t <= 0):
        raise ValueError("t_s must be strictly positive")
    return w_ / t


def closed_form_target(w: Sequence[float], t_s: Sequence[float]) -> np.ndarray:
    """Paper eq. 10 — real-valued target allocation for the next epoch.

    ``w'[i] = C * (w[i]/t_s[i]) / sum_j (w[j]/t_s[j])`` with ``C = sum(w)``.
    Equivalently ``C * v_i / sum(v)`` (eq. 9 rearranged).
    """
    v = speeds(w, t_s)
    C = float(np.sum(_as_float(w)))
    return C * v / v.sum()


@dataclasses.dataclass(frozen=True)
class AllocationResult:
    """One adaptive step: integer allocation + diagnostics."""

    w: np.ndarray  # integer allocation, sums to C
    target: np.ndarray  # real-valued eq.10 target before rounding
    u: np.ndarray  # integer increments w' - w (paper's u, sums to 0)
    v: np.ndarray  # realized speeds used

    @property
    def total(self) -> int:
        return int(self.w.sum())


def adaptive_update(
    w: Sequence[int],
    t_s: Sequence[float],
    w_min: int = 1,
) -> AllocationResult:
    """One iteration of Algorithm 1 step 2: ``w^(k) , t_s^(k) -> w^(k+1)``.

    Rounding uses largest-remainder so ``sum(w') == sum(w) == C`` exactly
    (paper eq. 4/5: total batch constant, increments sum to zero).  ``w_min``
    keeps every worker in the ring with at least one microbatch — without it
    a 100x straggler would be allocated 0 and drop out of the data partition,
    which the paper implicitly forbids ("there are no remaining samples
    without training after one epoch").
    """
    w_arr = np.asarray(w, dtype=np.int64)
    target = closed_form_target(w_arr, t_s)
    C = int(w_arr.sum())
    w_next = largest_remainder_round(target, C, w_min=w_min)
    return AllocationResult(
        w=w_next,
        target=target,
        u=w_next - w_arr,
        v=speeds(w_arr, t_s),
    )


def appendix_solve(w: Sequence[float], v: Sequence[float]) -> np.ndarray:
    """Appendix A: solve ``A @ u = b`` (eq. 19–21) for the increment ``u``.

    Builds the (n-1) chained wait-equalization rows ``(w_i+u_i)/v_i ==
    (w_{i+1}+u_{i+1})/v_{i+1}`` (eq. 14) plus the conservation row
    ``sum(u) = 0`` (eq. 17) and solves exactly.  The paper's closed form
    (eq. 22) must equal this solution; tests assert it.
    """
    w_ = _as_float(w)
    v_ = _as_float(v)
    n = w_.shape[0]
    if n == 1:
        return np.zeros(1)
    if np.any(v_ <= 0):
        raise ValueError("speeds must be strictly positive")
    A = np.zeros((n, n))
    b = np.zeros(n)
    for i in range(n - 1):
        A[i, i] = 1.0 / v_[i]
        A[i, i + 1] = -1.0 / v_[i + 1]
        b[i] = w_[i + 1] / v_[i + 1] - w_[i] / v_[i]
    A[n - 1, :] = 1.0  # sum(u) = 0
    b[n - 1] = 0.0
    return np.linalg.solve(A, b)


# ---------------------------------------------------------------------------
# Integer rounding
# ---------------------------------------------------------------------------


def largest_remainder_round(target, total: int, w_min: int = 0) -> np.ndarray:
    """Round a nonnegative real vector to integers with exact sum ``total``.

    Largest-remainder (Hamilton) apportionment with a per-entry floor
    ``w_min``.  The paper only says "rounding decimals of u_i" (§III.B.3);
    Hamilton rounding is the canonical sum-preserving choice and minimizes
    max deviation from the real target.

    Requires ``total >= n * w_min``.
    """
    t = _as_float(target)
    n = t.shape[0]
    if total < n * w_min:
        raise ValueError(f"total={total} cannot satisfy w_min={w_min} for {n} workers")
    t = np.maximum(t, 0.0)
    # Clamp to floor first, then apportion the remaining mass by remainder.
    base = np.maximum(np.floor(t).astype(np.int64), w_min)
    # floor() may overshoot total when many entries clamp up to w_min; fix by
    # iteratively removing from the largest-above-floor entries.
    while base.sum() > total:
        over = np.where(base > w_min)[0]
        if over.size == 0:  # pragma: no cover - guarded by the ValueError above
            raise RuntimeError("cannot reduce below w_min floor")
        # remove from the entry whose integer is furthest above its target
        j = over[np.argmax(base[over] - t[over])]
        base[j] -= 1
    deficit = total - int(base.sum())
    if deficit > 0:
        # If the targets sum far below `total` the deficit can exceed n;
        # spread whole rounds uniformly first, then apportion the remainder
        # to the largest fractional parts (stable tie-break by index).
        base += deficit // n
        deficit -= (deficit // n) * n
        if deficit:
            remainders = t - np.floor(t)
            order = np.argsort(-remainders, kind="stable")
            base[order[:deficit]] += 1
    assert base.sum() == total, (base, total)
    assert np.all(base >= w_min)
    return base


# ---------------------------------------------------------------------------
# Timing model helpers (used by controller, simulator, benchmarks)
# ---------------------------------------------------------------------------


def makespan(w: Sequence[float], v: Sequence[float], t_allreduce: float = 0.0) -> float:
    """Epoch time under synchronous AllReduce: ``max_i(w_i / v_i) + t_c``.

    This is the objective the paper minimizes (eq. 6/7): the barrier makes
    the step as slow as the slowest worker; AllReduce time ``t_c`` is equal
    for all workers (paper eq. 2).
    """
    w_ = _as_float(w)
    v_ = _as_float(v)
    return float(np.max(w_ / v_) + t_allreduce)


def waiting_times(w: Sequence[float], v: Sequence[float]) -> np.ndarray:
    """Per-worker synchronization wait ``t_w^i = max_j(t_s^j) - t_s^i``."""
    t = _as_float(w) / _as_float(v)
    return np.max(t) - t


def allocation_imbalance(w: Sequence[float], v: Sequence[float]) -> float:
    """Relative imbalance: ``(max t_s - min t_s) / max t_s`` in [0, 1).

    0 means perfectly balanced (the paper's eq. 8 fixpoint).  Used by the
    controller to decide freezing and by the monitor to detect drift.
    """
    t = _as_float(w) / _as_float(v)
    mx = float(np.max(t))
    if mx == 0.0:
        return 0.0
    return float((mx - np.min(t)) / mx)
