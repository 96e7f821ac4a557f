"""Protocol model of the elastic-membership runtime, driving the REAL
production classes (the JAX package's ``analysis/protocol/elastic_model.py``
over the port's copies of them).

The model interleaves heartbeat / miss / fail / outage / rescale /
checkpoint / resume actions against live instances of
:class:`~repro_torch.runtime.elastic.FailureDetector`,
:class:`~repro_torch.runtime.elastic.ElasticCoordinator` (over a real
:class:`~repro_torch.core.controller.AdaptiveAllocationController`), a
:class:`~repro_torch.traces.faults.FaultInjector`, and a
:class:`~repro_torch.runtime.monitor.StragglerMonitor` — the same objects and the
same call sequence ``ElasticTrainer._apply_event`` issues, so the checker
and the runtime cannot drift.

**Identity oracle.**  Each worker carries a stable identity string
(``w0``/``w1``/... for the initial fleet, ``j1``/... for joiners) that the
production code never sees — workers are renumbered on every rescale, and
the whole point of ``FailureDetector.rescale`` / ``FaultInjector.rescale``
is to keep index-addressed state attached to the right physical worker
through that renumbering.  The model keeps a shadow of the detector's miss
counts and the injector's slowdown windows KEYED BY IDENTITY and checks on
every reachable state that the real index-addressed state, read through
the current identity order, matches the shadow.  A forgotten or
wrong-index remap (the ``buggy=`` variants, used by the CLI selftest)
produces a minimized counterexample script.

**Invariants** (checked on every state the BFS discovers):

* membership sizes agree everywhere: detector, controller, injector,
  straggler monitor, GPU list, identity list;
* the controller's allocation is valid: length n, every share >= w_min,
  sum == C (the optimizer-schedule constant);
* **no rescale loses a live worker**: every physically-up identity is
  still a member;
* detector state maps correctly across (consecutive) rescales: the real
  ``FailureDetector.fingerprint()`` equals the one rebuilt from the
  identity-keyed shadow;
* injector slow-windows map correctly: ``compute_scale`` per index equals
  the shadow factor of the identity at that index;
* **kill+resume re-converges to the same fleet**: a ``resume`` action
  rebuilds every class from the checkpoint snapshot via the production
  ``state_dict``/``from_state_dict`` path, and the size/allocation/shadow
  invariants above must hold in the restored state.

Counterexample scripts use the ``--events``/``--faults`` grammar terms
(``fail@step:idx``, ``add@step:gpu``, ``outage@step:i+j``,
``slow@step:idx*factor``) extended with the checker-only kinds
``hb@step:idx``, ``tick@step``, ``ckpt@step``, ``resume@step``; the step
is the action's position in the script, and :func:`parse_script` /
:func:`format_script` roundtrip it.
"""

from __future__ import annotations

import dataclasses
import pickle

from repro_torch.analysis.protocol.explorer import format_script, parse_script  # noqa: F401 — re-export
from repro_torch.core.controller import AdaptiveAllocationController, ControllerConfig
from repro_torch.runtime.elastic import ElasticCoordinator, FailureDetector
from repro_torch.runtime.monitor import StragglerMonitor
from repro_torch.traces.faults import FaultEvent, FaultInjector

__all__ = ["ElasticModel", "ElasticState", "format_script", "parse_script"]

_SLOW_FACTOR = 2.0
_JOIN_GPU = "v100"


def _freeze(obj):
    """Recursively convert a checkpoint payload (nested dicts / lists /
    arrays from the production ``state_dict``s) into a hashable canonical
    form for the state fingerprint."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    if hasattr(obj, "tolist"):  # numpy array / scalar
        return _freeze(obj.tolist())
    return obj


@dataclasses.dataclass
class ElasticState:
    """One node of the state graph: the real objects plus the identity
    oracle.  ``apply`` deep-copies the whole state before mutating."""

    fd: FailureDetector
    ctl: AdaptiveAllocationController
    injector: FaultInjector
    monitor: StragglerMonitor
    gpus: list[str]
    ids: list[str]  # identity per current index (the oracle's key)
    up: frozenset  # identities physically running
    seen: frozenset  # identities that heartbeated this interval (shadow of fd._seen)
    shadow_missed: dict  # identity -> consecutive missed intervals
    shadow_alive: dict  # identity -> detector-view aliveness
    shadow_slow: dict  # identity -> slowdown factor (injector shadow)
    alloc: tuple  # last allocation handed out (ints)
    n_joined: int = 0
    adds_left: int = 1
    slows_left: int = 1
    ckpts_left: int = 1
    resumes_left: int = 1
    snapshot: tuple | None = None  # checkpoint payload (production state_dicts)


class ElasticModel:
    """Bounded model of the heartbeat -> detect -> rescale -> resume loop.

    ``buggy`` seeds a known-bad variant for the checker selftest:

    * ``"remap-identity"`` — the rescale remaps the detector with
      ``range(len(survivors))`` instead of the survivor indices (right
      SIZE, wrong MAPPING — the classic off-by-renumbering bug);
    * ``"skip-detector-remap"`` — the rescale never calls
      ``FailureDetector.rescale`` (stale pre-rescale state);
    * ``"skip-injector-remap"`` — ``FaultInjector.rescale`` is skipped, so
      slow windows stick to dead indices.
    """

    def __init__(
        self,
        n_workers: int = 3,
        total: int = 6,
        patience: int = 2,
        buggy: str | None = None,
        adds: int = 1,
        slows: int = 1,
        ckpts: int = 1,
        resumes: int = 1,
    ) -> None:
        if buggy not in (None, "remap-identity", "skip-detector-remap", "skip-injector-remap"):
            raise ValueError(f"unknown buggy variant {buggy!r}")
        self.n0 = n_workers
        self.total = total
        self.patience = patience
        self.buggy = buggy
        self.bounds = dict(adds=adds, slows=slows, ckpts=ckpts, resumes=resumes)

    # -- model interface -----------------------------------------------------

    def initial(self) -> ElasticState:
        ids = [f"w{i}" for i in range(self.n0)]
        ctl = AdaptiveAllocationController(
            ControllerConfig(total=self.total, n_workers=self.n0, w_min=1)
        )
        return ElasticState(
            fd=FailureDetector(self.n0, patience=self.patience),
            ctl=ctl,
            injector=FaultInjector(self.n0),
            monitor=StragglerMonitor(self.n0),
            gpus=["rtx2080ti"] * self.n0,
            ids=ids,
            up=frozenset(ids),
            seen=frozenset(),
            shadow_missed={i: 0 for i in ids},
            shadow_alive={i: True for i in ids},
            shadow_slow={},
            alloc=tuple(int(w) for w in ctl.allocation),
            adds_left=self.bounds["adds"],
            slows_left=self.bounds["slows"],
            ckpts_left=self.bounds["ckpts"],
            resumes_left=self.bounds["resumes"],
        )

    def actions(self, s: ElasticState) -> list[str]:
        acts: list[str] = []
        up_members = [i for i, ident in enumerate(s.ids) if ident in s.up]
        for i in up_members:
            if s.ids[i] not in s.seen:
                acts.append(f"hb:{i}")
        # weak fairness: the interval only closes once every up member
        # reported — an up worker the detector kills anyway is then a REAL
        # protocol bug, not the detector doing its job on a silent worker
        if all(s.ids[i] in s.seen for i in up_members):
            acts.append("tick")
        if len(s.up) >= 2:
            for i in up_members:
                acts.append(f"fail:{i}")
        if len(s.up) >= 3:
            for a in range(len(up_members)):
                for b in range(a + 1, len(up_members)):
                    acts.append(f"outage:{up_members[a]}+{up_members[b]}")
        # the controller cannot admit a worker it cannot feed: n * w_min must
        # stay within the optimizer-schedule constant C (w_min=1 here)
        if s.adds_left > 0 and len(s.ids) < self.total:
            acts.append(f"add:{_JOIN_GPU}")
        if s.slows_left > 0:
            for i in range(len(s.ids)):
                acts.append(f"slow:{i}*{_SLOW_FACTOR:g}")
        if s.ckpts_left > 0:
            acts.append("ckpt")
        if s.resumes_left > 0 and s.snapshot is not None:
            acts.append("resume")
        return sorted(acts)

    def apply(self, state: ElasticState, action: str) -> ElasticState:
        # pickle round-trip: same semantics as deepcopy for these plain
        # numpy/dict states, ~2x faster — apply() runs once per transition
        s = pickle.loads(pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL))
        kind, _, spec = action.partition(":")
        if kind == "hb":
            i = int(spec)
            s.fd.heartbeat(i)
            ident = s.ids[i]
            s.seen = s.seen | {ident}
            s.shadow_missed[ident] = 0
            s.shadow_alive[ident] = True
        elif kind == "tick":
            dead = s.fd.tick()
            self._shadow_tick(s)
            if dead:
                self._rescale_remove(s, dead)
        elif kind == "fail":
            s.up = s.up - {s.ids[int(spec)]}
        elif kind == "outage":
            a, b = (int(x) for x in spec.split("+"))
            s.up = s.up - {s.ids[a], s.ids[b]}
        elif kind == "add":
            self._rescale_add(s, spec)
        elif kind == "slow":
            idx_s, _, factor_s = spec.partition("*")
            i, factor = int(idx_s), float(factor_s)
            s.injector.apply(FaultEvent(step=0, kind="slow", index=i, factor=factor))
            ident = s.ids[i]
            s.shadow_slow[ident] = s.shadow_slow.get(ident, 1.0) * factor
            s.slows_left -= 1
        elif kind == "ckpt":
            # exactly what the driver persists: production state_dicts plus
            # the membership metadata — the detector is NOT persisted (a
            # restart builds a fresh one), matching ElasticTrainer._restore
            s.snapshot = (
                s.ctl.state_dict(),
                s.injector.state_dict(),
                tuple(s.gpus),
                tuple(s.ids),
                tuple(s.alloc),
                tuple(sorted(s.shadow_slow.items())),
                s.n_joined,
            )
            s.ckpts_left -= 1
        elif kind == "resume":
            self._resume(s)
        else:
            raise ValueError(f"unknown action {action!r}")
        return s

    def fingerprint(self, s: ElasticState) -> tuple:
        return (
            tuple(s.ids),
            tuple(s.gpus),
            tuple(sorted(s.up)),
            tuple(sorted(s.seen)),
            s.fd.fingerprint(),
            s.injector.fingerprint(),
            s.monitor.fingerprint(),
            tuple(s.alloc),
            s.ctl.config.n_workers,
            tuple(sorted(s.shadow_missed.items())),
            tuple(sorted((k, bool(v)) for k, v in s.shadow_alive.items())),
            tuple(sorted(s.shadow_slow.items())),
            (s.adds_left, s.slows_left, s.ckpts_left, s.resumes_left),
            _freeze(s.snapshot),
        )

    def invariants(self, s: ElasticState) -> list[str]:
        msgs: list[str] = []
        n = len(s.ids)
        sizes = {
            "detector": s.fd.n_workers,
            "controller": s.ctl.config.n_workers,
            "injector": s.injector.n_workers,
            "monitor": s.monitor.n_workers,
            "gpus": len(s.gpus),
        }
        bad = {k: v for k, v in sizes.items() if v != n}
        if bad:
            msgs.append(f"membership size mismatch: fleet has {n} workers but {bad}")
        if len(set(s.ids)) != n:
            msgs.append(f"duplicate worker identities: {s.ids}")
        if len(s.alloc) != n or sum(s.alloc) != self.total or any(w < 1 for w in s.alloc):
            msgs.append(
                f"invalid allocation {list(s.alloc)}: must be length {n}, "
                f"every share >= 1, sum == C={self.total}"
            )
        lost = sorted(s.up - set(s.ids))
        if lost:
            msgs.append(f"rescale lost live worker(s) {lost}: physically up but no longer members")
        if not bad:  # index-addressed comparisons only make sense at equal sizes
            want_fd = (
                self.patience,
                tuple(s.shadow_missed[i] for i in s.ids),
                tuple(bool(s.shadow_alive[i]) for i in s.ids),
                tuple(i in s.seen for i in s.ids),
            )
            got_fd = s.fd.fingerprint()
            if got_fd != want_fd:
                msgs.append(
                    f"detector state mapped to the wrong workers after rescale: "
                    f"real {got_fd} != identity-shadow {want_fd} (ids {s.ids})"
                )
            got_scale = tuple(float(x) for x in s.injector.compute_scale(0, n))
            want_scale = tuple(float(s.shadow_slow.get(i, 1.0)) for i in s.ids)
            if got_scale != want_scale:
                msgs.append(
                    f"injector slow-windows mapped to the wrong workers: "
                    f"real {got_scale} != identity-shadow {want_scale} (ids {s.ids})"
                )
        return msgs

    def quiescent(self, s: ElasticState) -> bool:
        # heartbeats/ticks are always available to a live fleet — a state
        # with no enabled action is a real protocol deadlock
        return False

    # -- internals -----------------------------------------------------------

    def _shadow_tick(self, s: ElasticState) -> None:
        newly_dead = []
        for ident in s.ids:
            if s.shadow_alive[ident] and ident not in s.seen:
                s.shadow_missed[ident] += 1
                if s.shadow_missed[ident] >= self.patience:
                    newly_dead.append(ident)
        for ident in newly_dead:
            s.shadow_alive[ident] = False
        s.seen = frozenset()

    def _rescale_remove(self, s: ElasticState, dead: list[int]) -> None:
        plan = ElasticCoordinator(s.ctl).remove(dead)
        removed = [s.ids[i] for i in dead]
        if self.buggy == "remap-identity":
            s.fd.rescale(list(range(len(plan.survivors))), plan.n_new)
        elif self.buggy != "skip-detector-remap":
            s.fd.rescale(plan.survivors, plan.n_new)
        if self.buggy != "skip-injector-remap":
            s.injector.rescale(plan.survivors, plan.n_new)
        s.monitor = StragglerMonitor(len(plan.survivors))
        s.gpus = [s.gpus[i] for i in plan.survivors]
        s.ids = [s.ids[i] for i in plan.survivors]
        s.alloc = tuple(int(w) for w in plan.allocation)
        for ident in removed:
            s.shadow_missed.pop(ident, None)
            s.shadow_alive.pop(ident, None)
            s.shadow_slow.pop(ident, None)  # a window on a dead worker dies with it
        s.up = s.up - set(removed)  # no-op unless a live worker was (wrongly) removed

    def _rescale_add(self, s: ElasticState, gpu: str) -> None:
        plan = ElasticCoordinator(s.ctl).add(1)
        s.fd.rescale(plan.survivors, plan.n_new)
        s.injector.rescale(plan.survivors, plan.n_new)
        s.n_joined += 1
        ident = f"j{s.n_joined}"
        s.monitor = StragglerMonitor(len(plan.survivors) + plan.n_new)
        s.gpus = s.gpus + [gpu]
        s.ids = s.ids + [ident]
        s.alloc = tuple(int(w) for w in plan.allocation)
        s.up = s.up | {ident}
        s.shadow_missed[ident] = 0
        s.shadow_alive[ident] = True
        s.adds_left -= 1

    def _resume(self, s: ElasticState) -> None:
        """Kill + restart from the snapshot through the production
        ``from_state_dict`` restore path (mirrors ``ElasticTrainer._restore``:
        fresh detector sized to the checkpointed fleet, controller and
        injector rebuilt from their state_dicts)."""
        ctl_sd, inj_sd, gpus, ids, alloc, shadow_slow, n_joined = s.snapshot
        s.ctl = AdaptiveAllocationController.from_state_dict(ctl_sd)
        s.injector = FaultInjector.from_state_dict(inj_sd)
        s.fd = FailureDetector(len(gpus), patience=self.patience)
        s.monitor = StragglerMonitor(len(gpus))
        s.gpus = list(gpus)
        s.ids = list(ids)
        s.alloc = tuple(alloc)
        s.n_joined = n_joined
        # the whole checkpointed fleet restarts up, with a clean interval
        s.up = frozenset(ids)
        s.seen = frozenset()
        s.shadow_missed = {i: 0 for i in ids}
        s.shadow_alive = {i: True for i in ids}
        s.shadow_slow = dict(shadow_slow)
        s.resumes_left -= 1
