"""Bounded explicit-state model checking of the port's two stateful
protocols, driving the port's REAL production classes (a copy of the JAX
package's ``analysis/protocol`` over ``repro_torch``'s own classes):

* :mod:`.elastic_model` — heartbeat/failure-detection/rescale/checkpoint/
  resume over ``FailureDetector`` + ``ElasticCoordinator`` +
  ``FaultInjector`` + ``StragglerMonitor``, with an identity-keyed shadow
  oracle proving detector/injector state maps to the right workers across
  consecutive rescales;
* :mod:`.serve_model` — paged-KV admission over ``PagePool`` + the real
  ``Scheduler``, proving leak-freedom, no stale slot occupancy, and that
  reservation-gated admission never strands an admitted request; plus
  ``ServeFaultModel``, the fault-tolerant delivery protocol (replica death,
  retry, hedging, paged preemption) proving no request is lost, none is
  delivered twice, and preempted state restores exactly; and
  ``replay_on_engines``, which holds the host-side engine twin to real
  paged ``ServeEngine`` instances action by action.

:mod:`.explorer` is the generic engine: BFS over canonical fingerprints,
invariant callbacks on every state, deadlock detection, shortest
counterexamples delta-shrunk to replayable ``kind@step:spec`` scripts.
``python -m repro_torch.analysis --target protocol`` runs all models.
"""

from repro_torch.analysis.protocol.elastic_model import ElasticModel, ElasticState
from repro_torch.analysis.protocol.explorer import (
    ExploreResult,
    Violation,
    explore,
    format_script,
    parse_script,
    replay,
    shrink,
)
from repro_torch.analysis.protocol.serve_model import (
    ServeFaultModel,
    ServeFaultState,
    ServeModel,
    ServeState,
    engine_kwargs,
    leaf_scripts,
    replay_on_engines,
    solo_tokens,
)

__all__ = [
    "ElasticModel",
    "ElasticState",
    "ServeModel",
    "ServeState",
    "ServeFaultModel",
    "ServeFaultState",
    "ExploreResult",
    "Violation",
    "explore",
    "replay",
    "shrink",
    "format_script",
    "parse_script",
    "engine_kwargs",
    "leaf_scripts",
    "replay_on_engines",
    "solo_tokens",
]
