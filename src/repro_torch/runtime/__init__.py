"""The elastic training runtime: membership, timing sources, and the driver.

``elastic`` and ``monitor`` are numpy-only copies of the reference's
modules of the same names; ``driver`` is the port of its ``ElasticTrainer``
(PyTorch), loaded lazily so the numpy-only parts import without torch's
model stack.
"""

from repro_torch.runtime.elastic import (
    ElasticCoordinator,
    FailureDetector,
    MembershipEvent,
    RescalePlan,
    parse_events,
    validate_schedule,
)
from repro_torch.runtime.monitor import (
    MeasuredTimingSource,
    SimulatedTimingSource,
    StragglerMonitor,
    TimingSource,
)

__all__ = [
    "DriverConfig",
    "ElasticTrainer",
    "ElasticCoordinator",
    "FailureDetector",
    "MembershipEvent",
    "RescalePlan",
    "parse_events",
    "validate_schedule",
    "MeasuredTimingSource",
    "SimulatedTimingSource",
    "StragglerMonitor",
    "TimingSource",
]


def __getattr__(name):
    if name in ("DriverConfig", "ElasticTrainer"):
        from repro_torch.runtime import driver

        return getattr(driver, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
