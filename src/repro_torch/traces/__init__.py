"""Trace-driven scenarios + fault injection (see ``schema``/``faults``/``campaign``).

The port's copy of ``repro.traces``, the serving fault campaign
(``serve_campaign``, over the port's router) included.
"""

from repro_torch.traces.faults import (
    FaultEvent,
    FaultInjector,
    FaultyReplicaClock,
    FaultyTimingSource,
    faults_spec,
    parse_faults,
    sample_faults,
)
from repro_torch.traces.schema import (
    Trace,
    TraceMachine,
    TraceTask,
    bundled_trace,
    bundled_trace_path,
    load_trace,
    save_trace,
    to_events,
    to_fleet,
    to_requests,
)

__all__ = [
    "Trace",
    "TraceMachine",
    "TraceTask",
    "load_trace",
    "save_trace",
    "bundled_trace",
    "bundled_trace_path",
    "to_requests",
    "to_fleet",
    "to_events",
    "FaultEvent",
    "FaultInjector",
    "FaultyReplicaClock",
    "FaultyTimingSource",
    "parse_faults",
    "faults_spec",
    "sample_faults",
    "CampaignConfig",
    "run_campaign",
    "run_trial",
    "scenario_faults",
    "ServeCampaignConfig",
    "run_serve_campaign",
    "run_serve_trial",
    "serve_scenario_faults",
    "TraceSynthConfig",
    "synthesize_trace",
]


def __getattr__(name):
    # campaign pulls in the torch-backed driver and synth is CLI-oriented;
    # loading them lazily keeps `from repro_torch.traces import parse_faults`-class
    # imports numpy-light (mirrors repro_torch.runtime's lazy driver).
    if name in ("CampaignConfig", "run_campaign", "run_trial", "scenario_faults"):
        from repro_torch.traces import campaign

        return getattr(campaign, name)
    if name in (
        "ServeCampaignConfig",
        "run_serve_campaign",
        "run_serve_trial",
        "serve_scenario_faults",
    ):
        from repro_torch.traces import serve_campaign

        return getattr(serve_campaign, name)
    if name in ("TraceSynthConfig", "synthesize_trace"):
        from repro_torch.traces import synth

        return getattr(synth, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
