"""Serving on the port: the continuous-batching engine, the paged KV block
manager, the scheduler, request synthesis, and the traffic router that
feeds measured per-replica speeds to the paper's allocation controller."""

from repro_torch.serve.engine import ServeEngine, bucket_len
from repro_torch.serve.paged import PagedLayout, PagePool
from repro_torch.serve.router import EngineReplica, ModelReplica, RouterConfig, TrafficRouter, run_router
from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig, serve_loop, summarize
from repro_torch.serve.workload import WorkloadConfig, from_trace, synthesize

__all__ = [
    "PagePool",
    "PagedLayout",
    "ServeEngine",
    "bucket_len",
    "EngineReplica",
    "ModelReplica",
    "RouterConfig",
    "TrafficRouter",
    "run_router",
    "Request",
    "Scheduler",
    "SchedulerConfig",
    "serve_loop",
    "summarize",
    "WorkloadConfig",
    "from_trace",
    "synthesize",
]
