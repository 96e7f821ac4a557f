"""Serving on the port: the continuous-batching engine, the paged KV block
manager, the scheduler and request synthesis (the traffic router and its
allocation controller join in a later slice)."""

from repro_torch.serve.engine import ServeEngine, bucket_len
from repro_torch.serve.paged import PagedLayout, PagePool
from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig, serve_loop, summarize
from repro_torch.serve.workload import WorkloadConfig, from_trace, synthesize

__all__ = [
    "PagePool",
    "PagedLayout",
    "ServeEngine",
    "bucket_len",
    "Request",
    "Scheduler",
    "SchedulerConfig",
    "serve_loop",
    "summarize",
    "WorkloadConfig",
    "from_trace",
    "synthesize",
]
