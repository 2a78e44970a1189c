from .backends import (BACKENDS, BsrSweepBackend, DenseSweepBackend,
                       SweepBackend, SweepBatch, make_backend, select_backend)
from .pipeline import PipelineJob, ServePipeline
from .plans import (BsrPlan, DensePlan, PlanCache, SweepPlan, structure_key,
                    topology_key)
from .queue import QueueTicket, RankQueue
from .rank_service import QueryResult, RankService, RankServiceConfig
from .spill import CacheSpill, PlanSpill
from .telemetry import (Counter, Gauge, Histogram, MetricsRegistry,
                        StatsServer)

__all__ = [
    "QueryResult", "RankService", "RankServiceConfig",
    "RankQueue", "QueueTicket", "CacheSpill", "PlanSpill",
    "ServePipeline", "PipelineJob",
    "BACKENDS", "SweepBackend", "SweepBatch", "DenseSweepBackend",
    "BsrSweepBackend", "make_backend", "select_backend",
    "SweepPlan", "DensePlan", "BsrPlan", "PlanCache", "structure_key",
    "topology_key", "MetricsRegistry", "StatsServer", "Counter", "Gauge",
    "Histogram",
]
