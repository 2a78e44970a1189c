from .backends import (BACKENDS, BsrSweepBackend, DenseSweepBackend,
                       SweepBackend, SweepBatch, make_backend, select_backend)
from .pipeline import PipelineJob, ServePipeline
from .plans import (BsrPlan, DensePlan, PlanCache, SweepPlan, structure_key,
                    topology_key)
from .rank_service import QueryResult, RankService, RankServiceConfig
from .telemetry import Counter, Gauge, Histogram, MetricsRegistry

__all__ = [
    "QueryResult", "RankService", "RankServiceConfig",
    "ServePipeline", "PipelineJob",
    "BACKENDS", "SweepBackend", "SweepBatch", "DenseSweepBackend",
    "BsrSweepBackend", "make_backend", "select_backend",
    "SweepPlan", "DensePlan", "BsrPlan", "PlanCache", "structure_key",
    "topology_key", "MetricsRegistry", "Counter", "Gauge", "Histogram",
]
