from .backends import (BACKENDS, BsrSweepBackend, DenseSweepBackend,
                       ShardedSweepBackend, SweepBackend, SweepBatch,
                       make_backend, select_backend, shared_mesh)
from .kvquant import (dequantize_kv, init_quant_cache, quant_decode_attention,
                      quantize_kv, update_quant_cache)
from .pipeline import PipelineJob, ServePipeline
from .plans import (BsrPlan, DensePlan, PlanCache, ShardedPlan, SweepPlan,
                    structure_key, topology_key)
from .queue import QueueTicket, RankQueue
from .rank_service import QueryResult, RankService, RankServiceConfig
from .spill import CacheSpill, PlanSpill
from .telemetry import (Counter, Gauge, Histogram, MetricsRegistry,
                        StatsServer)

__all__ = [
    "dequantize_kv", "init_quant_cache", "quant_decode_attention",
    "quantize_kv", "update_quant_cache",
    "QueryResult", "RankService", "RankServiceConfig",
    "RankQueue", "QueueTicket", "CacheSpill", "PlanSpill",
    "ServePipeline", "PipelineJob",
    "BACKENDS", "SweepBackend", "SweepBatch", "DenseSweepBackend",
    "BsrSweepBackend", "ShardedSweepBackend", "make_backend",
    "select_backend", "shared_mesh",
    "SweepPlan", "DensePlan", "ShardedPlan", "BsrPlan", "PlanCache",
    "structure_key", "topology_key", "MetricsRegistry", "StatsServer", "Counter", "Gauge",
    "Histogram",
]
