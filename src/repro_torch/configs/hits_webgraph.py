"""The paper's own workload: accelerated-HITS power sweeps over web-scale
graphs, and the serving defaults ``launch.serve_rank`` reads (port of
``repro.configs.hits_webgraph``: the ``RankingConfig`` and its
``ArchSpec``)."""
import dataclasses

from .base import RANKING_SHAPES, ArchSpec


@dataclasses.dataclass(frozen=True)
class RankingConfig:
    name: str = "hits-webgraph"
    algorithm: str = "accel"      # "accel" | "hits"
    mode: str = "replicated"      # edge sharding strategy (see sparse.dist)
    dtype: str = "float32"
    # serving defaults (launch.serve_rank / serve.RankService):
    # sweep backend for the batched column sweep (see serve.backends)
    serve_backend: str = "auto"   # dense | sharded | bsr | auto
    serve_shard_mode: str = "dual_blocked"  # replicated | dual_blocked
    # plan cache (serve.plans.PlanCache): LRU of per-union-subgraph
    # structural layouts; <= 0 disables
    serve_plan_cache: int = 64
    # staged dispatch pipeline (serve.pipeline.ServePipeline): batches in
    # flight; 1 = serial, >= 2 overlaps host assemble/plan with the
    # previous batch's device sweep
    serve_pipeline_depth: int = 2
    # bsr: on-device convergence loop (one CUDA graph per batch)
    serve_bsr_fused: bool = True
    # precision ladder (serve.backends): bulk sweeps at this dtype then an
    # f64 polish to tol with a residual certificate; "" = single-phase
    serve_sweep_dtype: str = ""     # "" | bf16 | fp32 | f64
    serve_polish_tol: float = 0.0   # 0: polish to the configured tol
    # plan-time lumped sweep reduction (serve.plans.lump_batch)
    serve_lumping: str = "off"      # off | on | auto
    # rank-stability early exit: a column stops once its top-rank_k
    # authority ordering has held stable_sweeps sweeps; 0 = residual only
    serve_rank_k: int = 0
    serve_stable_sweeps: int = 2
    # async micro-batching frontend (serve.queue.RankQueue)
    serve_deadline_ms: float = 5.0  # max extra batching latency per request
    serve_queue_depth: int = 0      # distinct pending bound (0: 4*v_max)
    # SLA admission: classes >= shed_priority are best-effort (sheddable)
    serve_shed_priority: int = 1
    # restart-survivable cache and plan spill (serve.spill)
    serve_spill_dir: str = ""       # "": in-process cache only
    serve_spill_policy: str = "all"  # all | evict
    # spill generation GC: newest step_* generations kept per entry
    # stream (compacted at service init and on queue drain)
    serve_spill_keep_generations: int = 1
    # ops endpoint (serve.telemetry.StatsServer via launch.serve_rank):
    # loopback port for GET /healthz + /stats.json; 0 = ephemeral,
    # < 0 = disabled
    serve_stats_port: int = -1


CONFIG = RankingConfig()
SMOKE_CONFIG = RankingConfig(name="hits-webgraph-smoke")

SPEC = ArchSpec(
    arch_id="hits-webgraph", family="ranking", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=RANKING_SHAPES,
    notes="paper's QI-HITS/accelerated-HITS sweep as a multi-pod workload",
)
