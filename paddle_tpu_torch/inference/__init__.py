"""paddle.inference serving stack, PyTorch port (counterpart of
paddle_tpu/inference): the names below are the ported parts."""
from .accounting import CostLedger, WASTE_CAUSES, WorkModel  # noqa: F401
from .monitor import (Alert, HealthMonitor, HealthReport,  # noqa: F401
                      SeriesBuffer, SloPolicy, SloTracker)
from .moe_serving import MoeServingCore, moe_capacity  # noqa: F401
from .paged_cache import (BlockAllocator, BlockOOM,  # noqa: F401
                          PagedKVCache, PagedLayerCache, PagedPrefillView,
                          PagedRaggedView, chain_block_hashes, chain_hash)
from .recovery import (SNAPSHOT_VERSION,  # noqa: F401
                       RecoverableServer, RecoveryError, RequestJournal,
                       SnapshotVersionError, load_snapshot, read_journal,
                       save_snapshot)
from .resilience import (CrashInjector, EngineCrash,  # noqa: F401
                         FaultInjector, NetworkFaultInjector,
                         RequestOutcome, RouterFaultInjector)
from .scheduler import (DEFAULT_TENANT,  # noqa: F401
                        MIN_PREFILL_SUFFIX_ROWS, PagedRequest,
                        PagedServingEngine, Tenant, chunked_prefill)
from .serving import (ContinuousBatchingEngine,  # noqa: F401
                      ParallelStats, PrefillStats, PrefixCacheStats,
                      ResilienceStats, ShardedServingCore,
                      SpecDecodeStats, TenantStats)
from .speculative import (SpeculativeEngine,  # noqa: F401
                          TokenServingModel, branch_lane_seed,
                          logit_mask_fn, register_logit_mask)
from .telemetry import (MetricsRegistry, NetStats,  # noqa: F401
                        StatsBase, TraceCollector)
from .router import (EngineWorker, InProcWorker,  # noqa: F401
                     PipeWorker, Router, RouterStats, WorkerDied,
                     WorkerError, WorkerTimeout,
                     build_model_from_spec, build_server_from_spec,
                     token_chain_hashes)
from .net import (ReplyCache, ResilientTransport,  # noqa: F401
                  SocketHost)
from .fleet import (FleetSupervisor, MigrationPolicy,  # noqa: F401
                    SocketWorker)

__all__ = ["Alert", "BlockAllocator", "BlockOOM",
           "ContinuousBatchingEngine", "CostLedger", "CrashInjector",
           "DEFAULT_TENANT", "EngineCrash", "FaultInjector",
           "HealthMonitor", "HealthReport", "MetricsRegistry",
           "MIN_PREFILL_SUFFIX_ROWS", "MoeServingCore", "NetStats",
           "PagedKVCache", "PagedLayerCache", "PagedPrefillView",
           "PagedRaggedView", "PagedRequest", "PagedServingEngine",
           "ParallelStats", "PrefillStats", "PrefixCacheStats",
           "RecoverableServer", "RecoveryError", "RequestJournal",
           "RequestOutcome", "ResilienceStats", "SNAPSHOT_VERSION",
           "SeriesBuffer", "ShardedServingCore", "SloPolicy",
           "SloTracker",
           "SnapshotVersionError", "SpecDecodeStats", "SpeculativeEngine",
           "StatsBase", "Tenant", "TenantStats", "TokenServingModel",
           "TraceCollector", "WASTE_CAUSES", "WorkModel",
           "branch_lane_seed", "chain_block_hashes", "chain_hash",
           "chunked_prefill", "load_snapshot", "logit_mask_fn",
           "moe_capacity", "read_journal", "register_logit_mask",
           "save_snapshot",
           "EngineWorker", "InProcWorker", "PipeWorker", "Router",
           "RouterFaultInjector", "RouterStats", "WorkerDied",
           "WorkerError", "WorkerTimeout", "build_model_from_spec",
           "build_server_from_spec", "token_chain_hashes",
           "FleetSupervisor", "MigrationPolicy", "SocketWorker",
           "NetworkFaultInjector", "ReplyCache", "ResilientTransport",
           "SocketHost"]
