"""paddle.inference serving stack, PyTorch port (counterpart of
paddle_tpu/inference): the names below are the ported parts."""
from .moe_serving import MoeServingCore, moe_capacity  # noqa: F401
from .paged_cache import (BlockAllocator, BlockOOM,  # noqa: F401
                          PagedKVCache, PagedLayerCache, PagedPrefillView,
                          PagedRaggedView, chain_block_hashes, chain_hash)
from .resilience import (CrashInjector, EngineCrash,  # noqa: F401
                         FaultInjector, RequestOutcome)
from .scheduler import (DEFAULT_TENANT,  # noqa: F401
                        MIN_PREFILL_SUFFIX_ROWS, PagedRequest,
                        PagedServingEngine, Tenant, chunked_prefill)
from .serving import (ContinuousBatchingEngine,  # noqa: F401
                      ParallelStats, PrefillStats, PrefixCacheStats,
                      ResilienceStats, SpecDecodeStats, TenantStats)
from .speculative import (SpeculativeEngine,  # noqa: F401
                          TokenServingModel, branch_lane_seed,
                          logit_mask_fn, register_logit_mask)
from .telemetry import MetricsRegistry, StatsBase  # noqa: F401

__all__ = ["BlockAllocator", "BlockOOM", "ContinuousBatchingEngine",
           "CrashInjector", "DEFAULT_TENANT", "EngineCrash",
           "FaultInjector", "MetricsRegistry", "MIN_PREFILL_SUFFIX_ROWS",
           "MoeServingCore",
           "PagedKVCache", "PagedLayerCache", "PagedPrefillView",
           "PagedRaggedView", "PagedRequest", "PagedServingEngine",
           "ParallelStats", "PrefillStats", "PrefixCacheStats",
           "RequestOutcome", "ResilienceStats", "SpecDecodeStats",
           "SpeculativeEngine", "StatsBase", "Tenant", "TenantStats",
           "TokenServingModel", "branch_lane_seed", "chain_block_hashes",
           "chain_hash", "chunked_prefill", "logit_mask_fn",
           "moe_capacity", "register_logit_mask"]
