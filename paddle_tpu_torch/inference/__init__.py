"""paddle.inference serving stack, PyTorch port (counterpart of
paddle_tpu/inference): the names below are the ported parts."""
from .paged_cache import (BlockAllocator, BlockOOM,  # noqa: F401
                          PagedKVCache, PagedLayerCache, PagedPrefillView,
                          PagedRaggedView)
from .resilience import EngineCrash, RequestOutcome  # noqa: F401
from .scheduler import (MIN_PREFILL_SUFFIX_ROWS,  # noqa: F401
                        PagedRequest, PagedServingEngine, chunked_prefill)
from .serving import (ContinuousBatchingEngine,  # noqa: F401
                      ParallelStats, PrefillStats, PrefixCacheStats,
                      ResilienceStats, SpecDecodeStats, TenantStats)
from .speculative import SpeculativeEngine, TokenServingModel  # noqa: F401
from .telemetry import MetricsRegistry, StatsBase  # noqa: F401

__all__ = ["BlockAllocator", "BlockOOM", "ContinuousBatchingEngine",
           "EngineCrash", "MetricsRegistry", "MIN_PREFILL_SUFFIX_ROWS",
           "PagedKVCache", "PagedLayerCache", "PagedPrefillView",
           "PagedRaggedView", "PagedRequest", "PagedServingEngine",
           "ParallelStats", "PrefillStats", "PrefixCacheStats",
           "RequestOutcome", "ResilienceStats", "SpecDecodeStats",
           "SpeculativeEngine", "StatsBase", "TenantStats",
           "TokenServingModel", "chunked_prefill"]
