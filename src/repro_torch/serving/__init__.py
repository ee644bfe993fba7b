"""Serving engine of the port: the round and continuous schedulers over
contiguous or paged KV caches (optionally int8), with quantized-weight
serving backed by a versioned weight store. The public surface lives in
:mod:`repro_torch.serving.api`."""
from repro_torch.serving.api import (Request, Completion,  # noqa: F401
                                     StagedInfo, SchedulerStats)
from repro_torch.serving.engine import ServeEngine, ServeConfig  # noqa: F401
from repro_torch.serving.kvcache import (KVCache,  # noqa: F401
                                         ContiguousKVCache, PagedKVCache)
from repro_torch.serving.scheduler import (RoundScheduler,  # noqa: F401
                                           ContinuousScheduler)
from repro_torch.serving.weights import (WeightStore,  # noqa: F401
                                         WeightVersion, make_weight_pipeline)
