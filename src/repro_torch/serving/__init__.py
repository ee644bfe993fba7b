"""Batched serving engine of the port: the round scheduler over a
contiguous KV cache, with quantized-weight serving backed by a versioned
weight store. The public surface lives in :mod:`repro_torch.serving.api`."""
from repro_torch.serving.api import (Request, Completion,  # noqa: F401
                                     StagedInfo, SchedulerStats)
from repro_torch.serving.engine import ServeEngine, ServeConfig  # noqa: F401
from repro_torch.serving.kvcache import KVCache, ContiguousKVCache  # noqa: F401
from repro_torch.serving.scheduler import RoundScheduler  # noqa: F401
from repro_torch.serving.weights import (WeightStore,  # noqa: F401
                                         WeightVersion, make_weight_pipeline)
