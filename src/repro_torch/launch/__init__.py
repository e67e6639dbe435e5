from .batching import (BatchSpec, ContinuousBatcher, PagedKVPool, Request,
                       RequestResult, poisson_trace, sequential_slot_steps)
from .engine import GenerationEngine, fetch_telemetry

__all__ = ["BatchSpec", "ContinuousBatcher", "GenerationEngine",
           "PagedKVPool", "Request", "RequestResult", "fetch_telemetry",
           "poisson_trace", "sequential_slot_steps"]
