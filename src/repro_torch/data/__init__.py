"""Data pipeline of the port (port of `repro.data`): the deterministic
synthetic LM stream and its loaders, numpy on the host."""
from .synthetic import SyntheticLM, make_batch_specs
from .loader import Prefetcher, ShardedLoader

__all__ = ["SyntheticLM", "make_batch_specs", "Prefetcher", "ShardedLoader"]
