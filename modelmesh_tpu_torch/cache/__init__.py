"""Per-instance weighted timestamp-LRU cache (clhm equivalent); the port's
copy of the JAX package's ``cache/``."""

from modelmesh_tpu_torch.cache.lru import EvictionListener, WeightedLRUCache, now_ms

__all__ = ["EvictionListener", "WeightedLRUCache", "now_ms"]
