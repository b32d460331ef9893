from .engine import PagedKVCache, ServingConfig, ServingEngine

__all__ = ["PagedKVCache", "ServingConfig", "ServingEngine"]
