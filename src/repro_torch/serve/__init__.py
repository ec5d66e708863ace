from .engine import Request, ServeEngine
from .paged_cache import PagedKVCacheManager

__all__ = ["Request", "ServeEngine", "PagedKVCacheManager"]
