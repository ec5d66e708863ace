from .ops import page_gather
from .ref import page_gather_ref

__all__ = ["page_gather", "page_gather_ref"]
