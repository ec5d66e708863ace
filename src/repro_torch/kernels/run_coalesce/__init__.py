from .ops import run_coalesce
from .ref import run_coalesce_ref

__all__ = ["run_coalesce", "run_coalesce_ref"]
