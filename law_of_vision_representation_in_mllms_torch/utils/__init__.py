from .logging import MetricsLogger, rank0_print
from .prefetch import map_prefetch, prefetch_iter

__all__ = ["MetricsLogger", "rank0_print", "map_prefetch", "prefetch_iter"]
