from .logging import MetricsLogger, rank0_print
from .prefetch import map_prefetch, prefetch_iter
from .profiling import phase_timer, trace_profile

__all__ = ["MetricsLogger", "rank0_print", "map_prefetch", "prefetch_iter",
           "phase_timer", "trace_profile"]
