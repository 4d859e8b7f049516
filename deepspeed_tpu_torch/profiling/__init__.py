"""Profiling (counterpart of ``deepspeed_tpu/profiling/``): the flops
profiler; the wall-clock breakdown lives in ``utils/timer.py``."""
from .flops_profiler import (FlopsProfiler, get_detailed_profile,
                             get_model_profile)

__all__ = ["FlopsProfiler", "get_model_profile", "get_detailed_profile"]
