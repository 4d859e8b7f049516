"""Autotuning (counterpart of ``deepspeed_tpu/autotuning/``; reference
``deepspeed/autotuning/``): config-space search with memory screening and
timed trials."""
from .autotuner import (  # noqa: F401
    Autotuner,
    AutotuningConfig,
    TrialRecord,
    autotune,
)
