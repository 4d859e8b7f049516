"""Process-wide compile counter (counterpart of
``deepspeed_tpu/utils/compile_counter.py``).

There is no XLA backend compile to listen to.  What the port counts is a
CUDA-graph capture (``inference/execution.py`` ``capture_graph``: the paged
decode step's graph, and the speculative draft and verify steps' graphs),
the analogue of a jitted step's first compile: a steady-state serving loop
replays and captures nothing.  Kernel builds are not counted.  Callers
snapshot ``count()`` before and after a section and diff, as with the JAX
package's counter.
"""
from __future__ import annotations

import threading
from typing import Callable

_COUNT = 0
_LOCK = threading.Lock()


def record_compile() -> None:
    """Count one CUDA-graph capture."""
    global _COUNT
    with _LOCK:
        _COUNT += 1


def compile_counter() -> Callable[[], int]:
    """A zero-argument ``count()`` of the captures so far; snapshot it
    before and after a section and diff."""
    return lambda: _COUNT
