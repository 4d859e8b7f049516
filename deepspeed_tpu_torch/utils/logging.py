"""Rank-aware logging utilities (reference ``deepspeed/utils/logging.py``):
a ``logger`` singleton plus ``log_dist``, which emits only on the listed
ranks.  The rank is ``torch.distributed.get_rank()`` once a process group
exists, else the launcher's ``RANK`` environment variable."""
from __future__ import annotations

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


@functools.lru_cache(None)
def _create_logger(name: str = "deepspeed_tpu_torch",
                   level: int = logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    handler = logging.StreamHandler(stream=sys.stderr)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S"))
    lg.addHandler(handler)
    return lg


_default_level = LOG_LEVELS.get(
    os.environ.get("DS_TPU_LOG_LEVEL", "info").lower(), logging.INFO)
logger = _create_logger(level=_default_level)


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0") or 0)


def should_log_on(ranks=None) -> bool:
    """True when the current process should emit for the given rank filter."""
    if ranks is None:
        return True
    return _process_index() in ranks or (-1 in ranks)


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the listed process ranks (None / [-1] => all)."""
    if should_log_on(ranks):
        logger.log(level, f"[Rank {_process_index()}] {message}")
