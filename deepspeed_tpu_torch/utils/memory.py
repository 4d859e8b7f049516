"""Memory reporting (counterpart of ``deepspeed_tpu/utils/memory.py``;
reference ``runtime/utils.py:725,775``, ``memory_status`` /
``see_memory_usage``: the debugging helpers training scripts call).

On a card the numbers come from ``torch.cuda.memory_stats`` (the caching
allocator: allocated now and at peak, reserved) and ``mem_get_info`` (the
card's total); on the CPU the device half is the host's.  The host's peak
RSS comes from the resource module either way.
"""
from __future__ import annotations

import resource
import sys
from typing import Dict, Optional

import torch

from .logging import logger

_GB = 1024 ** 3


def _host_peak_rss_gb() -> float:
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # linux reports KB; darwin reports bytes
    return rss / (1024 ** 3 if sys.platform == "darwin" else 1024 ** 2)


def _device_stats() -> Optional[Dict[str, float]]:
    """GB allocated now and at peak, reserved, and the card's total; None
    without an initialised card."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    stats = torch.cuda.memory_stats()
    _, total = torch.cuda.mem_get_info()
    return {"in_use_gb": stats.get("allocated_bytes.all.current", 0) / _GB,
            "peak_gb": stats.get("allocated_bytes.all.peak", 0) / _GB,
            "reserved_gb": stats.get("reserved_bytes.all.current", 0) / _GB,
            "limit_gb": total / _GB}


def see_memory_usage(message: str, force: bool = False) -> Optional[Dict]:
    """Log device and host memory (reference ``see_memory_usage``).  Like
    the reference, silent unless ``force`` (scripts gate it on a debug
    flag).  Returns the numbers as a dict."""
    if not force:
        return None
    device = _device_stats()
    host_rss_gb = _host_peak_rss_gb()
    if device is not None:
        logger.info(f"{message} | device MA {device['in_use_gb']:.2f} GB, "
                    f"peak {device['peak_gb']:.2f} GB, reserved "
                    f"{device['reserved_gb']:.2f} GB, limit "
                    f"{device['limit_gb']:.2f} GB | host peak RSS "
                    f"{host_rss_gb:.2f} GB")
    else:
        logger.info(f"{message} | no card in use | host peak RSS "
                    f"{host_rss_gb:.2f} GB")
    return {"device": device, "host_peak_rss_gb": host_rss_gb}


def memory_status(msg: str, print_rank: int = -1,
                  reset_max: bool = False) -> Optional[Dict]:
    """Reference ``memory_status``: the device memory on ``print_rank``
    (every rank when negative); ``reset_max`` starts the peak again after
    the reading."""
    if print_rank >= 0:
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_initialized() else 0
        if rank != print_rank:
            return None
    out = see_memory_usage(f"memory_status: {msg}", force=True)
    if reset_max and out["device"] is not None:
        torch.cuda.reset_peak_memory_stats()
    return out


__all__ = ["see_memory_usage", "memory_status"]
