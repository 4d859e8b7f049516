"""CPU accelerator (reference ``accelerator/cpu_accelerator.py``), used only
when asked for: ``DS_ACCELERATOR=cpu`` or ``device="cpu"``.  Collectives go
through gloo; events read the host clock."""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

from .abstract_accelerator import DeepSpeedAccelerator


class _HostEvent:
    """Host-clock stand-in for ``torch.cuda.Event`` (CPU work is synchronous)."""

    def __init__(self):
        self._t: Optional[float] = None

    def record(self, stream=None) -> None:
        self._t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end._t - self._t) * 1e3


class CPU_Accelerator(DeepSpeedAccelerator):
    def __init__(self):
        super().__init__()
        self._name = "cpu"
        self._communication_backend_name = "gloo"

    def device_name(self, device_index: Optional[int] = None) -> str:
        return "cpu"

    def device_count(self) -> int:
        return 1

    def synchronize(self, device_index: Optional[int] = None) -> None:
        pass

    def memory_stats(self, device_index: Optional[int] = None) -> Dict[str, int]:
        pages = os.sysconf("SC_PHYS_PAGES")
        avail = os.sysconf("SC_AVPHYS_PAGES")
        size = os.sysconf("SC_PAGE_SIZE")
        return {"bytes_limit": int(pages * size),
                "bytes_in_use": int((pages - avail) * size)}

    def event(self, enable_timing: bool = True):
        return _HostEvent()

    def is_bf16_supported(self) -> bool:
        return True

    def is_fp16_supported(self) -> bool:
        return True
