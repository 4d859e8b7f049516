"""Accelerator abstraction (L0).

PyTorch counterpart of ``deepspeed_tpu/accelerator/abstract_accelerator.py``:
the seam every layer above talks to instead of ``torch.cuda`` directly —
device selection, synchronisation, memory stats, timing events, dtype support
and the communication backend name.
"""
from __future__ import annotations

import abc
from typing import Dict, Optional

import torch


class DeepSpeedAccelerator(abc.ABC):
    """Device abstraction seam (reference accelerator/abstract_accelerator.py:10)."""

    def __init__(self):
        self._name: Optional[str] = None
        self._communication_backend_name: Optional[str] = None

    # --- device management ---
    @abc.abstractmethod
    def device_name(self, device_index: Optional[int] = None) -> str:
        ...

    def device(self, device_index: Optional[int] = None) -> torch.device:
        return torch.device(self.device_name(device_index))

    @abc.abstractmethod
    def device_count(self) -> int:
        ...

    @abc.abstractmethod
    def synchronize(self, device_index: Optional[int] = None) -> None:
        ...

    # --- memory ---
    @abc.abstractmethod
    def memory_stats(self, device_index: Optional[int] = None) -> Dict[str, int]:
        ...

    # --- timing ---
    @abc.abstractmethod
    def event(self, enable_timing: bool = True):
        """An event with ``record()``, ``synchronize()`` and
        ``elapsed_time(other)`` in milliseconds."""

    # --- dtype support ---
    @abc.abstractmethod
    def is_bf16_supported(self) -> bool:
        ...

    @abc.abstractmethod
    def is_fp16_supported(self) -> bool:
        ...

    # --- comms ---
    def communication_backend_name(self) -> str:
        assert self._communication_backend_name is not None
        return self._communication_backend_name

    # --- identity ---
    def name(self) -> str:
        assert self._name is not None
        return self._name

    def is_available(self) -> bool:
        return self.device_count() > 0
