"""CUDA accelerator (reference ``accelerator/cuda_accelerator.py``).

Devices are ``cuda:<i>``, timing uses CUDA events, collectives go through
NCCL.  Every method that touches the card raises when no card is present
rather than answering for the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .abstract_accelerator import DeepSpeedAccelerator


def require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host")


class CUDA_Accelerator(DeepSpeedAccelerator):
    def __init__(self):
        super().__init__()
        self._name = "cuda"
        self._communication_backend_name = "nccl"

    def device_name(self, device_index: Optional[int] = None) -> str:
        return "cuda" if device_index is None else f"cuda:{device_index}"

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def synchronize(self, device_index: Optional[int] = None) -> None:
        require_cuda()
        torch.cuda.synchronize(device_index)

    def memory_stats(self, device_index: Optional[int] = None) -> Dict[str, int]:
        require_cuda()
        idx = torch.cuda.current_device() if device_index is None else device_index
        free, total = torch.cuda.mem_get_info(idx)
        return {"bytes_limit": int(total),
                "bytes_in_use": int(total - free),
                "allocated": int(torch.cuda.memory_allocated(idx)),
                "peak_allocated": int(torch.cuda.max_memory_allocated(idx))}

    def event(self, enable_timing: bool = True):
        require_cuda()
        return torch.cuda.Event(enable_timing=enable_timing)

    def is_bf16_supported(self) -> bool:
        return torch.cuda.is_available() and torch.cuda.is_bf16_supported()

    def is_fp16_supported(self) -> bool:
        return torch.cuda.is_available()
