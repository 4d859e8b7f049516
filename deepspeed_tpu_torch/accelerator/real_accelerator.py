"""Accelerator selection (reference ``accelerator/real_accelerator.py``).

``DS_ACCELERATOR`` picks explicitly; otherwise the accelerator is CUDA —
there is no silent fallback to the CPU when no card is present (the CUDA
accelerator raises at first use instead).
"""
from __future__ import annotations

import os
from typing import Optional

from .abstract_accelerator import DeepSpeedAccelerator

_accelerator: Optional[DeepSpeedAccelerator] = None

SUPPORTED = ("cuda", "cpu")


def _detect_name() -> str:
    override = os.environ.get("DS_ACCELERATOR")
    if override:
        if override not in SUPPORTED:
            raise ValueError(f"DS_ACCELERATOR={override!r} not in {SUPPORTED}")
        return override
    return "cuda"


def get_accelerator() -> DeepSpeedAccelerator:
    global _accelerator
    if _accelerator is None:
        if _detect_name() == "cuda":
            from .cuda_accelerator import CUDA_Accelerator

            _accelerator = CUDA_Accelerator()
        else:
            from .cpu_accelerator import CPU_Accelerator

            _accelerator = CPU_Accelerator()
    return _accelerator


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` when the caller names
    one, else the accelerator's (CUDA unless ``DS_ACCELERATOR=cpu``).
    A CUDA device without a card raises; nothing falls back to the CPU."""
    import torch

    dev = torch.device(device if device is not None
                       else get_accelerator().device_name())
    if dev.type == "cuda":
        from .cuda_accelerator import require_cuda

        require_cuda()
    return dev
