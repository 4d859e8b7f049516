"""DeepSpeedCPUAdam: the host-side SIMD Adam of ZeRO-Offload (counterpart
of ``deepspeed_tpu/ops/adam/cpu_adam.py``; reference
``deepspeed/ops/adam/cpu_adam.py``).

The native step (``ops/csrc/cpu_adam.cpp``, OpenMP + SIMD, built by
``op_builder.CPUAdamBuilder``) updates fp32 masters and both moments in one
fused pass over host memory and can write the bf16 view in the same sweep.
Buffers are contiguous fp32 numpy arrays or CPU torch tensors (the bf16
view: uint16 or ``torch.bfloat16``), bound through ``ctypes`` by address.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..op_builder.host import CPUAdamBuilder, host_op

_F = ctypes.POINTER(ctypes.c_float)
_U16 = ctypes.POINTER(ctypes.c_uint16)


def _addr(a, what: str, dtypes) -> int:
    """Address of a contiguous host buffer (numpy or CPU torch)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu" or not a.is_contiguous() or a.dtype not in dtypes[1]:
            raise TypeError(f"{what} must be a contiguous CPU tensor of "
                            f"{dtypes[1]}, got {a.dtype} on {a.device}")
        return a.data_ptr()
    if a.dtype not in dtypes[0] or not a.flags["C_CONTIGUOUS"]:
        raise TypeError(f"{what} must be contiguous {dtypes[0]}")
    return a.ctypes.data


_F32 = ((np.dtype(np.float32),), (torch.float32,))
_B16 = ((np.dtype(np.uint16),), (torch.bfloat16, torch.int16))


def _size(a) -> int:
    return a.numel() if isinstance(a, torch.Tensor) else a.size


class DeepSpeedCPUAdam:
    """Adam/AdamW over host buffers via the native kernel."""

    def __init__(self, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 adamw_mode: bool = True, bias_correction: bool = True):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self.step_count = 0
        self._lib = host_op(CPUAdamBuilder)

    @property
    def num_threads(self) -> int:
        """The OpenMP team a step runs on."""
        return int(self._lib.cpu_adam_num_threads())

    def step_flat(self, params, grads, exp_avg, exp_avg_sq,
                  step: Optional[int] = None, bf16_out=None,
                  lr: Optional[float] = None) -> None:
        """In-place Adam step on contiguous fp32 buffers of equal length."""
        ptrs = [_addr(a, name, _F32) for name, a in (
            ("params", params), ("grads", grads), ("exp_avg", exp_avg),
            ("exp_avg_sq", exp_avg_sq))]
        n = _size(params)
        if not (_size(grads) == _size(exp_avg) == _size(exp_avg_sq) == n):
            raise ValueError("buffer sizes differ")
        out = None
        if bf16_out is not None:
            if _size(bf16_out) != n:
                raise TypeError("bf16_out must have the params' size")
            out = ctypes.cast(_addr(bf16_out, "bf16_out", _B16), _U16)
        self._lib.cpu_adam_step(
            *(ctypes.cast(p, _F) for p in ptrs), n,
            np.float32(lr if lr is not None else self.lr),
            np.float32(self.betas[0]), np.float32(self.betas[1]),
            np.float32(self.eps), np.float32(self.weight_decay),
            int(self.adamw_mode), int(self.bias_correction),
            int(step if step is not None else self.step_count), out)

    def l2_norm(self, flat) -> float:
        """The L2 norm of one contiguous fp32 buffer."""
        return float(self._lib.cpu_l2_norm(ctypes.cast(_addr(flat, "x", _F32), _F),
                                           _size(flat)))
