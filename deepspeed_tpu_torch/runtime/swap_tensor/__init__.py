"""Tensor swapping to NVMe (reference ``deepspeed/runtime/swap_tensor/``)."""
from .partitioned_optimizer_swapper import (HostAdamOptimizer,
                                            SwappedAdamOptimizer,
                                            TensorSwapper, aligned_empty)

__all__ = ["HostAdamOptimizer", "SwappedAdamOptimizer", "TensorSwapper",
           "aligned_empty"]
