from .builder import (BUILD_DIR, CSRC_DIR, KernelBuilder, KernelBuildError,
                      find_nvcc)
from .host import (ALL_HOST_OPS, AsyncIOBuilder, CPUAdamBuilder, HostBuildError,
                   HostOpBuilder, host_op)

__all__ = ["KernelBuilder", "KernelBuildError", "find_nvcc", "BUILD_DIR",
           "CSRC_DIR", "HostOpBuilder", "HostBuildError", "CPUAdamBuilder",
           "AsyncIOBuilder", "ALL_HOST_OPS", "host_op"]
