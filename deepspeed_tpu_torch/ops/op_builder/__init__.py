from .builder import (BUILD_DIR, CSRC_DIR, KernelBuilder, KernelBuildError,
                      find_nvcc)

__all__ = ["KernelBuilder", "KernelBuildError", "find_nvcc", "BUILD_DIR",
           "CSRC_DIR"]
