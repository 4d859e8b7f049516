from .abstract_accelerator import DeepSpeedAccelerator
from .real_accelerator import get_accelerator, resolve_device

__all__ = ["DeepSpeedAccelerator", "get_accelerator", "resolve_device"]
