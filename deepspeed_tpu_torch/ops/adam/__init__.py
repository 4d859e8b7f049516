from .cpu_adam import DeepSpeedCPUAdam

__all__ = ["DeepSpeedCPUAdam"]
