from .config import DeepSpeedInferenceConfig
from .engine import InferenceEngine
from .sampling import SamplingParams

__all__ = ["DeepSpeedInferenceConfig", "InferenceEngine", "SamplingParams"]
