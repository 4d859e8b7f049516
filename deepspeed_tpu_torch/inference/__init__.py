from .config import DeepSpeedInferenceConfig
from .engine import InferenceEngine
from .sampling import SamplingParams
from .serving import Request, RequestResult, ServingEngine

__all__ = ["DeepSpeedInferenceConfig", "InferenceEngine", "SamplingParams",
           "Request", "RequestResult", "ServingEngine"]
