from .adapters import AdapterRegistry, UnknownAdapter
from .config import DeepSpeedInferenceConfig
from .engine import InferenceEngine
from .sampling import SamplingParams
from .serving import (PoolConsumedError, Request, RequestResult, ServeTimeout,
                      ServingEngine, SlotPrefillError)
from .serving_supervisor import RestartBudgetExhausted, ServingSupervisor
from .speculative import SpeculativeConfig, layer_skip_draft, perturbed_draft

__all__ = ["AdapterRegistry", "UnknownAdapter", "DeepSpeedInferenceConfig",
           "InferenceEngine", "SamplingParams", "PoolConsumedError", "Request",
           "RequestResult", "ServeTimeout", "ServingEngine", "SlotPrefillError",
           "RestartBudgetExhausted", "ServingSupervisor", "SpeculativeConfig",
           "layer_skip_draft", "perturbed_draft"]
