"""Inference config (reference ``deepspeed/inference/config.py:127``
``DeepSpeedInferenceConfig``; counterpart of ``deepspeed_tpu/inference/config.py``)
as dataclasses.  Same keys, aliases and dtype spellings as the JAX package;
knobs kept only for config compatibility are accepted and ignored."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch

from ..runtime.config_utils import check_min, config_from_dict

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "half": torch.float16, "float32": torch.float32,
           "fp32": torch.float32}


@dataclasses.dataclass
class DeepSpeedTPConfig:
    """tensor_parallel block (reference config.py:33)."""
    enabled: bool = True
    tp_size: int = 1

    def __post_init__(self):
        check_min("tensor_parallel.tp_size", self.tp_size, 1)


@dataclasses.dataclass
class DeepSpeedMoEConfig:
    enabled: bool = True
    ep_size: int = 1
    moe_experts: list = dataclasses.field(default_factory=lambda: [1])

    def __post_init__(self):
        check_min("moe.ep_size", self.ep_size, 1)


@dataclasses.dataclass
class QuantizationConfig:
    enabled: bool = False
    num_bits: int = 8


@dataclasses.dataclass
class DeepSpeedInferenceConfig:
    dtype: str = "bfloat16"
    tensor_parallel: DeepSpeedTPConfig = dataclasses.field(
        default_factory=DeepSpeedTPConfig, metadata={"alias": "tp"})
    moe: DeepSpeedMoEConfig = dataclasses.field(default_factory=DeepSpeedMoEConfig)
    quant: QuantizationConfig = dataclasses.field(default_factory=QuantizationConfig)
    checkpoint: Optional[str] = None
    replace_with_kernel_inject: bool = False
    injection_policy: Optional[Dict[Any, Any]] = None
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    max_tokens: int = 1024
    enable_cuda_graph: bool = False   # accepted for compatibility, ignored
    replace_method: str = "auto"
    use_flash_decode: Optional[bool] = None   # retired knob, ignored
    zero: Dict[str, Any] = dataclasses.field(default_factory=dict)
    triangular_masking: bool = True
    return_tuple: bool = True

    def __post_init__(self):
        if str(self.dtype) not in _DTYPES and str(self.dtype) != "int8":
            raise ValueError(f"dtype={self.dtype!r} not in {sorted(_DTYPES)} "
                             "or 'int8'")
        check_min("max_out_tokens", self.max_out_tokens, 1)
        check_min("min_out_tokens", self.min_out_tokens, 1)

    @classmethod
    def from_dict(cls, data: Optional[Mapping[str, Any]] = None
                  ) -> "DeepSpeedInferenceConfig":
        return config_from_dict(cls, data or {})

    @property
    def weights_quantized(self) -> bool:
        """dtype "int8" means weight-only quantization, as does the quant
        block — one property so loader and engine agree."""
        return bool(self.quant.enabled or str(self.dtype) == "int8")

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.int8 if str(self.dtype) == "int8" else _DTYPES[str(self.dtype)]

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        """Activation and dequant dtype: int8 storage computes in bf16; any
        other configured dtype is honoured (quant.enabled with fp32 runs
        fp32)."""
        d = self.torch_dtype
        return torch.bfloat16 if d == torch.int8 else d
