"""Checkpoint tooling (counterpart of ``deepspeed_tpu/checkpoint/``;
reference ``deepspeed/checkpoint/`` and ``deepspeed/utils/zero_to_fp32.py``):
offline fp32 consolidation (tensor- and ZeRO-sharded checkpoints alike),
inspection, restore-compatibility checks, and offline model-parallel
resharding into per-rank shard files (``reshard.py``)."""
from .universal import (CHECKPOINT_VERSION, checkpoint_info,
                        inspect_checkpoint, validate_checkpoint)
from .reshard import load_mp_shard, reshard_checkpoint, reshard_inference_checkpoint
from .zero_to_fp32 import (convert_zero_checkpoint_to_fp32_state_dict,
                           get_fp32_state_dict_from_zero_checkpoint,
                           load_fp32_state_dict,
                           load_state_dict_from_zero_checkpoint,
                           state_dict_to_params)

__all__ = ["CHECKPOINT_VERSION", "checkpoint_info", "inspect_checkpoint",
           "validate_checkpoint", "convert_zero_checkpoint_to_fp32_state_dict",
           "get_fp32_state_dict_from_zero_checkpoint", "load_fp32_state_dict",
           "load_state_dict_from_zero_checkpoint", "state_dict_to_params",
           "reshard_checkpoint", "reshard_inference_checkpoint", "load_mp_shard"]
