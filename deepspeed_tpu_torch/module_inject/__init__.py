"""Module injection (counterpart of ``deepspeed_tpu/module_inject/``;
reference ``deepspeed/module_inject/``): HF checkpoint -> native-model
conversion policies.  The reference swaps torch layers for fused-kernel
modules; here the port's functional transformer is the optimized
implementation, so injection reduces to the weight name map and the
tensor-parallel layout of ``param_specs``."""
from .load import (  # noqa: F401
    config_from_hf,
    hf_state_dict_to_params,
    load_hf_checkpoint,
)
from .policies import POLICIES, ArchPolicy, detect_arch  # noqa: F401
from .sharded_load import (  # noqa: F401
    MPMergedSource,
    ShardedTensorSource,
    load_hf_checkpoint_sharded,
    open_checkpoint_source,
)
