"""Compression training (counterpart of ``deepspeed_tpu/compression/``;
reference ``deepspeed/compression/``): QAT fake-quant, structured and
unstructured pruning, layer reduction — as parameter transforms the
training engine applies to the compute tree each step."""
from .compress import (  # noqa: F401
    build_param_transform,
    init_compression,
    parse_compression_config,
    redundancy_clean,
    student_initialization,
)
from .prune import (  # noqa: F401
    apply_mask,
    channel_mask,
    head_mask,
    row_mask,
    sparse_mask,
)
from .quantize import (  # noqa: F401
    activation_fake_quant,
    bit_schedule,
    quantize_ste,
    quantize_ste_scheduled,
)
