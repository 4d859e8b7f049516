"""Config keys and defaults (counterpart of ``deepspeed_tpu/runtime/constants.py``)."""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"
FP16 = "fp16"
BF16 = "bf16"
ZERO_OPTIMIZATION = "zero_optimization"
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
MEMORY_BREAKDOWN = "memory_breakdown"

PRESCALE_GRADIENTS = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"

DUMP_STATE = "dump_state"

# ZeRO stages (reference runtime/zero/config.py:84 ZeroStageEnum)
ZERO_STAGE_DISABLED = 0
ZERO_STAGE_OPTIMIZER_STATES = 1
ZERO_STAGE_GRADIENTS = 2
ZERO_STAGE_WEIGHTS = 3

ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"
ROUTE_PREDICT = "predict"
ROUTE_ENCODE = "encode"
