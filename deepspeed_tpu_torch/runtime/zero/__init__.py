"""ZeRO stages 0-3 and MiCS over ``torch.distributed`` (counterpart of
``deepspeed_tpu/runtime/zero``): ``planner`` decides each leaf's
placement, ``partition`` executes the plan, ``tiling`` bounds a big
matmul's gathered weights."""
