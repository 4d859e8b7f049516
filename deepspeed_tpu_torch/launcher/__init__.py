"""The launcher (counterpart of ``deepspeed_tpu/launcher/``; reference
``deepspeed/launcher/``): one process per GPU on one host or many.

``python -m deepspeed_tpu_torch.launcher [opts] script.py ...`` — see runner.py.
"""
from .runner import (decode_world_info, encode_world_info, fetch_hostfile, main,
                     parse_resource_filter, wait_all_or_fail)

__all__ = ["fetch_hostfile", "parse_resource_filter", "encode_world_info",
           "decode_world_info", "wait_all_or_fail", "main"]
