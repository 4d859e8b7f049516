"""``deepspeed_tpu_torch.zero`` — the user-facing ZeRO API (counterpart of
``deepspeed_tpu/zero.py``; reference ``deepspeed/zero``: ``zero.Init``,
``partition_parameters.py:681``, and ``zero.GatheredParameters``,
``:1894``).

- ``Init`` is an honest no-op context: the engine shards the parameters
  itself at initialization (every rank draws the tree from the seed, only
  its model-axis shards under tensor parallelism, and keeps its ZeRO
  shards of the plan), so no module patching is needed.
  It exists so that reference training scripts run unchanged.
- ``GatheredParameters`` yields the full values of a parameter tree:
  host numpy arrays by default (safe for a model bigger than one card),
  or full device tensors on every rank with ``to_device=True``.  A
  data-parallel engine's ``get_params()`` is a ``ShardedParams`` whose
  leaves gather when read, so the gather is collective: every rank enters
  the context.  Nothing is written back on exit (``modifier_rank`` is
  rejected): update the functional state explicitly instead.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

from .utils.logging import logger
from .utils.tree import tree_map


@contextlib.contextmanager
def Init(module=None, data_parallel_group=None, mem_efficient_linear=True,
         remote_device=None, pin_memory=False, config_dict_or_path=None,
         config=None, enabled=True, dtype=None, mpu=None):
    """Reference ``zero.Init`` context: accepted and ignored (the engine
    shards the parameters at initialization)."""
    if enabled:
        logger.info("zero.Init: the engine shards parameters at initialization "
                    "— context accepted for parity, nothing to do")
    yield


def _to_host(x: torch.Tensor):
    x = x.detach()
    # numpy has no bfloat16: widen it to fp32 (exact)
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


class GatheredParameters:
    """Full parameter values inside a context (reference
    partition_parameters.py:1894).  ``.values`` holds the full tree: host
    numpy arrays (bf16 widened to fp32) by default, full device tensors
    with ``to_device=True``."""

    def __init__(self, params: Any, modifier_rank: Optional[int] = None,
                 fwd_module=None, enabled: bool = True, to_device: bool = False):
        if modifier_rank is not None:
            raise NotImplementedError(
                "GatheredParameters(modifier_rank=...) write-back is not "
                "supported: update the functional param tree explicitly")
        self._params = params
        self._enabled = enabled
        self._to_device = to_device
        self.values: Any = None

    def __enter__(self):
        if not self._enabled:
            self.values = self._params
            return self
        with torch.no_grad():
            fn = (lambda x: x.detach().clone()) if self._to_device else _to_host
            self.values = tree_map(fn, self._params)
        return self

    def __exit__(self, *exc):
        self.values = None
        return False
