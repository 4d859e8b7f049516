"""Checkpoint engine ABC (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``; reference
``runtime/checkpoint_engine/checkpoint_engine.py:9``).

Pluggable save/load/commit; implementations: ``dcp_engine.DCPCheckpointEngine``
(``torch.distributed.checkpoint``, the default) and
``async_engine.AsyncCheckpointEngine`` (a host snapshot, then a background
write with commit semantics).
"""
from __future__ import annotations

import abc
import os
from typing import Any


class CheckpointEngine(abc.ABC):
    def __init__(self, config_params=None):
        self.config = config_params

    @abc.abstractmethod
    def save(self, state_dict: Any, path: str) -> None:
        ...

    @abc.abstractmethod
    def load(self, path: str, target: Any = None) -> Any:
        ...

    def create(self, tag: str) -> None:
        """Start of a checkpoint under ``tag`` (reference create)."""

    def commit(self, tag: str) -> bool:
        """All files for ``tag`` saved; finalize (reference commit)."""
        return True

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        os.makedirs(path, exist_ok=exist_ok)
