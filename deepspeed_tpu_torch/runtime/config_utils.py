"""Config-model utilities (counterpart of ``deepspeed_tpu/runtime/config_utils.py``)
on ``dataclasses`` instead of pydantic.

``config_from_dict`` keeps the JAX package's pydantic behaviour: unknown
keys are ignored (with one warning naming them), ``"auto"`` values are
dropped so the field default applies, field aliases are honoured, and a
nested dict becomes the nested dataclass its field declares.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Mapping, Type, TypeVar

from ..utils.logging import logger

AUTO_VALUE = "auto"

C = TypeVar("C")


def config_from_dict(cls: Type[C], data: Mapping[str, Any]) -> C:
    """Build dataclass ``cls`` from a (possibly nested) dict.  A field's
    ``metadata={"alias": name}`` accepts ``name`` as a second key."""
    if isinstance(data, cls):
        return data
    fields = {f.name: f for f in dataclasses.fields(cls)}
    aliases = {f.metadata["alias"]: f.name for f in fields.values()
               if "alias" in f.metadata}
    hints = typing.get_type_hints(cls)
    kwargs: Dict[str, Any] = {}
    unknown = []
    for key, value in dict(data).items():
        name = aliases.get(key, key)
        if name not in fields:
            unknown.append(key)
            continue
        if isinstance(value, str) and value == AUTO_VALUE:
            continue
        sub = hints.get(name)
        if dataclasses.is_dataclass(sub) and isinstance(value, Mapping):
            value = config_from_dict(sub, value)
        kwargs[name] = value
    if unknown:
        logger.warning(f"{cls.__name__}: ignoring unknown keys {sorted(unknown)}")
    return cls(**kwargs)


def check_min(name: str, value: int, least: int) -> None:
    if value < least:
        raise ValueError(f"{name}={value} must be >= {least}")
