"""Kernel wrappers and their plain PyTorch versions, one module per kernel
(``flash_attention``), plus the shared conventions (``common``)."""
from .common import NEG_INF, mask_to_i32, pick_block

__all__ = ["NEG_INF", "pick_block", "mask_to_i32"]
