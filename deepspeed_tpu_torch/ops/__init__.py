"""Hand-written Hopper kernels (``csrc/``), their Python wrappers and plain
PyTorch versions (``kernels/``), the nvcc/ctypes builder (``op_builder/``),
block-sparse attention (``sparse_attention``) and the BERT-style layer API
(``transformer``, imported on first access: it builds on
``models.transformer``, which imports this package)."""
import importlib

from . import sparse_attention

__all__ = ["sparse_attention", "transformer"]


def __getattr__(name):
    if name == "transformer":
        return importlib.import_module(".transformer", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
