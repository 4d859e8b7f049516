"""Hand-written Hopper kernels (``csrc/``), their Python wrappers and plain
PyTorch versions (``kernels/``), the nvcc and g++ builders (``op_builder/``;
the host ops: ``adam/cpu_adam.py`` and the aio engine of ``aio_bench.py``),
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
