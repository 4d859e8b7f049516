"""Hand-written Hopper kernels (``csrc/``), their Python wrappers and plain
PyTorch versions (``kernels/``), and the nvcc/ctypes builder (``op_builder/``)."""
