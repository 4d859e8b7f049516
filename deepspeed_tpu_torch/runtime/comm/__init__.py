"""Compressed communication (reference ``deepspeed/runtime/comm/``)."""
from .compressed import (compressed_mean, ef_compress, ef_decode,
                         init_error_tree, pack_signs, unpack_signs)

__all__ = ["compressed_mean", "ef_compress", "ef_decode", "init_error_tree",
           "pack_signs", "unpack_signs"]
