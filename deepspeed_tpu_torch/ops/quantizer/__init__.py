from .quantizer import (DEFAULT_BLOCK, QuantizedWeight, dequantize_blockwise,
                        quantize_blockwise)

__all__ = ["DEFAULT_BLOCK", "QuantizedWeight", "quantize_blockwise",
           "dequantize_blockwise"]
