from .quantizer import (DEFAULT_BLOCK, QuantizedWeight, dequantize_blockwise,
                        hierarchical_quantized_reduce_scatter, quantize_blockwise,
                        quantized_all_gather, quantized_reduce_scatter)

__all__ = ["DEFAULT_BLOCK", "QuantizedWeight", "quantize_blockwise",
           "dequantize_blockwise", "quantized_all_gather", "quantized_reduce_scatter",
           "hierarchical_quantized_reduce_scatter"]
