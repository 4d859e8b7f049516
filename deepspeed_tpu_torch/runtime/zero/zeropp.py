"""ZeRO++: quantized ZeRO-3 collectives, qwZ / qgZ (counterpart of
``deepspeed_tpu/runtime/zero/zeropp.py``; reference int8 weight all-gather,
``runtime/zero/partition_parameters.py:1067-1158``, and the quantized
hierarchical gradient reduce, ``runtime/comm/coalesced_collectives.py:31``).

The JAX package builds ``make_zeropp_cast``: a cast of the masters whose
ZeRO-sharded leaves gather through an explicit region with an int8 wire
format.  The port's stage 3 already gathers each sharded compute param
where the model reads it (``partition.ShardedParams``), so ZeRO++ is a
setting of those gathers: :func:`zeropp_settings` gives it, and
``ZeroPartition`` applies it per leaf, whose step differentiates the fp32
master shard as JAX's does —

  forward : quantize the master shard (int8 blockwise) -> all-gather ->
            dequantize to the compute dtype (qwZ; half the bytes of bf16);
  backward: the gather's adjoint, a reduce-scatter of the gradient,
            through the quantized all-to-all reduction under qgZ.

Persistent (small, replicated) params keep the plain path, as in the
reference.  The composition switch is the JAX one: plain qwZ/qgZ cover the
whole ZeRO group; under hpZ only the outer hop ('data_outer': the compute
view's gather after each update and the gradient's reduce-scatter) is
explicit and quantized, the inner per-layer gathers stay bf16; under the
hierarchical DP size the backward reduce runs the two-hop quantized path.
``ZeroPartition.num_quantized_leaves`` counts the leaves whose gathers are
quantized.
"""
from __future__ import annotations

from typing import Optional

from ...parallel.mesh import BATCH_AXES

DEFAULT_BLOCK = 256


def zeropp_settings(zero_config, use_master_weights: bool,
                    compute_dtype=None) -> Optional[dict]:
    """The quantized gathers' settings for ``ZeroPartition`` (None without
    qwZ/qgZ): int8 both ways, the JAX engine's choice (int4 stays
    available in ``ops/quantizer`` for the hierarchical path); the
    gathers land ``compute_dtype``."""
    zc = zero_config
    if not (zc.zero_quantized_weights or zc.zero_quantized_gradients):
        return None
    if not use_master_weights:
        raise ValueError("ZeRO++ quantized collectives require bf16 or "
                         "fp16 compute (fp32 has no cast step to hook)")
    grad_bits = 8 if zc.zero_quantized_gradients else None
    hier = zc.zero_hierarchical_dp_size > 1
    return {"weight_bits": 8 if zc.zero_quantized_weights else None,
            "grad_bits": grad_bits, "block": DEFAULT_BLOCK, "dtype": compute_dtype,
            "hierarchy": ((tuple(a for a in BATCH_AXES if a != "data_outer"), "data_outer")
                          if hier and grad_bits else None)}
