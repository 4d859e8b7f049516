"""MoE and expert parallelism (counterpart of ``deepspeed_tpu/moe/``)."""
from .layer import MoE
from .sharded_moe import MoEConfig, moe_ffn, moe_ffn_nodrop, top_k_gating

__all__ = ["MoE", "MoEConfig", "moe_ffn", "moe_ffn_nodrop", "top_k_gating"]
