"""Data routing (reference ``data_pipeline/data_routing/``): random-LTD."""
from .random_ltd import (RandomLTDScheduler, gather_tokens, random_ltd_block,
                         scatter_tokens, select_tokens)

__all__ = ["RandomLTDScheduler", "random_ltd_block", "select_tokens",
           "gather_tokens", "scatter_tokens"]
