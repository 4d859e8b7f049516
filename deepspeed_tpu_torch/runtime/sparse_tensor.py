"""Row-sparse gradient representation (counterpart of
``deepspeed_tpu/runtime/sparse_tensor.py``; reference
``runtime/sparse_tensor.py``).

A fixed-width row-sparse [V, d] value: ``rows [N]`` (duplicates allowed;
they sum) and ``values [N, d]``, with the reference's ``to_dense`` /
``add`` / ``sparse_allreduce`` surface, for data and comm pipelines whose
row count is known (B*S rows a step).  As in the JAX package, the engine
does not exchange embedding gradients this way: ZeRO already shards the
dense exchange and tensor parallelism the table, so ``sparse_gradients:
true`` stays refused by the config.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import comm


@dataclasses.dataclass
class SparseTensor:
    rows: torch.Tensor        # [N] int
    values: torch.Tensor      # [N, d]
    dense_rows: int = 0

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros((self.dense_rows, self.values.shape[-1]),
                          dtype=self.values.dtype, device=self.values.device)
        return out.index_add_(0, self.rows.long(), self.values)

    def add(self, other: "SparseTensor") -> "SparseTensor":
        if other.dense_rows != self.dense_rows:
            raise ValueError("dense_rows mismatch")
        return SparseTensor(rows=torch.cat([self.rows, other.rows]),
                            values=torch.cat([self.values, other.values]),
                            dense_rows=self.dense_rows)

    @property
    def nbytes(self) -> int:
        return (self.rows.numel() * self.rows.element_size()
                + self.values.numel() * self.values.element_size())


def from_embedding_grad(tokens: torch.Tensor, cotangent: torch.Tensor,
                        vocab_size: int) -> SparseTensor:
    """The gradient of the lookup ``E[tokens]`` under the output cotangent
    ``g`` as (token, g) pairs instead of ``index_add`` into zeros."""
    return SparseTensor(rows=tokens.reshape(-1).to(torch.int32),
                        values=cotangent.reshape(-1, cotangent.shape[-1]),
                        dense_rows=vocab_size)


def sparse_allreduce(st: SparseTensor, axis) -> SparseTensor:
    """Every rank's (rows, values) over mesh axis ``axis``, concatenated in
    rank order (``comm.all_gather``): wire bytes dp*N*(4 + d*itemsize)
    against the dense V*d*itemsize; ``to_dense`` of the result is the sum."""
    return SparseTensor(rows=comm.all_gather(st.rows.contiguous(), axis),
                        values=comm.all_gather(st.values.contiguous(), axis),
                        dense_rows=st.dense_rows)
