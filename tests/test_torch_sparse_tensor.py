"""The port's row-sparse tensor (``runtime/sparse_tensor.py``) against the
JAX package's: ``to_dense``/``add``/``from_embedding_grad`` on the same
numpy data (duplicate rows summing), and ``sparse_allreduce`` over 2 gloo
ranks against JAX's over 2 virtual devices (``shard_map``): the gathered
rows and values and their dense sum, exactly (a gather moves bits)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from deepspeed_tpu.runtime import sparse_tensor as jst

from deepspeed_tpu_torch.runtime import sparse_tensor as tst

from ._torch_ranks import run_ranks

V, D, N = 11, 3, 6


def _data(seed, n=N):
    rs = np.random.RandomState(seed)
    return rs.randint(0, V, n).astype(np.int32), rs.randn(n, D).astype(np.float32)


def test_round_trip_and_add_match_jax():
    rows, values = _data(0)
    rows[1] = rows[0]   # a duplicate row sums
    ours = tst.SparseTensor(torch.from_numpy(rows), torch.from_numpy(values), V)
    theirs = jst.SparseTensor(jnp.asarray(rows), jnp.asarray(values), V)
    np.testing.assert_allclose(ours.to_dense().numpy(), np.asarray(theirs.to_dense()),
                               rtol=1e-6)
    dense = np.zeros((V, D), np.float32)
    np.add.at(dense, rows, values)
    np.testing.assert_allclose(ours.to_dense().numpy(), dense, rtol=1e-6)
    r2, v2 = _data(1, 4)
    both = ours.add(tst.SparseTensor(torch.from_numpy(r2), torch.from_numpy(v2), V))
    want = theirs.add(jst.SparseTensor(jnp.asarray(r2), jnp.asarray(v2), V))
    np.testing.assert_array_equal(both.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_allclose(both.to_dense().numpy(), np.asarray(want.to_dense()),
                               rtol=1e-6)
    assert both.nbytes == want.nbytes
    with pytest.raises(ValueError, match="dense_rows mismatch"):
        ours.add(tst.SparseTensor(torch.from_numpy(r2), torch.from_numpy(v2), V + 1))


def test_from_embedding_grad_matches_jax():
    rs = np.random.RandomState(2)
    tokens = rs.randint(0, V, (2, 5)).astype(np.int32)
    cot = rs.randn(2, 5, D).astype(np.float32)
    ours = tst.from_embedding_grad(torch.from_numpy(tokens), torch.from_numpy(cot), V)
    theirs = jst.from_embedding_grad(jnp.asarray(tokens), jnp.asarray(cot), V)
    np.testing.assert_array_equal(ours.rows.numpy(), np.asarray(theirs.rows))
    np.testing.assert_allclose(ours.to_dense().numpy(), np.asarray(theirs.to_dense()),
                               rtol=1e-6)
    # the dense embedding gradient of the lookup, by autograd
    emb = torch.zeros(V, D, requires_grad=True)
    emb[torch.from_numpy(tokens).long()].backward(torch.from_numpy(cot))
    np.testing.assert_allclose(ours.to_dense().numpy(), emb.grad.numpy(), rtol=1e-6)


def test_sparse_allreduce_over_two_ranks_matches_jax(tmp_path):
    rows, values = zip(*(_data(10 + r) for r in range(2)))
    res = run_ranks(2, "sparse", tmp_path, timeout=60, rows=list(rows),
                    values=list(values), dense_rows=V)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def body(r, v):
        out = jst.sparse_allreduce(jst.SparseTensor(r, v, V), "data")
        return out.rows, out.values

    from jax.experimental.shard_map import shard_map

    f = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                  out_specs=(P(), P()), check_rep=False)
    jr, jv = f(jnp.asarray(np.concatenate(rows)), jnp.asarray(np.concatenate(values)))
    want_dense = np.asarray(jst.SparseTensor(jr, jv, V).to_dense())
    for rec in res:
        np.testing.assert_array_equal(rec["rows"], np.asarray(jr))
        np.testing.assert_array_equal(rec["values"], np.asarray(jv))
        np.testing.assert_allclose(rec["dense"], want_dense, rtol=1e-6)
