"""K4's plain version against the JAX package, on the CPU.

``decode_attention_reference`` (and the ``decode_attention`` wrapper, which
runs it for CPU tensors) is held to the retired Pallas kernel
``tools/retired_decode_attention.py`` in interpret mode, and to the paged
einsum ``_attention_paged`` at S=1 over shuffled page tables.  The retired
module's ``from .common import pick_block`` needs a package, so it is loaded
under ``deepspeed_tpu.ops.pallas`` (the file itself stays as it is).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deepspeed_tpu.ops.pallas.common  # noqa: F401  (parent of the K4 module)
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.kernels import decode_attention as da

ROOT = Path(__file__).resolve().parent.parent
ATOL = 2e-5


def _retired_k4():
    spec = importlib.util.spec_from_file_location(
        "deepspeed_tpu.ops.pallas._retired_k4",
        ROOT / "tools" / "retired_decode_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def k4():
    return _retired_k4()


def _ragged_mask(rs, B, T):
    """Random attendable sets plus a short prefix row: every row attends
    at least one key."""
    mask = rs.rand(B, T) < 0.6
    mask[0, :] = False
    mask[0, :37] = True
    mask[:, 0] = True
    return mask


@pytest.mark.parametrize("T", [256, 384])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4)])
def test_reference_matches_jax_k4_interpret(k4, Hq, Hkv, hd, T):
    rs = np.random.RandomState(hd + T + Hkv)
    B = 2
    q = rs.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rs.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v = rs.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    mask = _ragged_mask(rs, B, T)
    ref = np.asarray(k4.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(mask), interpret=True, block_t=128))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tm = torch.from_numpy(mask)
    out = da.decode_attention_reference(tq, tk, tv, tm)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    # the wrapper runs the plain version for CPU tensors, bool or int mask
    wrapped = da.decode_attention(tq, tk, tv, tm.to(torch.int32))
    np.testing.assert_allclose(wrapped.numpy(), ref, atol=ATOL, rtol=0)


def _paged_case(rs, B, Hq, Hkv, hd, page, maxp, lengths):
    P = 1 + B * maxp
    pool_k = rs.standard_normal((P, page, Hkv, hd)).astype(np.float32)
    pool_v = rs.standard_normal((P, page, Hkv, hd)).astype(np.float32)
    perm = rs.permutation(np.arange(1, P))           # shuffled physical pages
    table = perm[:B * maxp].reshape(B, maxp).astype(np.int32)
    for b, n in enumerate(lengths):                  # unallocated -> trash page
        table[b, -(-(n + 1) // page):] = 0
    q = rs.standard_normal((B, Hq, hd)).astype(np.float32)
    return q, pool_k, pool_v, table


@pytest.mark.parametrize("page", [8, 128])
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4)])
def test_reference_matches_jax_paged_einsum(Hq, Hkv, page):
    """S=1 against the JAX package's ``_attention_paged`` over the gathered
    pages, with its causal mask ``t <= q_pos``."""
    rs = np.random.RandomState(page + Hq)
    B, hd, maxp = 3, 64, 256 // page
    lengths = [0, 37, 255]
    q, pk, pv, table = _paged_case(rs, B, Hq, Hkv, hd, page, maxp, lengths)
    T = maxp * page
    cfg = jtf.get_config("tiny", num_heads=Hq, num_kv_heads=Hkv, head_dim=hd)
    rows = (table[:, :, None] * page + np.arange(page)[None, None]).reshape(B, T)
    P = pk.shape[0]
    ck = pk.reshape(P * page, Hkv, hd)[rows]
    cv = pv.reshape(P * page, Hkv, hd)[rows]
    q_pos = np.asarray(lengths, np.int32)[:, None]
    ref = np.asarray(jtf._attention_paged(cfg, jnp.asarray(q[:, None]), jnp.asarray(ck),
                                          jnp.asarray(cv), jnp.asarray(q_pos)))[:, 0]
    mask = torch.arange(T)[None, :] <= torch.from_numpy(q_pos)
    out = da.decode_attention(torch.from_numpy(q), torch.from_numpy(pk),
                              torch.from_numpy(pv), mask, torch.from_numpy(table))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_identity_table_and_shared_pages_are_one_call():
    """A contiguous cache is the paged call with the identity table; two
    rows mapping one physical page read the same keys."""
    rs = np.random.RandomState(5)
    B, T, Hkv, hd, page = 2, 64, 2, 64, 16
    q = torch.from_numpy(rs.standard_normal((B, 4, hd)).astype(np.float32))
    k = torch.from_numpy(rs.standard_normal((B, T, Hkv, hd)).astype(np.float32))
    v = torch.from_numpy(rs.standard_normal((B, T, Hkv, hd)).astype(np.float32))
    mask = torch.from_numpy(_ragged_mask(rs, B, T))
    contiguous = da.decode_attention(q, k, v, mask)
    pools = [x.reshape(B * T // page, page, Hkv, hd) for x in (k, v)]
    table = torch.arange(B * T // page, dtype=torch.int32).reshape(B, T // page)
    paged = da.decode_attention(q, *pools, mask, table)
    torch.testing.assert_close(paged, contiguous, rtol=0, atol=0)
    # row 1 maps row 0's first page: equal to a cache holding those rows
    shared = table.clone()
    shared[1, 0] = table[0, 0]
    k2, v2 = k.clone(), v.clone()
    k2[1, :page], v2[1, :page] = k[0, :page], v[0, :page]
    torch.testing.assert_close(da.decode_attention(q, *pools, mask, shared),
                               da.decode_attention(q, k2, v2, mask), rtol=0, atol=0)


def test_wrapper_checks_shapes():
    q = torch.zeros((2, 4, 64))
    pool = torch.zeros((5, 8, 2, 64))
    table = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="maxp"):
        da.decode_attention(q, pool, pool, torch.ones((2, 17), dtype=torch.bool), table)
    with pytest.raises(ValueError, match="page_table"):
        da.decode_attention(q, pool, pool, torch.ones((2, 8), dtype=torch.bool),
                            table[:1])
    with pytest.raises(ValueError, match="does not fit"):
        da.decode_attention(torch.zeros((2, 3, 64)), pool, pool,
                            torch.ones((2, 8), dtype=torch.bool), table)


@pytest.mark.parametrize("name,overrides,launches_k4", [
    ("tiny", {}, True),
    ("tiny-gqa", {}, True),
    ("tiny", {"position": "alibi", "norm": "layernorm", "activation": "gelu"}, False),
])
def test_decode_dispatch_by_config(monkeypatch, name, overrides, launches_k4):
    """Decode (S=1) of a non-alibi config goes through the K4 wrapper;
    alibi takes the einsum over gathered pages (dispatch by config, as the
    JAX ``_attention`` sends alibi to XLA), and so does prefill."""
    calls = []
    real = ttf.decode_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(ttf, "decode_attention", spy)
    model = CausalLM(name, dtype=torch.float32, **overrides)
    params = model.init_fn(torch.Generator().manual_seed(0), device="cpu")
    cache = model.init_paged_cache(9, 8, device="cpu")
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    toks = torch.tensor([[3, 4, 5, 6, 7, 8, 0, 0]] * 2)
    seq = torch.arange(8)[None] < torch.tensor([[6], [4]])
    model.apply_paged(params, toks, cache, table, torch.zeros(2, dtype=torch.int32), seq)
    assert calls == []                                  # prefill: einsum
    model.apply_paged(params, toks[:, :1], cache, table,
                      torch.tensor([6, 4], dtype=torch.int32),
                      torch.ones((2, 1), dtype=torch.bool))
    L, Hq = model.config.num_layers, model.config.num_heads
    assert calls == ([(2, Hq, model.config.dims_per_head)] * L if launches_k4 else [])
