"""int8 KV pages of the port against the JAX package's, on the CPU.

Same numpy weights (``params_from_jax``), fp32, the JAX serving fixtures
(``b_slots=3, page_size=8, max_model_len=64``): ``kv_quantize_rows`` codes
and scales bit-equal to JAX's (the all-zero row too), the int8 pool layout
and its bytes equal to the JAX engine's, int8 ``forward_paged`` logits
against JAX's (5e-4: a K/V element the two packages' matmuls put a rounding
apart can land on the other side of a code boundary, |code diff| <= 1), the
int8 greedy stream token-exact against JAX's int8 engine and against the
port's full-precision engine, the int8 COW byte-exact over all four planes,
and K4's int8 plain version equal to gather + ``kv_dequantize`` + the
full-precision plain version.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.serving import Request as JaxRequest
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models.transformer import kv_dequantize as jax_kv_dequantize
from deepspeed_tpu.models.transformer import kv_quantize_rows as jax_kv_quantize_rows
from deepspeed_tpu_torch.inference import Request
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax, pool_from_jax
from deepspeed_tpu_torch.models.transformer import (KV_QUANT_DTYPES, cow_copy_pool,
                                                    kv_dequantize, kv_quantize_rows,
                                                    paged_pool_tuple)
from deepspeed_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_reference, decode_attention_split_reference)

SERVE = {"b_slots": 3, "page_size": 8, "max_model_len": 64}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these tiny shapes: a pool of threads costs
    more than the ops when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(JAX engine, port engine) over the same fp32 weights."""
    jmodel = JaxCausalLM("tiny", dtype=jnp.float32, attn_impl="xla")
    jparams = jmodel.init_fn(jax.random.PRNGKey(3))
    jeng = deepspeed_tpu.init_inference(model=jmodel, config={"dtype": "float32"},
                                        params=jparams)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    teng = deepspeed_tpu_torch.init_inference(
        CausalLM("tiny", dtype=torch.float32, attn_impl="xla"),
        config={"dtype": "float32"}, params=tparams, device="cpu")
    return jeng, teng


def _stream(n, seed=0, smin=3, smax=14, new=(4, 6, 8), vocab=250, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, input_ids=rng.integers(1, vocab, int(rng.integers(smin, smax))
                                              ).astype(np.int32),
                max_new_tokens=int(rng.choice(new)))
            for i in range(n)]


def _outputs(results):
    return {r.rid: np.asarray(r.output_ids) for r in results}


def test_kv_quantize_rows_bit_equal_to_jax():
    """Codes and scales bit-equal to JAX's ``kv_quantize_rows`` (fp32 and
    bf16 rows, an all-zero row storing scale 1), and ``kv_dequantize``
    bit-equal to JAX's."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(9, 4, 16)).astype(np.float32) * rng.uniform(0.01, 30, (9, 1, 1))
    x[3] = 0.0
    x[5, 1, 2] = 127.0 / 2.0 * 1e-3   # a code boundary in the row
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        t = torch.from_numpy(x).to(dtype)
        q, s = kv_quantize_rows(t)
        jq, js = jax_kv_quantize_rows(jnp.asarray(x, jdtype))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert s[3] == 1.0 and not q[3].any()
        np.testing.assert_array_equal(
            kv_dequantize(q[None], s[None], torch.float32).numpy(),
            np.asarray(jax_kv_dequantize(jq[None], js[None], jnp.float32)))


def test_int8_pool_layout_and_bytes_match_jax(tiny):
    jeng, teng = tiny
    assert KV_QUANT_DTYPES == ("int8",)
    with pytest.raises(ValueError, match="kv_dtype"):
        teng.model.init_paged_cache(3, 8, kv_dtype="int4", device="cpu")
    c = teng.model.config
    cache = teng.model.init_paged_cache(6, 8, kv_dtype="int8", device="cpu")
    assert [k for k in cache] == ["k", "v", "k_scale", "v_scale"]
    assert cache["k"].dtype == torch.int8 and cache["v"].dtype == torch.int8
    assert tuple(cache["k"].shape) == (c.num_layers, 6, 8, c.kv_heads, c.dims_per_head)
    assert tuple(cache["k_scale"].shape) == (c.num_layers, 6, 8)
    assert cache["v_scale"].dtype == torch.float32
    kw = {"b_slots": 2, "page_size": 8, "num_pages": 6, "max_model_len": 32}
    for kv in ("int8", None):
        ours = teng.serving(kv_dtype=kv, **kw).health()
        theirs = jeng.serving(kv_dtype=kv, **kw).health()
        assert ours["kv_dtype"] == theirs["kv_dtype"] == kv
        assert ours["kv_pool_bytes_total"] == theirs["kv_pool_bytes_total"]
        assert ours["kv_pool_bytes_per_device"] == theirs["kv_pool_bytes_per_device"]


def test_int8_forward_paged_matches_jax(tiny):
    """A bucketed prefill, a tail prefill over a shared prefix, then a
    decode step over 3 slots (one inactive), on int8 pools: logits at
    5e-4, the pools' codes within one step and their scales within 1e-6
    relative."""
    jeng, teng = tiny
    jm, tm = jeng.model, teng.model
    rs = np.random.RandomState(1)
    jcache = jm.init_paged_cache(25, 8, kv_dtype="int8")
    tcache = pool_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    japply = jax.jit(jm.apply_paged)
    table = np.zeros((3, 8), np.int32)
    table[0, :3] = [7, 2, 11]
    table[1, :2] = [7, 2]
    table[1, 2] = 5
    table[2, :2] = [13, 4]

    def both(tokens, pt, start, mask):
        jl, jc = japply(jeng.params, jnp.asarray(tokens), jcache, jnp.asarray(pt),
                        jnp.asarray(start), jnp.asarray(mask))
        tl, _ = tm.apply_paged(teng.params, torch.from_numpy(tokens), tcache,
                               torch.from_numpy(pt), torch.from_numpy(start),
                               torch.from_numpy(mask))
        return np.asarray(jl), tl.numpy(), jc

    def pools_agree(jc):
        for key in ("k", "v"):
            d = np.abs(tcache[key].numpy()[:, 1:].astype(np.int32)
                       - np.asarray(jc[key])[:, 1:].astype(np.int32))
            assert d.max() <= 1 and (d == 0).mean() > 0.999
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tcache[key].numpy()[:, 1:],
                                       np.asarray(jc[key])[:, 1:], rtol=1e-6)

    for slot, n in ((0, 19), (2, 11)):
        toks = np.zeros((1, 32), np.int32)
        toks[0, :n] = rs.randint(1, 250, n)
        jl, tl, jcache = both(toks, table[slot:slot + 1], np.zeros(1, np.int32),
                              np.arange(32)[None] < n)
        np.testing.assert_allclose(tl[0, :n], jl[0, :n], atol=5e-4, rtol=0)
        pools_agree(jcache)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :5] = rs.randint(1, 250, 5)
    jl, tl, jcache = both(toks, table[1:2], np.array([16], np.int32),
                          np.arange(16)[None] < 5)
    np.testing.assert_allclose(tl[0, :5], jl[0, :5], atol=5e-4, rtol=0)
    pools_agree(jcache)
    last = rs.randint(1, 250, (3, 1)).astype(np.int32)
    jl, tl, jcache = both(last, table, np.array([19, 21, 11], np.int32),
                          np.array([[True], [True], [False]]))
    np.testing.assert_allclose(tl[:2], jl[:2], atol=5e-4, rtol=0)
    pools_agree(jcache)


def test_int8_greedy_stream_token_exact(tiny):
    """The int8 engine's greedy stream equals JAX's int8 engine and the
    port's full-precision engine, token for token; one decode step, and the
    page accounting balances."""
    jeng, teng = tiny
    reqs = _stream(10, seed=4)
    serve = teng.serving(kv_dtype="int8", **SERVE)
    ours = _outputs(serve.run(list(reqs)))
    fp = _outputs(teng.serving(**SERVE).run(list(reqs)))
    jax_q = _outputs(jeng.serving(kv_dtype="int8", **SERVE).run(
        _stream(10, seed=4, cls=JaxRequest)))
    for rid, toks in ours.items():
        np.testing.assert_array_equal(toks, jax_q[rid])
        np.testing.assert_array_equal(toks, fp[rid])
    acct = serve.page_accounting()
    assert acct["balanced"] and acct["referenced"] == acct["cached"]
    assert serve.program_inventory()["decode"] == 1
    assert serve.health()["kv_dtype"] == "int8"


def test_int8_cow_byte_exact(tiny):
    """``cow_copy_pool`` moves the int8 codes and both scale planes as raw
    bytes; a shared-prefix stream with COW boundaries on int8 pages stays
    token-exact with a cold int8 engine."""
    _, teng = tiny
    cache = teng.model.init_paged_cache(6, 8, kv_dtype="int8", device="cpu")
    g = torch.Generator().manual_seed(0)
    for key, x in cache.items():
        if x.dtype == torch.int8:
            x.copy_(torch.randint(-127, 128, x.shape, generator=g, dtype=torch.int8))
        else:
            x.copy_(torch.rand(x.shape, generator=g))
    pools = paged_pool_tuple(cache)
    before = [p[:, 2].clone() for p in pools]
    cow_copy_pool(pools, 2, 4)
    for p, b in zip(pools, before):
        assert torch.equal(p[:, 4], b) and torch.equal(p[:, 2], b)
    rng = np.random.default_rng(31)
    system = rng.integers(1, 250, 21).astype(np.int32)
    reqs = [Request(rid=i, input_ids=np.concatenate(
        [system, rng.integers(1, 250, int(rng.integers(2, 6))).astype(np.int32)]),
        max_new_tokens=5) for i in range(5)]
    kw = {"b_slots": 2, "page_size": 8, "max_model_len": 64, "kv_dtype": "int8"}
    cold = _outputs(teng.serving(prefix_cache=False, **kw).run(list(reqs)))
    serve = teng.serving(**kw)
    for r in serve.run(list(reqs)):
        np.testing.assert_array_equal(r.output_ids, cold[r.rid])
    assert serve.cow_copies >= 1 and serve.prefix_hits == 4
    assert serve.page_accounting()["balanced"]


@pytest.mark.parametrize("shape", [(3, 4, 4, 16, 8, 3), (2, 8, 2, 16, 4, 5)])
def test_k4_int8_plain_version_is_gather_dequantize_attend(shape):
    """K4's int8 plain version equals the gathered pages dequantized by
    ``kv_dequantize`` into the full-precision plain version, bit for bit
    (fp32 and bf16), and the kernel-arithmetic reference agrees with it."""
    B, Hq, Hkv, hd, page, maxp = shape
    P = 1 + B * maxp
    g = torch.Generator().manual_seed(7)
    k = torch.randint(-127, 128, (P, page, Hkv, hd), generator=g, dtype=torch.int8)
    v = torch.randint(-127, 128, (P, page, Hkv, hd), generator=g, dtype=torch.int8)
    ks, vs = torch.rand(P, page, generator=g) * 0.02, torch.rand(P, page, generator=g) * 0.02
    table = (torch.randperm(P - 1, generator=g)[:B * maxp] + 1).reshape(B, maxp).int()
    T = page * maxp
    lengths = torch.randint(0, T, (B,), generator=g)
    mask = (torch.arange(T)[None] <= lengths[:, None]).int()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(B, Hq, hd, generator=g).to(dtype)
        got = decode_attention_reference(q, k, v, mask, table, k_scale=ks, v_scale=vs)
        kd = kv_dequantize(k, ks, dtype)
        vd = kv_dequantize(v, vs, dtype)
        want = decode_attention_reference(q, kd, vd, mask, table)
        assert got.dtype == dtype and torch.equal(got, want)
        split = decode_attention_split_reference(q, k, v, mask, table,
                                                 k_scale=ks, v_scale=vs)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(split.float(), want.float(), atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="scale"):
        decode_attention_reference(q, k, v, mask, table)
