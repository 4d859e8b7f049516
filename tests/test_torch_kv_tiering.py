"""The host-RAM KV tier of the port against the JAX package's, on the CPU.

``HostTier`` units as JAX's (LRU order, bytes, capacity, idempotent
discard, adoption with a budget, epoch-gated reads); demote/promote byte
round trips of full-precision and int8 pages through the executor; a
rotating shared-prefix stream over a pool too small for it: tokens equal to
the tier-off engine, demotions, promotions, ``host_tier_bytes`` and the
served tokens equal to the JAX engine's on the same stream, the page
accounting balanced; a full tier evicting for real; and the tier carried
across a supervisor warm restart and a ``recycle()``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.kv_tiering import HostTier as JaxHostTier
from deepspeed_tpu.inference.serving import Request as JaxRequest
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu_torch.inference import Request
from deepspeed_tpu_torch.inference.kv_tiering import HostTier
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.resilience import (FaultInjector, clear_injector,
                                            install_injector)
from deepspeed_tpu_torch.resilience.fault_injection import SITE_SERVE_DECODE

TIERED = {"b_slots": 1, "page_size": 8, "max_model_len": 40, "num_pages": 8}


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
    jmodel = JaxCausalLM("tiny", dtype=jnp.float32, attn_impl="xla")
    jparams = jmodel.init_fn(jax.random.PRNGKey(3))
    jeng = deepspeed_tpu.init_inference(model=jmodel, config={"dtype": "float32"},
                                        params=jparams)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    teng = deepspeed_tpu_torch.init_inference(
        CausalLM("tiny", dtype=torch.float32, attn_impl="xla"),
        config={"dtype": "float32"}, params=tparams, device="cpu")
    return jeng, teng


def _rotation(seed=7, n=9, cls=Request, rid0=0):
    """Three 17-token system prompts (two full pages and a boundary each)
    in rotation with short tails: over 7 usable pages every admission
    needs room, so cold full pages demote and come back as hits."""
    rng = np.random.default_rng(seed)
    systems = [rng.integers(1, 250, 17).astype(np.int32) for _ in range(3)]
    tails = [rng.integers(1, 250, 3).astype(np.int32) for _ in range(n)]
    return [cls(rid=rid0 + i, input_ids=np.concatenate([systems[i % 3], tails[i]]),
                max_new_tokens=4) for i in range(n)]


def _outputs(results, mod=None):
    return {(r.rid % mod if mod else r.rid): np.asarray(r.output_ids) for r in results}


@pytest.mark.parametrize("cls", [HostTier, JaxHostTier])
def test_host_tier_unit(cls):
    """The same storage semantics in both packages (JAX's tier holds
    numpy slabs, the port's tensors or numpy)."""
    tier = cls(max_pages=2, page_bytes=64)
    a = np.zeros((2, 4, 1, 2), np.float32)
    tier.put("k1", a, a)
    tier.put("k2", a, a)
    assert len(tier) == 2 and tier.full()
    assert tier.bytes() == 4 * a.nbytes
    assert tier.oldest_key() == "k1"
    tier.touch("k1")
    assert tier.oldest_key() == "k2"
    assert tier.get("k2") is not None
    assert tier.oldest_key() == "k1"
    tier.discard("k1")
    tier.discard("k1")
    assert len(tier) == 1 and tier.bytes() == 2 * a.nbytes
    assert tier.pop("missing") is None
    tier.put("e", a, a, epoch=3)
    assert tier.get("e", epoch=2) is None and tier.get("e", epoch=3) is not None
    assert tier.epoch_of("e") == 3
    other = cls(max_pages=4)
    for k in ("a", "b", "c"):
        other.put(k, a, a)
    assert cls(max_pages=2).adopt(other) == ["b", "c"]   # MRU-most survive
    with pytest.raises(ValueError):
        cls(max_pages=0)
    t = HostTier(max_pages=2)
    t.put("t", torch.zeros(2, 4, 1, 2), torch.zeros(2, 4, 1, 2, dtype=torch.int8),
          torch.zeros(2, 4))
    assert t.bytes() == 64 + 16 + 32


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_demote_promote_byte_exact(tiny, kv_dtype):
    """The executor's extract/inject round trip moves every plane of a page
    (int8 codes and scale rows as they lie) and leaves other pages alone."""
    _, teng = tiny
    serve = teng.serving(host_tier_pages=4, kv_dtype=kv_dtype, **TIERED)
    ex = serve._exec
    g = torch.Generator().manual_seed(1)
    for a in ex.pools:
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=g, dtype=torch.int8))
        else:
            a.copy_(torch.randn(a.shape, generator=g))
    want = [a[:, 3].clone() for a in ex.pools]
    others = [a[:, 5].clone() for a in ex.pools]
    slabs, event = ex.extract(3)
    assert event is None and len(slabs) == (4 if kv_dtype else 2)
    for s, w in zip(slabs, want):
        assert s.dtype == w.dtype and torch.equal(s, w)
    for a in ex.pools:
        a[:, 6].zero_()
    ex.inject(slabs, 6)
    for a, w, o in zip(ex.pools, want, others):
        assert torch.equal(a[:, 6], w) and torch.equal(a[:, 5], o)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_tiered_stream_equals_tier_off_and_jax(tiny, kv_dtype):
    """The rotation through a pool too small for it: tokens equal to the
    untiered engine (the bytes round-trip), demotions and promotions
    happen, and the tier's bytes, its movements and the tokens equal the
    JAX engine's on the same stream; a second rotation hits every system
    prompt and the accounting stays balanced with the inventory
    constant."""
    jeng, teng = tiny
    ref = _outputs(teng.serving(prefix_cache=False, kv_dtype=kv_dtype, **TIERED)
                   .run(_rotation()))
    serve = teng.serving(host_tier_pages=16, kv_dtype=kv_dtype, **TIERED)
    assert serve.program_inventory()["tier"] == {"extract": 1, "inject": 1}
    out = _outputs(serve.run(_rotation()))
    for rid, toks in out.items():
        np.testing.assert_array_equal(toks, ref[rid])
    assert serve.demotions > 0 and serve.promotions > 0
    acct = serve.page_accounting()
    assert acct["balanced"] and acct["demoted"] == len(serve._tier)
    assert acct["host_tier_bytes"] == serve._tier.bytes()
    jserve = jeng.serving(host_tier_pages=16, kv_dtype=kv_dtype, **TIERED)
    jout = _outputs(jserve.run(_rotation(cls=JaxRequest)))
    jh, h = jserve.health(), serve.health()
    for key in ("host_tier_bytes", "demotions_total", "promotions_total",
                "demoted_pages", "demoted_pages_hwm", "prefix_hits_total"):
        assert h[key] == jh[key], (key, h[key], jh[key])
    for rid, toks in out.items():
        np.testing.assert_array_equal(toks, jout[rid])
    inv = serve.program_inventory()
    second = serve.run(_rotation(rid0=100))
    for r in second:
        np.testing.assert_array_equal(r.output_ids, ref[r.rid % 100])
        assert r.shared_prefix_tokens > 0
    assert serve.program_inventory() == inv
    assert serve.page_accounting()["balanced"]
    lat = serve.tier_latencies()
    assert len(lat["promote_s"]) == serve.promotions
    assert len(lat["demote_s"]) == serve.demotions
    assert serve.residency_digest()
    with pytest.raises(ValueError, match="prefix_cache"):
        teng.serving(prefix_cache=False, host_tier_pages=4, **TIERED)


def test_host_tier_capacity_evicts_for_real(tiny):
    _, teng = tiny
    rng = np.random.default_rng(11)
    systems = [rng.integers(1, 250, 17).astype(np.int32) for _ in range(4)]
    serve = teng.serving(host_tier_pages=2, **TIERED)
    serve.run([Request(rid=i, input_ids=np.concatenate(
        [systems[i], rng.integers(1, 250, 3).astype(np.int32)]), max_new_tokens=4)
        for i in range(4)])
    assert serve.demotions > 0 and len(serve._tier) <= 2
    acct = serve.page_accounting()
    assert acct["balanced"] and acct["demoted"] <= 2
    assert serve._prefix.demoted == len(serve._tier)


def test_tier_carries_across_warm_restart_and_recycle(tiny):
    """Host slabs outlive the dead engine's pool: a warm restart and a
    planned ``recycle()`` carry them, the replacement serves promotions
    from them token-exactly, and nothing is stranded."""
    _, teng = tiny
    ref = _outputs(teng.serving(prefix_cache=False, **TIERED).run(_rotation(seed=3)))
    sup = teng.supervised_serving(host_tier_pages=16, **TIERED)
    sup.run(_rotation(seed=3))
    assert sup.health()["demoted_pages"] > 0
    inj = FaultInjector()
    inj.add(site=SITE_SERVE_DECODE, kind="raise", at_call=3)
    install_injector(inj)
    try:
        results = sup.run(_rotation(seed=3, rid0=100), max_ticks=2000)
    finally:
        clear_injector()
    assert sup.restarts == 1
    entry = sup.restart_log[-1]
    assert entry["host_tier_entries_carried"] > 0 and entry["shape_matched"]
    for r in results:
        np.testing.assert_array_equal(r.output_ids, ref[r.rid % 100])
    acct = sup.engine.page_accounting()
    assert acct["balanced"] and acct["demoted"] == len(sup.engine._tier)
    assert not sup.drain(max_ticks=500)
    demoted = sup.engine.page_accounting()["demoted"]
    assert demoted > 0 and sup.recycle()
    assert sup.engine.page_accounting()["demoted"] == demoted
    assert sup.health()["restarts"] == 1    # a recycle spends no budget
