"""The port's paged serving path against the JAX package's, on the CPU.

Same numpy weights (``params_from_jax``) and the fixtures of
``tests/unit/test_serving.py`` (fp32, ``b_slots=3, page_size=8,
max_model_len=64``): ``forward_paged`` logits and pool contents at 1e-5,
``ServingEngine`` greedy streams token-exact against JAX's engine and
against the port's own ``generate``, prefix sharing with copy-on-write
token-exact against a cold engine, and the scheduler's contracts (eos,
validation, the unwind of a failed prefill, a constant program inventory,
the page invariant, refused options).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.prefix_cache import chain_keys as jax_chain_keys
from deepspeed_tpu.inference.serving import Request as JaxRequest
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu_torch.inference import Request, SamplingParams, ServingEngine
from deepspeed_tpu_torch.inference.prefix_cache import chain_keys
from deepspeed_tpu_torch.inference.serving import SlotPrefillError
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import (params_from_jax, params_to_numpy,
                                                pool_from_jax)

SERVE = {"b_slots": 3, "page_size": 8, "max_model_len": 64}


def _engines(name, seed=3):
    jmodel = JaxCausalLM(name, dtype=jnp.float32, attn_impl="xla")
    jparams = jmodel.init_fn(jax.random.PRNGKey(seed))
    jeng = deepspeed_tpu.init_inference(model=jmodel, config={"dtype": "float32"},
                                        params=jparams)
    tmodel = CausalLM(name, dtype=torch.float32, attn_impl="xla")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    teng = deepspeed_tpu_torch.init_inference(tmodel, config={"dtype": "float32"},
                                              params=tparams, device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def tiny():
    """(JAX engine, JAX serving engine, port engine, port serving engine):
    one shared fleet per package, as the JAX file shares one."""
    jeng, teng = _engines("tiny")
    return jeng, jeng.serving(**SERVE), teng, teng.serving(**SERVE)


def _stream(n, seed=0, smin=3, smax=14, new_choices=(4, 6, 8), vocab=250,
            eos=None, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i,
                input_ids=rng.integers(1, vocab, int(rng.integers(smin, smax))
                                       ).astype(np.int32),
                max_new_tokens=int(rng.choice(new_choices)), eos_token_id=eos)
            for i in range(n)]


def _shared_stream(n, seed, sys_len=21, tail_rng=(2, 6), max_new=5, vocab=250,
                   rid0=0, cls=Request):
    """Requests sharing one system prompt: 2 full pages of 8 + a 5-token
    copy-on-write boundary."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, sys_len).astype(np.int32)
    return [cls(rid=rid0 + i,
                input_ids=np.concatenate(
                    [system, rng.integers(1, vocab, int(rng.integers(*tail_rng))
                                          ).astype(np.int32)]),
                max_new_tokens=max_new)
            for i in range(n)]


def _jax_requests(reqs):
    return [JaxRequest(rid=r.rid, input_ids=r.input_ids,
                       max_new_tokens=r.max_new_tokens,
                       eos_token_id=r.eos_token_id) for r in reqs]


def _outputs(results):
    return {r.rid: np.asarray(r.output_ids) for r in results}


def _assert_matches_generate(teng, results, reqs):
    by_rid = {r.rid: r for r in reqs}
    assert sorted(r.rid for r in results) == sorted(by_rid)
    for res in results:
        req = by_rid[res.rid]
        base = teng.generate(req.input_ids[None], max_new_tokens=req.max_new_tokens,
                             eos_token_id=req.eos_token_id
                             ).numpy()[0, len(req.input_ids):]
        np.testing.assert_array_equal(res.output_ids, base[:len(res.output_ids)])


def _balanced(serve):
    acct = serve.page_accounting()
    assert acct["balanced"], acct
    assert not serve._active.any()
    return acct


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_forward_paged_matches_jax(name):
    """A bucketed prefill into one slot's shuffled pages, a tail prefill
    over a shared prefix, then a decode step over 3 slots (one inactive):
    logits at real positions and every non-trash page of the pool."""
    jeng, teng = _engines(name, seed=4)
    jm, tm = jeng.model, teng.model
    jparams = jeng.params
    tparams = teng.params
    rs = np.random.RandomState(1)
    P, ps, maxp = 25, 8, 8
    jcache = jm.init_paged_cache(P, ps)
    tcache = pool_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    japply = jax.jit(jm.apply_paged)   # jitted, as the JAX executor runs it
    table = np.zeros((3, maxp), np.int32)
    table[0, :3] = [7, 2, 11]
    table[1, :2] = [7, 2]            # shares slot 0's first two pages
    table[1, 2] = 5
    table[2, :2] = [13, 4]

    def both(tokens, pt, start, mask):
        jl, jc = japply(jparams, jnp.asarray(tokens), jcache, jnp.asarray(pt),
                        jnp.asarray(start), jnp.asarray(mask))
        tl, _ = tm.apply_paged(tparams, torch.from_numpy(tokens), tcache,
                               torch.from_numpy(pt), torch.from_numpy(start),
                               torch.from_numpy(mask))
        return np.asarray(jl), tl.numpy(), jc

    def pools_agree(jc):
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key].numpy()[:, 1:],
                                       np.asarray(jc[key])[:, 1:], atol=1e-5, rtol=0)

    # prefill slot 0: 19 real tokens in the 32 bucket; slot 2: 11 tokens
    for slot, n in ((0, 19), (2, 11)):
        toks = np.zeros((1, 32), np.int32)
        toks[0, :n] = rs.randint(1, 250, n)
        mask = np.arange(32)[None] < n
        jl, tl, jcache = both(toks, table[slot:slot + 1], np.zeros(1, np.int32), mask)
        np.testing.assert_allclose(tl[0, :n], jl[0, :n], atol=1e-5, rtol=1e-5)
        pools_agree(jcache)
    # slot 1: a tail prefill of 5 tokens at start 16 over slot 0's pages
    toks = np.zeros((1, 16), np.int32)
    toks[0, :5] = rs.randint(1, 250, 5)
    jl, tl, jcache = both(toks, table[1:2], np.array([16], np.int32),
                          np.arange(16)[None] < 5)
    np.testing.assert_allclose(tl[0, :5], jl[0, :5], atol=1e-5, rtol=1e-5)
    pools_agree(jcache)
    # decode: slots 0 and 1 active, slot 2 inactive (its write goes to trash)
    last = rs.randint(1, 250, (3, 1)).astype(np.int32)
    lengths = np.array([19, 21, 11], np.int32)
    active = np.array([[True], [True], [False]])
    jl, tl, jcache = both(last, table, lengths, active)
    np.testing.assert_allclose(tl[:2], jl[:2], atol=1e-5, rtol=1e-5)
    pools_agree(jcache)


def test_serving_matches_jax_and_generate(tiny):
    """A mixed-length stream: token-exact with the JAX engine's serving and
    with the port's per-request greedy generate()."""
    jeng, jserve, teng, tserve = tiny
    reqs = _stream(8, seed=1)
    ours = tserve.run(list(reqs))
    ref = _outputs(jserve.run(_jax_requests(reqs)))
    assert sorted(ref) == sorted(r.rid for r in ours)
    for r in ours:
        np.testing.assert_array_equal(r.output_ids, ref[r.rid])
        assert r.decode_ticks == len(r.output_ids) - 1
        assert r.ttft_s >= 0 and r.latency_s >= r.ttft_s
    _assert_matches_generate(teng, ours, reqs)
    acct = _balanced(tserve)
    assert acct["referenced"] == acct["cached"]   # only the index holds refs


def test_serving_gqa_matches_jax():
    jeng, teng = _engines("tiny-gqa")
    kw = {"b_slots": 2, "page_size": 8, "max_model_len": 64}
    reqs = _stream(3, seed=2, smin=9, smax=14, new_choices=(5, 7))
    ours = teng.serving(**kw).run(list(reqs))
    ref = _outputs(jeng.serving(**kw).run(_jax_requests(reqs)))
    for r in ours:
        np.testing.assert_array_equal(r.output_ids, ref[r.rid])


def test_prefix_sharing_with_cow_token_exact(tiny):
    """Requests sharing a system prompt map resident pages (and copy the
    boundary page) and stay token-exact with a cold engine and with JAX."""
    jeng, jserve, teng, _ = tiny
    reqs = _shared_stream(6, seed=31)
    cold = teng.serving(b_slots=2, page_size=8, max_model_len=64, prefix_cache=False)
    ref = _outputs(cold.run(list(reqs)))
    assert cold.prefix_hits == 0 and "cow" not in cold.program_inventory()
    serve = teng.serving(b_slots=2, page_size=8, max_model_len=64)
    results = serve.run(list(reqs))
    for r in results:
        np.testing.assert_array_equal(r.output_ids, ref[r.rid])
    shared = {r.rid: r.shared_prefix_tokens for r in results}
    assert shared[reqs[0].rid] == 0
    assert all(v >= 21 for k, v in shared.items() if k != reqs[0].rid)
    assert serve.prefix_hits == 5 and serve.prefix_misses == 1
    assert serve.cow_copies == 5 and serve.prefix_pages_shared == 10
    acct = _balanced(serve)
    assert acct["referenced"] == acct["cached"]
    jref = _outputs(jserve.run(_jax_requests(reqs)))
    for r in results:
        np.testing.assert_array_equal(r.output_ids, jref[r.rid])


def test_prefix_eviction_under_pool_pressure(tiny):
    """Cached-but-idle pages are reclaimed (LRU) when admission needs them:
    8 usable pages, one slot, requests of 2-3 pages each."""
    _, _, teng, _ = tiny
    serve = teng.serving(b_slots=1, page_size=8, max_model_len=24, num_pages=9)
    reqs = _stream(8, seed=33, smin=9, smax=14, new_choices=(4,))
    results = serve.run(list(reqs))
    assert len(results) == 8 and serve._prefix.evictions > 0
    _assert_matches_generate(teng, results, reqs)
    _balanced(serve)


def test_chain_keys_match_jax():
    ids = np.arange(1, 40)
    assert chain_keys(ids, 8) == jax_chain_keys(ids, 8)
    assert chain_keys(ids, 8, limit=20, salt=3) == jax_chain_keys(ids, 8, limit=20,
                                                                  salt=3)


def test_sampled_lanes_equal_generate(tiny):
    """Sampled lanes beside greedy ones: each stream equals the port's
    generate(sampling=...) for the same request (counter-based
    generators at the same stream positions)."""
    _, _, teng, tserve = tiny
    reqs = _stream(4, seed=11, new_choices=(6,))
    lanes = [SamplingParams(temperature=1.0, top_k=20, seed=7), None,
             SamplingParams(temperature=0.7, top_p=0.9, seed=8),
             SamplingParams(temperature=1.3, seed=9)]
    for r, sp in zip(reqs, lanes):
        r.sampling = sp
    results = tserve.run(list(reqs))
    for res in results:
        req = reqs[res.rid]
        base = teng.generate(req.input_ids[None], max_new_tokens=6,
                             sampling=req.sampling or SamplingParams()
                             ).numpy()[0, len(req.input_ids):]
        np.testing.assert_array_equal(res.output_ids, base)
    assert tserve.sampled_admissions >= 3
    _balanced(tserve)


def test_eos_retires_slot(tiny):
    _, _, teng, tserve = tiny
    probe = _stream(1, seed=4, new_choices=(8,))[0]
    base = teng.generate(probe.input_ids[None], max_new_tokens=8).numpy()[0]
    eos = int(base[len(probe.input_ids) + 2])   # the 3rd generated token
    (res,) = tserve.run([Request(rid="e", input_ids=probe.input_ids,
                                 max_new_tokens=8, eos_token_id=eos)])
    assert res.finish_reason == "eos" and res.output_ids[-1] == eos
    assert len(res.output_ids) <= 3
    np.testing.assert_array_equal(res.output_ids,
                                  base[len(probe.input_ids):][:len(res.output_ids)])
    _balanced(tserve)


def test_submit_validation_and_duplicate_rids(tiny):
    _, _, teng, tserve = tiny
    with pytest.raises(ValueError, match="max_model_len"):
        tserve.submit(Request(rid=0, input_ids=np.arange(60, dtype=np.int32),
                              max_new_tokens=10))
    with pytest.raises(ValueError, match="empty"):
        tserve.submit(Request(rid=1, input_ids=np.zeros((0,), np.int32)))
    with pytest.raises(ValueError, match="max_new_tokens"):
        tserve.submit(Request(rid=2, input_ids=np.array([1, 2], np.int32),
                              max_new_tokens=0))
    with pytest.raises(ValueError, match="deadline_s"):
        tserve.submit(Request(rid=3, input_ids=np.array([1, 2], np.int32),
                              deadline_s=0.0))
    with pytest.raises(ValueError):
        ServingEngine(teng.model, teng.params, b_slots=1, page_size=16,
                      max_model_len=64, num_pages=2, device="cpu")
    tserve.submit(Request(rid="dup", input_ids=np.array([1, 2, 3], np.int32),
                          max_new_tokens=2))
    with pytest.raises(ValueError, match="unique"):
        tserve.submit(Request(rid="dup", input_ids=np.array([4, 5], np.int32),
                              max_new_tokens=2))
    (res,) = tserve.run([])   # drain the queued original
    assert res.rid == "dup" and len(res.output_ids) == 2
    _balanced(tserve)


def test_failed_prefill_unwinds_reservation(tiny, monkeypatch):
    """A prefill that dies must not leak pages or drop the request: the
    reservation unwinds, the request stays at the head, the retry serves it."""
    _, _, teng, tserve = tiny

    def boom(*args, **kwargs):
        raise RuntimeError("injected prefill failure")

    with monkeypatch.context() as m:
        m.setattr(tserve._exec, "prefill", boom)
        tserve.submit(Request(rid="pf", input_ids=np.array([1, 2, 3], np.int32),
                              max_new_tokens=3))
        with pytest.raises(RuntimeError, match="injected prefill"):
            tserve.step()
        assert tserve.page_accounting()["balanced"]
        assert tserve._queue[0].rid == "pf"
        assert not tserve._active.any() and not tserve._quarantined.any()
    (res,) = tserve.run([])
    assert res.rid == "pf" and len(res.output_ids) == 3
    _balanced(tserve)


def test_slot_quarantine_leaks_and_accounts_pages(tiny, monkeypatch):
    """quarantine_limit consecutive prefill failures fence the slot: its
    private pages are leaked-and-accounted, and the request is served by
    another slot."""
    _, _, teng, _ = tiny
    serve = teng.serving(b_slots=2, page_size=8, max_model_len=64,
                         quarantine_limit=1)
    real = serve._exec.prefill
    calls = []

    def fail_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected prefill failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(serve._exec, "prefill", fail_once)
    req = Request(rid="q", input_ids=np.arange(1, 12, dtype=np.int32),
                  max_new_tokens=4)
    serve.submit(req)
    with pytest.raises(SlotPrefillError) as err:
        serve.step()
    assert err.value.quarantined and err.value.slot == 0
    acct = serve.page_accounting()
    assert acct["balanced"] and acct["quarantined"] == 2
    (res,) = serve.run([])
    assert serve._quarantined.tolist() == [True, False]
    _assert_matches_generate(teng, [res], [req])
    assert serve.health()["usable_slots"] == 1
    assert serve.page_accounting()["balanced"]


def test_program_inventory_constant_across_streams(tiny):
    _, _, _, tserve = tiny
    tserve.run(_stream(3, seed=5))
    inv = tserve.program_inventory()
    assert inv["decode"] == 1 and inv["prefill_buckets"] == [16]
    assert inv["captures"] == 0          # decode runs eagerly on the CPU
    assert len(tserve.run(_stream(6, seed=6))) == 6
    assert tserve.program_inventory() == inv
    _balanced(tserve)
    h = tserve.health()
    assert h["active_slots"] == 0 and h["kv_pool_bytes_total"] > 0


def test_deadline_shed_and_drain(tiny):
    _, _, _, tserve = tiny
    tserve.max_queue = 2
    try:
        reqs = _stream(3, seed=12, new_choices=(4,))
        for r in reqs[:2]:
            tserve.submit(r)
        tserve.submit(reqs[2])           # the queue holds max_queue: shed
        tserve.submit(Request(rid="dl", input_ids=np.array([7, 8], np.int32),
                              deadline_s=1e-9))
        results = {r.rid: r for r in tserve.run([])}
    finally:
        tserve.max_queue = None
    assert results[2].finish_reason == "shed" and results[2].retry_after_s > 0
    assert {results[0].finish_reason, results[1].finish_reason} == {"length"}
    assert results["dl"].finish_reason == "shed"
    late = Request(rid="late", input_ids=np.array([5, 6], np.int32),
                   max_new_tokens=4, arrival_time=30.0)
    tserve.submit(late)
    tserve.submit(Request(rid="dl", input_ids=np.array([7, 8], np.int32),
                          deadline_s=1e-9))
    assert [r.rid for r in tserve.drain()] == ["dl", "late"]
    tserve._draining = False
    expired = Request(rid="x", input_ids=np.array([7, 8], np.int32),
                      deadline_s=1e-9)
    (res,) = tserve.run([expired])       # expires in the queue
    assert res.finish_reason == "deadline" and len(res.output_ids) == 0
    _balanced(tserve)


def test_refused_options_name_their_roadmap_item(tiny):
    """What is still refused names its ROADMAP item (the monitor, the
    watchdog, SLO rules and per-program statistics: item 12; the fleet:
    item 14); the serving extras of item 7 and ``update_params`` build
    (tests/test_torch_{kv_quant,kv_tiering,speculative,adapters,
    serving_supervisor}.py hold them against JAX)."""
    _, _, teng, tserve = tiny
    for kwargs, item in (({"monitor": object()}, "item 12"),
                         ({"watchdog": object()}, "item 12"),
                         ({"slo_rules": [object()]}, "item 12"),
                         ({"program_stats_sample_every": 2}, "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            teng.serving(**SERVE, **kwargs)
    for kwargs in ({"host_tier_pages": 4}, {"kv_dtype": "int8"},
                   {"probe_after_ticks": 3}):
        assert teng.serving(**SERVE, **kwargs).page_accounting()["balanced"]
    # mesh= is ported (tests/test_torch_tp.py): a non-mesh is a TypeError
    with pytest.raises(TypeError, match="MeshLayout"):
        teng.serving(**SERVE, mesh=object())
    assert tserve.update_params(teng.params)["balanced"]
    with pytest.raises(RuntimeError, match="AdapterRegistry"):
        tserve.fuse_adapter("a")
    with pytest.raises(ValueError, match="AdapterRegistry"):
        tserve.submit(Request(rid="t", input_ids=np.array([1], np.int32),
                              adapter_id="tenant"))
    assert teng.supervised_serving(**SERVE).restarts == 0
    with pytest.raises(NotImplementedError, match="item 14"):
        teng.serving_fleet()
    pool = {"k": np.zeros((1, 2, 8, 4, 16), np.int8), "v": np.ones((1, 2, 8, 4, 16), np.int8),
            "k_scale": np.full((1, 2, 8), 0.5, np.float32)}
    back = params_to_numpy(pool_from_jax(pool, "cpu"))
    for key, x in pool.items():
        np.testing.assert_array_equal(back[key], x)
