"""The port's serving supervisor, fault sites and canary probe, on the CPU.

Same numpy weights as the JAX engine, fp32, the JAX resilience fixtures
(``b_slots=3, page_size=8, max_model_len=64``): a fault planted with the
injector at each serve site (``serve.tick``, ``serve.admit``,
``serve.prefill``, ``serve.decode``, and ``serve.replay`` inside the
restart) leaves stitched outputs token-exact with the fault-free run (and
with the JAX supervisor's under the same fault); the restart budget is
terminal; a fault mid-``drain()`` finishes the in-flight requests and hands
back only the waiting ones; ``health()`` carries the JAX supervisor's
keys, counters cumulative across restarts; the weight epoch carries over a
restart; a fenced slot is probed and unfenced; ``update_params`` flushes
the cache and refuses a live slot or a tree of other shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.serving import Request as JaxRequest
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.resilience import FaultInjector as JaxFaultInjector
from deepspeed_tpu.resilience import clear_injector as jax_clear_injector
from deepspeed_tpu.resilience import install_injector as jax_install_injector
from deepspeed_tpu_torch.inference import (Request, RestartBudgetExhausted,
                                           SlotPrefillError)
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.observability import configure_tracer
from deepspeed_tpu_torch.resilience import (FaultInjector, InjectedFault,
                                            clear_injector, install_injector)
from deepspeed_tpu_torch.resilience.fault_injection import (
    SITE_SERVE_ADMIT, SITE_SERVE_DECODE, SITE_SERVE_PREFILL, SITE_SERVE_REPLAY,
    SITE_SERVE_TICK)

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
def engines():
    jmodel = JaxCausalLM("tiny", dtype=jnp.float32, attn_impl="xla")
    jparams = jmodel.init_fn(jax.random.PRNGKey(3))
    jeng = deepspeed_tpu.init_inference(model=jmodel, config={"dtype": "float32"},
                                        params=jparams)
    teng = deepspeed_tpu_torch.init_inference(
        CausalLM("tiny", dtype=torch.float32, attn_impl="xla"),
        config={"dtype": "float32"}, device="cpu",
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    return jeng, teng


def _stream(n=6, seed=1, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, input_ids=rng.integers(1, 250, int(rng.integers(3, 14))
                                              ).astype(np.int32),
                max_new_tokens=int(rng.choice((4, 6, 8))))
            for i in range(n)]


@pytest.fixture(scope="module")
def reference(engines):
    _, teng = engines
    return {r.rid: r.output_ids for r in teng.serving(**SERVE).run(_stream())}


def _faulted(install, injector_cls, site, at_call):
    inj = injector_cls()
    inj.add(site=site, kind="raise", at_call=at_call)
    install(inj)
    return inj


@pytest.mark.parametrize("site,at_call", [(SITE_SERVE_TICK, 3), (SITE_SERVE_ADMIT, 2),
                                          (SITE_SERVE_PREFILL, 2),
                                          (SITE_SERVE_DECODE, 3)])
def test_fault_at_each_serve_site_replays_token_exact(engines, reference, site, at_call):
    """One raise at the site: the supervisor (a warm restart, or for a slot
    prefill failure a continuation on the live pool) finishes every request
    with the fault-free tokens, as the JAX supervisor does under the same
    fault."""
    jeng, teng = engines
    sup = teng.supervised_serving(**SERVE)
    _faulted(install_injector, FaultInjector, site, at_call)
    try:
        got = {r.rid: r for r in sup.run(_stream())}
    finally:
        clear_injector()
    assert sorted(got) == sorted(reference)
    for rid, r in got.items():
        np.testing.assert_array_equal(r.output_ids, reference[rid])
        assert r.decode_ticks == len(r.output_ids) - 1 - r.replays
    restarts = 0 if site == SITE_SERVE_PREFILL else 1
    assert sup.restarts == restarts
    assert sup.engine.page_accounting()["balanced"]
    jsup = jeng.supervised_serving(**SERVE)
    _faulted(jax_install_injector, JaxFaultInjector, site, at_call)
    try:
        jgot = {r.rid: r for r in jsup.run(_stream(cls=JaxRequest))}
    finally:
        jax_clear_injector()
    assert jsup.restarts == sup.restarts
    for rid, r in got.items():
        np.testing.assert_array_equal(r.output_ids, jgot[rid].output_ids)
        assert r.replays == jgot[rid].replays
    if restarts:
        entry = sup.restart_log[-1]
        assert entry["programs_reused"] is False and entry["shape_matched"]
        assert entry["graph_captures_after_restart"] == 0   # the CPU captures none


def test_replay_fault_retried_and_budget_terminal(engines, reference):
    _, teng = engines
    sup = teng.supervised_serving(**SERVE)
    inj = FaultInjector()
    inj.add(site=SITE_SERVE_DECODE, kind="raise", at_call=2)
    inj.add(site=SITE_SERVE_REPLAY, kind="raise", at_call=1)
    install_injector(inj)
    try:
        got = {r.rid: r.output_ids for r in sup.run(_stream())}
    finally:
        clear_injector()
    assert sup.restarts == 2
    for rid, toks in got.items():
        np.testing.assert_array_equal(toks, reference[rid])
    sup = teng.supervised_serving(max_restarts=2, **SERVE)
    inj = FaultInjector()
    inj.add(site=SITE_SERVE_DECODE, kind="raise", every=1, max_fires=0)
    install_injector(inj)
    try:
        with pytest.raises(RestartBudgetExhausted) as err:
            sup.run(_stream())
    finally:
        clear_injector()
    assert len(err.value.restart_log) == 2 and "budget" in str(err.value)


def test_mid_drain_fault_preserves_partial_progress(engines, reference):
    _, teng = engines
    sup = teng.supervised_serving(b_slots=2, page_size=8, max_model_len=64)
    for r in _stream():
        sup.submit(r)
    sup.engine.step()                        # 2 in flight, 4 waiting
    inflight = sorted(st.request.rid for st in sup.engine._slots if st is not None)
    pre = {st.request.rid: len(st.tokens) for st in sup.engine._slots if st is not None}
    inj = FaultInjector()
    inj.add(site=SITE_SERVE_DECODE, kind="raise", at_call=2)
    install_injector(inj)
    try:
        unserved = sup.drain(max_ticks=500)
    finally:
        clear_injector()
    assert sup.restarts == 1 and sup.restart_log[0]["mid_drain"]
    assert sup.restart_log[0]["stashed"] == 4
    assert [r.rid for r in unserved] == [r for r in sorted(reference) if r not in inflight]
    results = {r.rid: r for r in sup.take_results()}
    assert sorted(results) == inflight
    for rid in inflight:
        np.testing.assert_array_equal(results[rid].output_ids, reference[rid])
        assert results[rid].replays == 1 and len(results[rid].output_ids) > pre[rid]
    assert sup.engine.page_accounting()["balanced"]


def test_health_keys_counters_and_epoch_carry(engines, reference):
    """The supervisor's health has the JAX supervisor's keys, its counters
    are cumulative across a restart, and a restart keeps the weight epoch
    (the replacement takes the dead engine's own weights)."""
    jeng, teng = engines
    sup = teng.supervised_serving(**SERVE)
    jkeys = set(jeng.supervised_serving(**SERVE).health())
    assert jkeys <= set(sup.health())
    sup.run(_stream(seed=9))
    sup.engine.update_params(teng.params)
    assert sup.engine.weight_epoch == 1
    hits = sup.health()["prefix_misses_total"]
    inj = FaultInjector()
    inj.add(site=SITE_SERVE_DECODE, kind="raise", at_call=2)
    install_injector(inj)
    configure_tracer(enabled=True)
    try:
        got = {r.rid: r.output_ids for r in sup.run(_stream())}
    finally:
        clear_injector()
        configure_tracer(enabled=False)
    for rid, toks in got.items():
        np.testing.assert_array_equal(toks, reference[rid])
    assert sup.restarts == 1 and sup.engine.weight_epoch == 1
    assert sup.last_flight_dump and "serve.decode" in sup.last_flight_dump
    h = sup.health()
    assert h["prefix_misses_total"] >= hits + 1 and h["restarts"] == 1
    # the carry re-publishes the live view on the replacement: one more update
    assert h["weight_updates_total"] == 2 and h["last_restart_cause"].startswith(
        "InjectedFault")


def test_quarantined_slot_probed_and_unfenced(engines):
    _, teng = engines
    serve = teng.serving(quarantine_limit=2, probe_after_ticks=3, **SERVE)
    inj = FaultInjector()
    inj.add(site=SITE_SERVE_PREFILL, kind="raise", at_call=1)
    inj.add(site=SITE_SERVE_PREFILL, kind="raise", at_call=1)
    install_injector(inj)
    fenced = False
    try:
        for r in _stream(5, seed=21):
            serve.submit(r)
        while True:
            try:
                if serve.step() == 0:
                    break
            except SlotPrefillError as e:
                fenced = fenced or e.quarantined
    finally:
        clear_injector()
    h = serve.health()
    assert fenced and h["quarantined_slots"] == 0 and h["quarantined_pages"] == 0
    assert h["probes_total"] >= 1 and h["unfenced_total"] == 1
    assert serve.page_accounting()["balanced"]
    assert sorted(r.rid for r in serve.take_results()) == list(range(5))
    plain = teng.serving(quarantine_limit=1, **SERVE)
    inj = FaultInjector()
    inj.add(site=SITE_SERVE_PREFILL, kind="raise", at_call=1)
    install_injector(inj)
    try:
        with pytest.raises(SlotPrefillError):
            plain.run(_stream(2, seed=22))
        plain.run([])
    finally:
        clear_injector()
    assert plain.health()["quarantined_slots"] == 1   # no probe without the option


def test_update_params_flushes_and_refuses_live_slots(engines):
    _, teng = engines
    serve = teng.serving(**SERVE)
    shared = _stream(2, seed=3)
    serve.run([dataclasses.replace(r) for r in shared])
    cached = serve.page_accounting()["cached"]
    assert cached > 0
    stats = serve.update_params(teng.params)
    assert stats == {**stats, "weight_epoch": 1, "flushed_hbm_pages": cached,
                     "flushed_host_slabs": 0, "balanced": True}
    assert serve.page_accounting()["cached"] == 0
    (res,) = serve.run([Request(rid="again", input_ids=shared[0].input_ids,
                                max_new_tokens=2)])
    assert res.shared_prefix_tokens == 0
    serve.submit(Request(rid="live", input_ids=np.array([1, 2, 3], np.int32),
                         max_new_tokens=4))
    serve.step()
    with pytest.raises(RuntimeError, match="in flight"):
        serve.update_params(teng.params)
    serve.run([])
    bad = {**teng.params, "embed": teng.params["embed"][:-1]}
    with pytest.raises(ValueError, match="identical"):
        serve.update_params(bad)
    with pytest.raises(InjectedFault):
        inj = FaultInjector()
        inj.add(site=SITE_SERVE_TICK, kind="raise", at_call=1)
        install_injector(inj)
        try:
            serve.step()
        finally:
            clear_injector()
