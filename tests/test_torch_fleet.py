"""The port's serving fleet (``deepspeed_tpu_torch/inference/fleet.py``)
against the JAX package's, on the CPU.

The ``tiny`` model in fp32, the JAX engine's weights carried over with
``models/convert.py``.  Held against ``deepspeed_tpu`` on the same inputs:
the store keys (byte for byte), ``_rid_key`` and ``partition_of``, the
request and result documents (equal JSON, each package decoding the
other's); greedy outputs, ``failovers`` and ``resumed_tokens`` per rid under
the same deterministic kill schedules (an engine's lease lapsing, a
restart budget exhausted, a kill mid-stream with the token journal on, the
coordinator killed), and the pinned chaos-soak seed's statistics; a JAX
router that journals a stream and dies, finished by a port router on the
same store directory.  The port's own counterpart of each fleet test of
``tests/unit/test_fleet.py`` (the store-level CAS, election and channel
tests are ``tests/test_torch_pod.py``'s and ``test_torch_store_faults.py``'s),
of the fleet tests of ``test_distributed_tracing.py`` and
``test_adapters.py``, and of the partitioned coordinator of
``test_store_faults.py``: sampled failover is held to the port's own
fault-free run (its draws are not JAX's).  Injected store clocks and kills
at exact router rounds; no wall-clock asserts.
"""
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.elasticity import coordination as JC
from deepspeed_tpu.inference import fleet as JF
from deepspeed_tpu.inference import serving as JS
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.monitor import InMemoryMonitor as JMonitor
from deepspeed_tpu.resilience import clear_injector as jax_clear_injector

import deepspeed_tpu_torch
from deepspeed_tpu_torch.elasticity import coordination as TC
from deepspeed_tpu_torch.elasticity import FaultyStore
from deepspeed_tpu_torch.inference import AdapterRegistry, SamplingParams
from deepspeed_tpu_torch.inference import fleet as TF
from deepspeed_tpu_torch.inference import serving as TS
from deepspeed_tpu_torch.inference.fleet_daemon import StoreMemberProxy
from deepspeed_tpu_torch.inference.prefix_cache import chain_keys
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.monitor import InMemoryMonitor
from deepspeed_tpu_torch.observability import (SloRule, configure_tracer, get_tracer,
                                               prometheus_text)
from deepspeed_tpu_torch.observability.trace_assembly import (assemble_fleet_trace,
                                                              events_for_trace,
                                                              load_segments)
from deepspeed_tpu_torch.resilience import clear_injector
from deepspeed_tpu_torch.runtime.lora import LoRAConfig

from . import _torch_fleet_soak as soak

SERVE_KW = dict(b_slots=2, page_size=8, max_model_len=64)
REF_KW = dict(b_slots=3, page_size=8, max_model_len=64)
JAX = SimpleNamespace(Store=JC.FileCoordinationStore, Member=JF.FleetMember,
                      Router=JF.FleetRouter, Request=JS.Request, fleet=JF)
PORT = SimpleNamespace(Store=TC.FileCoordinationStore, Member=TF.FleetMember,
                       Router=TF.FleetRouter, Request=TS.Request, fleet=TF)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_injectors():
    clear_injector()
    jax_clear_injector()
    yield
    clear_injector()
    jax_clear_injector()


@pytest.fixture(scope="module")
def engines():
    jmodel = JaxCausalLM("tiny", dtype=jnp.float32, attn_impl="xla")
    jparams = jmodel.init_fn(jax.random.PRNGKey(3))
    jeng = deepspeed_tpu.init_inference(model=jmodel, config={"dtype": "float32"},
                                        params=jparams)
    teng = deepspeed_tpu_torch.init_inference(
        CausalLM("tiny", dtype=torch.float32), config={"dtype": "float32"}, device="cpu",
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    return jeng, teng


@pytest.fixture(scope="module")
def tiny_engine(engines):
    return engines[1]


def _stream(n, seed=0, new_choices=(4, 6, 8), cls=TS.Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, input_ids=rng.integers(1, 250, int(rng.integers(3, 12))).astype(np.int32),
                max_new_tokens=int(rng.choice(new_choices)))
            for i in range(n)]


def _copies(reqs, cls=TS.Request):
    return [cls(rid=r.rid, input_ids=r.input_ids, max_new_tokens=r.max_new_tokens,
                eos_token_id=r.eos_token_id, arrival_time=r.arrival_time,
                deadline_s=r.deadline_s)
            for r in reqs]


@pytest.fixture(scope="module")
def reference(engines):
    """The seed-7 stream's fault-free single-engine outputs: the port's,
    held token-equal to the JAX engine's."""
    jeng, teng = engines
    reqs = _stream(9, seed=7)
    ref = {r.rid: r.output_ids for r in teng.serving(**REF_KW).run(_copies(reqs))}
    jref = {r.rid: r.output_ids
            for r in jeng.serving(**REF_KW).run(_copies(reqs, JS.Request))}
    for rid in ref:
        np.testing.assert_array_equal(ref[rid], jref[rid])
    return reqs, ref


def _fleet(eng, tmp_path, n=3, clock=None, monitor=None, router_lease=100.0,
           member_lease=100.0, miss_limit=3, max_fleet_queue=None, max_restarts=5,
           P=PORT, name="coord", **router_kw):
    store = P.Store(str(tmp_path / name), clock=clock)
    members = [P.Member(f"engine{i}", eng.supervised_serving(max_restarts=max_restarts,
                                                             **SERVE_KW),
                        store, lease_s=member_lease)
               for i in range(n)]
    return store, P.Router(store, members, lease_s=router_lease, miss_limit=miss_limit,
                           monitor=monitor, max_fleet_queue=max_fleet_queue, **router_kw)


def _summary(results):
    return {r.rid: ([int(t) for t in r.output_ids], r.finish_reason, r.failovers,
                    r.resumed_tokens) for r in results}


# ---------------------------------------------------------------------------
# The wire level: keys and documents equal JAX's
# ---------------------------------------------------------------------------

KEY_NAMES = sorted(n for n in vars(JF) if n.startswith("FLEET_")
                   and isinstance(getattr(JF, n), str))


@pytest.mark.parametrize("name", KEY_NAMES)
def test_store_keys_equal_jax(name):
    assert getattr(TF, name) == getattr(JF, name)


RIDS = ["job.tmp.1", "x.lock", "a.lock.stale.1", "weird/../rid", "plain", 7, -3, "7",
        10 ** 9, "t.tomb", "x" * 100, "req-a"]


@pytest.mark.parametrize("rid", RIDS, ids=repr)
def test_rid_keys_and_partitions_equal_jax(rid):
    """Journal keys and admission partitions are JAX's, so routers of both
    packages find each other's entries; no key collides with the store's
    write-protocol artifacts."""
    key = TF._rid_key(rid)
    assert key == JF._rid_key(rid)
    assert ".tmp." not in key and ".lock" not in key and not key.endswith(".tomb")
    assert "/" not in key and ".." not in key.split("/")
    for n in (1, 2, 3, 4, 7):
        p = TF.partition_of(rid, n)
        assert p == JF.partition_of(rid, n) and 0 <= p < n
    assert TF._rid_key(7) != TF._rid_key("7")
    assert TF._rid_key("job.tmp.1") != TF._rid_key("job.tmp.2")


def _doc_requests(cls, sampling_cls):
    ids = np.array([5, 6, 7, 300], np.int32)
    return {
        "greedy": cls(rid=1, input_ids=ids, max_new_tokens=8),
        "sampled": cls(rid="s", input_ids=ids, max_new_tokens=4,
                       sampling=sampling_cls(temperature=0.9, top_k=20, top_p=0.9, seed=7)),
        "tenant": cls(rid="a", input_ids=ids, max_new_tokens=3, adapter_id="acme",
                      trace_id="t-1"),
        "deadline": cls(rid=9, input_ids=ids, max_new_tokens=6, eos_token_id=2,
                        deadline_s=1.5, arrival_epoch_s=1234.5),
    }


@pytest.mark.parametrize("kind", ["greedy", "sampled", "tenant", "deadline"])
def test_doc_codecs_equal_jax(kind):
    """The assignment and result documents: equal JSON for the same request
    and result, and each package decodes the other's."""
    treq = _doc_requests(TS.Request, SamplingParams)[kind]
    jreq = _doc_requests(JS.Request, JSampling)[kind]
    tdoc, jdoc = TF.request_to_doc(treq), JF.request_to_doc(jreq)
    assert json.dumps(tdoc, sort_keys=True) == json.dumps(jdoc, sort_keys=True)
    back = TF.request_from_doc(json.loads(json.dumps(jdoc)))
    assert json.dumps(TF.request_to_doc(back), sort_keys=True) == json.dumps(jdoc,
                                                                             sort_keys=True)
    res_kw = dict(rid=treq.rid, input_ids=treq.input_ids,
                  output_ids=np.array([9, 8, 7], np.int32), finish_reason="length",
                  prefill_bucket=8, arrival_s=1.0, admit_s=1.5, first_token_s=2.0,
                  finish_s=3.0, decode_ticks=2, failovers=1, resumed_tokens=2,
                  trace_id=treq.trace_id, adapter_id=treq.adapter_id,
                  lifecycle=[("admit", 1.0, "engine0"), ("failover", 2.0, "engine0")])
    tres, jres = TS.RequestResult(**res_kw), JS.RequestResult(**res_kw)
    t_json = json.dumps(TF.result_to_doc(tres), sort_keys=True)
    assert t_json == json.dumps(JF.result_to_doc(jres), sort_keys=True)
    again = TF.result_from_doc(json.loads(json.dumps(JF.result_to_doc(jres))))
    assert json.dumps(TF.result_to_doc(again), sort_keys=True) == t_json
    assert TF._doc_bytes(tdoc) == JF._doc_bytes(jdoc)


def test_partition_of_deterministic_and_in_range():
    for rid in (0, 7, "req-a", "7", 10 ** 9):
        p = TF.partition_of(rid, 4)
        assert p == TF.partition_of(rid, 4) and 0 <= p < 4
    assert TF.partition_of(3, 1) == 0


# ---------------------------------------------------------------------------
# Kill schedules, held to JAX's fleet
# ---------------------------------------------------------------------------

def _engine_kill(P, eng, tmp_path, reqs):
    clock = [0.0]
    store, router = _fleet(eng, tmp_path, clock=lambda: clock[0], member_lease=1.0, P=P,
                           name=f"coord_{id(P)}")
    kill_t = []

    def on_tick(r, rounds):
        clock[0] += 1.0
        if rounds == 2:
            r.members["engine0"].kill()
            kill_t.append(time.monotonic())

    results = router.run(_copies(reqs, P.Request), max_ticks=500, on_tick=on_tick)
    return store, router, results, kill_t


def test_fleet_engine_kill_fails_over_none_lost(engines, reference, tmp_path):
    """3 engines, engine0's lease lapses mid-stream: queued and in-flight
    requests fail over (re-prefill from the prompt), none lost, token-exact,
    arrival stamps before the kill; the same per rid as JAX's fleet."""
    jeng, teng = engines
    reqs, ref = reference
    store, router, results, kill_t = _engine_kill(PORT, teng, tmp_path, reqs)
    by = {r.rid: r for r in results}
    assert sorted(by) == sorted(r.rid for r in reqs)
    for rid, r in by.items():
        assert r.finish_reason in ("eos", "length")
        np.testing.assert_array_equal(r.output_ids, ref[rid])
    assert "engine0" in router._failed_engines and router.failovers_total > 0
    failed_over = [r for r in by.values() if r.failovers > 0]
    assert len(failed_over) == router.failovers_total
    assert all(r.arrival_s <= kill_t[0] for r in failed_over)
    assert "engine0" in TC.dead_set(store, prefix="fleet/dead")
    assert router.health()["engines_live"] == 2
    for eid, m in router.members.items():
        if m.alive:
            assert m.sup.engine.page_accounting()["balanced"], eid
    _, jrouter, jresults, _ = _engine_kill(JAX, jeng, tmp_path, reqs)
    assert _summary(results) == _summary(jresults)
    assert router.failovers_total == jrouter.failovers_total


def _budget(P, eng, tmp_path, reqs, injector_mod):
    store, router = _fleet(eng, tmp_path, max_restarts=0, P=P, name=f"coord_{id(P)}")
    inj = injector_mod.FaultInjector()
    inj.add(site="serve.decode", kind="raise", at_call=2)
    injector_mod.install_injector(inj)
    try:
        results = router.run(_copies(reqs, P.Request), max_ticks=500)
    finally:
        injector_mod.clear_injector()
    return store, router, results


def test_fleet_budget_exhaustion_writes_dead_marker(engines, reference, tmp_path):
    """A member whose restart budget runs out writes its own dead marker and
    fails over at once, as JAX's does under the same fault."""
    import deepspeed_tpu.resilience as jres
    import deepspeed_tpu_torch.resilience as tres

    jeng, teng = engines
    reqs, ref = reference
    store, router, results = _budget(PORT, teng, tmp_path, reqs, tres)
    by = {r.rid: r for r in results}
    assert sorted(by) == sorted(r.rid for r in reqs)
    for rid, r in by.items():
        np.testing.assert_array_equal(r.output_ids, ref[rid])
    (dead,) = router._failed_engines
    marker = store.get(f"fleet/dead/{dead}")
    assert marker is not None and marker["reported_by"] == dead
    assert router.failovers_total > 0
    _, jrouter, jresults = _budget(JAX, jeng, tmp_path, reqs, jres)
    assert _summary(results) == _summary(jresults)
    assert router._failed_engines == jrouter._failed_engines


def _coordinator_kill(P, eng, tmp_path, reqs):
    clock = [0.0]
    store, router = _fleet(eng, tmp_path, clock=lambda: clock[0], router_lease=30.0, P=P,
                           name=f"coord_{id(P)}")
    standby = P.Router(store, list(router.members.values()), router_id="router1",
                       lease_s=30.0, miss_limit=3)
    for req in _copies(reqs, P.Request):
        router.submit(req)
    gens = [TC.read_generation(store, key=router.generation_key)]
    for _ in range(3):
        router.step()
        clock[0] += 1.0
        standby.step()
        gens.append(TC.read_generation(store, key=router.generation_key))
        assert not standby.is_coordinator
    done_before = list(router.take_results())
    router.kill()
    clock[0] += 60.0
    results = done_before + standby.run([], max_ticks=500)
    gens.append(TC.read_generation(store, key=router.generation_key))
    return standby, results, gens


def test_fleet_coordinator_kill_election_converges(engines, reference, tmp_path):
    """The coordinator dies mid-stream: the standby wins term 2, bumps the
    generation, adopts the journal and finishes every stream, as JAX's."""
    jeng, teng = engines
    reqs, ref = reference
    standby, results, gens = _coordinator_kill(PORT, teng, tmp_path, reqs)
    by = {r.rid: r for r in results}
    assert sorted(by) == sorted(r.rid for r in reqs)
    for rid, r in by.items():
        np.testing.assert_array_equal(r.output_ids, ref[rid])
    assert standby.is_coordinator and standby.term == 2
    assert all(b >= a for a, b in zip(gens, gens[1:])) and gens[-1] > gens[0]
    jstandby, jresults, jgens = _coordinator_kill(JAX, jeng, tmp_path, reqs)
    assert _summary(results) == _summary(jresults)
    assert gens == jgens and standby.term == jstandby.term


def _midstream(P, eng, tmp_path, reqs, monitor=None):
    clock = [0.0]
    store = P.Store(str(tmp_path / f"coord_{id(P)}"), clock=lambda: clock[0])
    members = [P.Member(f"engine{i}", eng.supervised_serving(max_restarts=5, **SERVE_KW),
                        store, lease_s=1.0)
               for i in range(3)]
    router = P.Router(store, members, lease_s=100.0, miss_limit=3, monitor=monitor,
                      journal_every_k=1)

    def on_tick(r, rounds):
        clock[0] += 1.0
        if rounds == 3:
            r.members["engine0"].kill()

    return store, router, router.run(_copies(reqs, P.Request), max_ticks=500,
                                     on_tick=on_tick)


def test_fleet_midstream_kill_resumes_after_last_journaled_token(engines, reference,
                                                                 tmp_path):
    """With the token journal on, a kill mid-stream re-prefills prompt +
    journal on a survivor and resumes after the last journaled token:
    token-exact, ``resumed_tokens`` a prefix of the fault-free stream, the
    journal collected; per rid the same outputs, failovers and resumed
    tokens as JAX's fleet under the same schedule."""
    jeng, teng = engines
    reqs, ref = reference
    mon = InMemoryMonitor()
    store, router, results = _midstream(PORT, teng, tmp_path, reqs, monitor=mon)
    by = {r.rid: r for r in results}
    assert sorted(by) == sorted(r.rid for r in reqs)
    for rid, r in by.items():
        assert r.finish_reason in ("eos", "length")
        np.testing.assert_array_equal(r.output_ids, ref[rid])
    resumed = [r for r in by.values() if r.resumed_tokens > 0]
    assert router.failovers_total > 0 and resumed
    assert router.resumed_tokens_total >= sum(r.resumed_tokens for r in resumed)
    for r in resumed:
        assert r.failovers > 0 and r.resumed_tokens <= len(r.output_ids)
        np.testing.assert_array_equal(r.output_ids[:r.resumed_tokens],
                                      ref[r.rid][:r.resumed_tokens])
    assert store.list("fleet/requests") == [] and router.journal_bytes() == 0
    h = router.health()
    assert h["journal_entries"] == 0
    assert h["resumed_tokens_total"] == router.resumed_tokens_total
    names = {e[0] for e in mon.events_snapshot()}
    assert {"fleet/journal_bytes", "fleet/resumed_tokens_total"} <= names
    _, jrouter, jresults = _midstream(JAX, jeng, tmp_path, reqs, monitor=JMonitor())
    assert _summary(results) == _summary(jresults)
    assert router.resumed_tokens_total == jrouter.resumed_tokens_total


def test_fleet_sampled_midstream_resume_token_exact(tiny_engine, tmp_path):
    """A sampled stream killed mid-flight resumes token-exact against the
    port's own fault-free run: the journal carries the lane (params, seed,
    ``lane_counter``) and the counter-based draws repeat at every
    continuation position."""
    rng = np.random.default_rng(17)
    reqs = [TS.Request(rid=i, input_ids=rng.integers(1, 250, int(rng.integers(3, 12))
                                                     ).astype(np.int32),
                       max_new_tokens=8,
                       sampling=SamplingParams(temperature=0.9, top_k=20, top_p=0.9,
                                               seed=700 + i))
            for i in range(6)]

    def copies():
        return [TS.Request(rid=r.rid, input_ids=r.input_ids, max_new_tokens=r.max_new_tokens,
                           sampling=r.sampling) for r in reqs]

    ref = {r.rid: r.output_ids for r in tiny_engine.serving(**REF_KW).run(copies())}
    clock = [0.0]
    store = TC.FileCoordinationStore(str(tmp_path / "coord"), clock=lambda: clock[0])
    members = [TF.FleetMember(f"engine{i}",
                              tiny_engine.supervised_serving(max_restarts=5, **SERVE_KW),
                              store, lease_s=1.0) for i in range(3)]
    router = TF.FleetRouter(store, members, lease_s=100.0, miss_limit=3, journal_every_k=1)
    lane_docs = []

    def on_tick(r, rounds):
        clock[0] += 1.0
        if rounds == 3:
            for name in store.list("fleet/requests"):
                doc = store.get(f"fleet/requests/{name}")
                if doc and doc.get("tokens"):
                    lane_docs.append(doc)
            r.members["engine0"].kill()

    results = router.run(copies(), max_ticks=500, on_tick=on_tick)
    assert lane_docs
    for doc in lane_docs:
        assert doc["sampling"]["seed"] >= 700 and doc["sampling"]["temperature"] == 0.9
        assert doc["lane_counter"] == len(doc["input_ids"]) + len(doc["tokens"])
    by = {r.rid: r for r in results}
    assert sorted(by) == sorted(r.rid for r in reqs)
    for rid, r in by.items():
        assert r.finish_reason in ("eos", "length")
        np.testing.assert_array_equal(r.output_ids, ref[rid])
    assert router.failovers_total > 0 and any(r.resumed_tokens > 0 for r in by.values())
    assert store.list("fleet/requests") == []


def test_fleet_journal_cap_bounds_resume(tiny_engine, tmp_path):
    reqs = _stream(4, seed=11, new_choices=(8,))
    ref = {r.rid: r.output_ids for r in tiny_engine.serving(**REF_KW).run(_copies(reqs))}
    clock = [0.0]
    store = TC.FileCoordinationStore(str(tmp_path / "coord"), clock=lambda: clock[0])
    members = [TF.FleetMember(f"engine{i}",
                              tiny_engine.supervised_serving(max_restarts=5, **SERVE_KW),
                              store, lease_s=1.0) for i in range(2)]
    router = TF.FleetRouter(store, members, lease_s=100.0, miss_limit=3, journal_every_k=1,
                            max_journal_tokens=3)

    def on_tick(r, rounds):
        clock[0] += 1.0
        if rounds == 5:
            r.members["engine0"].kill()

    by = {r.rid: r for r in router.run(_copies(reqs), max_ticks=500, on_tick=on_tick)}
    assert sorted(by) == sorted(r.rid for r in reqs)
    for rid, r in by.items():
        np.testing.assert_array_equal(r.output_ids, ref[rid])
        assert r.resumed_tokens <= 3
    assert any(r.resumed_tokens for r in by.values())
    assert store.list("fleet/requests") == []


def test_fleet_finish_straight_from_journal(tiny_engine, tmp_path):
    """A journal holding the whole stream finishes it at failover with no
    decode."""
    store, router = _fleet(tiny_engine, tmp_path, n=2)
    ids = np.array([5, 6, 7], np.int32)
    router.submit(TS.Request(rid="done", input_ids=ids, max_new_tokens=3))
    router.step()
    full = [int(t) for t in tiny_engine.serving(b_slots=2, page_size=8, max_model_len=64).run(
        [TS.Request(rid="done", input_ids=ids, max_new_tokens=3)])[0].output_ids]
    owner = router._owner["done"]
    key = "fleet/requests/sdone"
    doc = dict(store.get(key))
    doc["tokens"] = full
    store.put(key, doc)
    router._journal_docs["done"] = doc
    router._failover(owner, "test kill")
    (res,) = [r for r in router.take_results() if r.rid == "done"]
    assert res.finish_reason == "length" and [int(t) for t in res.output_ids] == full
    assert res.resumed_tokens == len(full) and res.failovers == 1
    assert store.get(key) is None and router.outstanding() == 0


def test_fleet_journal_gc_by_freshly_elected_standby(tiny_engine, tmp_path):
    reqs = _stream(6, seed=13)
    clock = [0.0]
    store = TC.FileCoordinationStore(str(tmp_path / "coord"), clock=lambda: clock[0])
    members = [TF.FleetMember(f"engine{i}",
                              tiny_engine.supervised_serving(max_restarts=5, **SERVE_KW),
                              store, lease_s=100.0) for i in range(2)]
    router = TF.FleetRouter(store, members, lease_s=5.0, journal_every_k=1)
    standby = TF.FleetRouter(store, members, router_id="router1", lease_s=5.0,
                             journal_every_k=1)
    for r in _copies(reqs):
        router.submit(r)
    for _ in range(2):
        router.step()
        clock[0] += 1.0
    assert store.list("fleet/requests")
    router.kill()
    clock[0] += 60.0
    results = list(router.take_results()) + standby.run([], max_ticks=500)
    assert sorted(r.rid for r in results) == sorted(r.rid for r in reqs)
    assert standby.is_coordinator and standby.term == 2
    assert store.list("fleet/requests") == [] and standby.journal_bytes() == 0


def test_fleet_fresh_submit_overwrites_orphaned_journal_entry(tiny_engine, tmp_path):
    clock = [0.0]
    store = TC.FileCoordinationStore(str(tmp_path / "coord"), clock=lambda: clock[0])
    store.put("fleet/requests/i0", {
        "rid": 0, "engine": "engine9", "input_ids": [9, 9, 9], "max_new_tokens": 30,
        "eos_token_id": None, "deadline_s": None, "arrival_epoch_s": 1.0, "failovers": 3,
        "tokens": [7] * 30, "resumed": 0, "t": 0.0})
    members = [TF.FleetMember(f"engine{i}",
                              tiny_engine.supervised_serving(max_restarts=5, **SERVE_KW),
                              store, lease_s=1.0) for i in range(2)]
    router = TF.FleetRouter(store, members, lease_s=100.0, miss_limit=3, journal_every_k=1)
    req = TS.Request(rid=0, input_ids=np.array([4, 5, 6], np.int32), max_new_tokens=6)
    ref = tiny_engine.serving(b_slots=2, page_size=8, max_model_len=64).run(
        [TS.Request(rid=0, input_ids=req.input_ids, max_new_tokens=6)])
    router.submit(req)
    doc = store.get("fleet/requests/i0")
    assert doc["input_ids"] == [4, 5, 6] and doc["failovers"] == 0

    def on_tick(r, rounds):
        clock[0] += 1.0
        if rounds == 2:
            r.members[r._owner[0]].kill()

    (res,) = router.run([], max_ticks=300, on_tick=on_tick)
    np.testing.assert_array_equal(res.output_ids, ref[0].output_ids)
    assert res.resumed_tokens < 30 and store.list("fleet/requests") == []


def test_fleet_journal_write_never_resurrects_collected_entry(tiny_engine, tmp_path):
    store, router = _fleet(tiny_engine, tmp_path, n=2)
    router.submit(TS.Request(rid="r", input_ids=np.array([2, 3, 4], np.int32),
                             max_new_tokens=4))
    router.step()
    key = "fleet/requests/sr"
    assert store.get(key) is not None
    store.delete(key)
    router._journal("r", router._requests["r"], "engine0")
    assert store.get(key) is None and "r" not in router._journal_docs
    router._journal("r", router._requests["r"], "engine1")
    assert store.get(key) is None
    successor_doc = {"rid": "r", "engine": "engine1", "input_ids": [2, 3],
                     "max_new_tokens": 4, "eos_token_id": None, "deadline_s": None,
                     "arrival_epoch_s": 1.0, "failovers": 1, "tokens": [5, 6], "resumed": 0,
                     "t": 2.0}
    store.put(key, successor_doc)
    router._journal_docs.pop("r", None)
    router._journal("r", router._requests["r"], "engine0")
    assert store.get(key) == successor_doc
    router.run([], max_ticks=300)


def test_fleet_reelected_leader_resyncs_tracked_rids(tiny_engine, tmp_path):
    store, router = _fleet(tiny_engine, tmp_path, n=2)
    router.submit(TS.Request(rid="x", input_ids=np.array([5, 6], np.int32), max_new_tokens=8))
    router.step()
    assert router._resumed.get("x") is None
    other = next(e for e in router.members if e != router._owner["x"])
    key = "fleet/requests/sx"
    doc = dict(store.get(key))
    doc.update(tokens=[11, 12, 13], resumed=3, engine=other, failovers=1)
    store.put(key, doc)
    router._take_over(TC.CoordinatorLease(leader_id="router0", term=2, t=router.store.now(),
                                          lease_s=100.0))
    assert router._resumed["x"] == [11, 12, 13]
    adopted = router._journal_docs["x"]
    assert adopted["tokens"] == [11, 12, 13] and adopted["resumed"] == 3
    assert adopted["engine"] == other and adopted["failovers"] == 1
    assert adopted["owner"] == "router0" and adopted["term"] == 2
    assert store.get(key) == adopted
    assert router._failed_over["x"] == 1 and router._owner["x"] == other


def test_fleet_future_arrival_survives_coordinator_death(tiny_engine, tmp_path):
    clock = [0.0]
    store, router = _fleet(tiny_engine, tmp_path, n=2, clock=lambda: clock[0],
                           router_lease=5.0)
    rid = router.submit(TS.Request(rid="late", input_ids=np.array([3, 4, 5], np.int32),
                                   max_new_tokens=3, arrival_time=0.05))
    assert store.get("fleet/requests/slate")["engine"] is None
    router.step()
    router.kill()
    clock[0] += 60.0
    standby = TF.FleetRouter(store, list(router.members.values()), router_id="router1",
                             lease_s=5.0)
    time.sleep(0.1)                                  # the arrival comes due
    (res,) = [r for r in standby.run([], max_ticks=300) if r.rid == rid]
    assert res.finish_reason in ("eos", "length")
    assert store.get("fleet/requests/slate") is None


def test_fleet_rejects_unjournalable_and_duplicate_rids(tiny_engine, tmp_path):
    store, router = _fleet(tiny_engine, tmp_path, n=2)
    with pytest.raises(ValueError, match="str or int"):
        router.submit(TS.Request(rid=(1, 2), input_ids=np.array([1], np.int32)))
    router.submit(TS.Request(rid="a", input_ids=np.array([1, 2], np.int32), max_new_tokens=2))
    with pytest.raises(ValueError, match="unique"):
        router.submit(TS.Request(rid="a", input_ids=np.array([3], np.int32), max_new_tokens=2))
    router.run([], max_ticks=200)


# ---------------------------------------------------------------------------
# Admission, health and the rollups
# ---------------------------------------------------------------------------

def test_fleet_serves_stream_distributed_and_token_exact(tiny_engine, reference, tmp_path):
    reqs, ref = reference
    mon = InMemoryMonitor()
    store, router = _fleet(tiny_engine, tmp_path, monitor=mon)
    by = {r.rid: r for r in router.run(_copies(reqs), max_ticks=500)}
    assert sorted(by) == sorted(r.rid for r in reqs)
    for rid, r in by.items():
        assert r.finish_reason in ("eos", "length") and r.failovers == 0
        np.testing.assert_array_equal(r.output_ids, ref[rid])
    h = router.health()
    assert h["engines_live"] == 3 and h["failovers_total"] == 0
    assert sum(1 for v in h["tokens_by_engine"].values() if v > 0) >= 2
    names = {e[0] for e in mon.events_snapshot()}
    assert {"fleet/engines_live", "fleet/queue_depth", "fleet/failovers_total",
            "fleet/flight_dropped_total"} <= names


def test_fleet_member_advertises_health_through_store(engines, tmp_path):
    """The advertisement carries JAX's keys (a router of either package
    reads it); the lease is on the store."""
    jeng, teng = engines
    docs = {}
    for P, eng in ((PORT, teng), (JAX, jeng)):
        store, router = _fleet(eng, tmp_path, n=2, P=P, name=f"coord_{id(P)}")
        router.submit(P.Request(rid=0, input_ids=np.array([5, 6, 7], np.int32),
                                max_new_tokens=3))
        router.step()
        docs[id(P)] = store.get("fleet/engines/engine0")
        assert store.get("fleet/heartbeat/engine0") is not None
        router.run([], max_ticks=200)
    ad, jad = docs[id(PORT)], docs[id(JAX)]
    for key in ("queue_depth", "active_slots", "usable_slots", "metrics_port",
                "flight_dropped", "monitor_dropped", "restarts", "draining"):
        assert key in ad, key
    assert set(jad) <= set(ad), set(jad) - set(ad)
    for key in ("queue_depth", "active_slots", "usable_slots", "restarts", "draining",
                "page_size", "weight_epoch"):
        assert ad.get(key) == jad.get(key), key


def test_fleet_sheds_by_fleet_queue_depth(tiny_engine, tmp_path):
    store, router = _fleet(tiny_engine, tmp_path, n=2, max_fleet_queue=2)
    by = {r.rid: r for r in router.run(_copies(_stream(12, seed=3, new_choices=(4,))),
                                       max_ticks=500)}
    assert sorted(by) == list(range(12))
    shed = [r for r in by.values() if r.finish_reason == "shed"]
    assert shed and router.shed_total == len(shed)
    assert all(r.retry_after_s and r.retry_after_s > 0 for r in shed)
    assert [r for r in by.values() if r.finish_reason in ("eos", "length")]


def test_fleet_rolling_restart_never_drops_requests(tiny_engine, reference, tmp_path):
    reqs, ref = reference
    store, router = _fleet(tiny_engine, tmp_path)
    for req in _copies(reqs):
        router.submit(req)
    for _ in range(2):
        router.step()
    assert router.rolling_restart(max_ticks=500) == ["engine0", "engine1", "engine2"]
    assert router.rolling_restarts_total == 3 and router.health()["engines_live"] == 3
    by = {r.rid: r for r in router.run([], max_ticks=500)}
    assert sorted(by) == sorted(r.rid for r in reqs)
    for rid, r in by.items():
        np.testing.assert_array_equal(r.output_ids, ref[rid])


def test_serving_fleet_reads_launcher_env_contract(tiny_engine, tmp_path, monkeypatch):
    monkeypatch.setenv("DS_TPU_FLEET_SIZE", "3")
    monkeypatch.setenv("DS_TPU_FLEET_COORD_DIR", str(tmp_path / "env_coord"))
    monkeypatch.setenv("DS_TPU_FLEET_LEASE", "2.5")
    monkeypatch.setenv("DS_TPU_FLEET_MISS_LIMIT", "4")
    router = tiny_engine.serving_fleet(**SERVE_KW)
    assert len(router.members) == 3 and router.miss_limit == 4
    assert all(m.lease_s == 2.5 for m in router.members.values())
    router2 = tiny_engine.serving_fleet(n_engines=2, miss_limit=5,
                                        coord_dir=str(tmp_path / "c2"), **SERVE_KW)
    assert len(router2.members) == 2 and router2.miss_limit == 5
    for key in ("DS_TPU_FLEET_SIZE", "DS_TPU_FLEET_COORD_DIR", "DS_TPU_FLEET_LEASE",
                "DS_TPU_FLEET_MISS_LIMIT"):
        monkeypatch.delenv(key)
    router3 = tiny_engine.serving_fleet(coord_dir=str(tmp_path / "c3"), **SERVE_KW)
    assert len(router3.members) == 2 and router3.miss_limit == 3
    assert all(m.lease_s == 5.0 for m in router3.members.values())
    with pytest.raises(ValueError, match="coord_dir"):
        tiny_engine.serving_fleet(**SERVE_KW)


def test_closing_one_member_leaves_the_others_serving(tiny_engine, reference, tmp_path):
    """Members in one process hold pools and decode programs of their own:
    closing one member's engine (its process gone) releases its pool only;
    the router fails its streams over and the others serve token-exact."""
    reqs, ref = reference
    clock = [0.0]
    router = tiny_engine.serving_fleet(
        n_engines=2, store=TC.FileCoordinationStore(str(tmp_path / "coord"),
                                                    clock=lambda: clock[0]),
        lease_s=1.0, **SERVE_KW)
    victim, other = router.members["engine0"], router.members["engine1"]

    def on_tick(r, rounds):
        clock[0] += 1.0
        if rounds == 2:
            victim.kill()
            victim.sup.engine.close()

    by = {r.rid: r for r in router.run(_copies(reqs), max_ticks=500, on_tick=on_tick)}
    assert not victim.sup.engine._exec.pool_alive() and other.sup.engine._exec.pool_alive()
    assert sorted(by) == sorted(r.rid for r in reqs) and router.failovers_total > 0
    for rid, r in by.items():
        np.testing.assert_array_equal(r.output_ids, ref[rid])
    assert other.sup.engine.page_accounting()["balanced"]


def test_recycle_refuses_undrained_engine(tiny_engine):
    sup = tiny_engine.supervised_serving(**SERVE_KW)
    sup.submit(TS.Request(rid=0, input_ids=np.array([1, 2, 3], np.int32), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="drained"):
        sup.recycle()
    sup.run([], max_ticks=200)
    assert sup.recycle() in (True, False)
    assert sup.restarts == 0


def test_fleet_gauges_reach_prometheus_exposition(tiny_engine, tmp_path):
    mon = InMemoryMonitor()
    store, router = _fleet(tiny_engine, tmp_path, n=2, monitor=mon)
    router.run(_stream(4, seed=5), max_ticks=500)
    text = prometheus_text(monitor=mon)
    for gauge in ("dstpu_fleet_engines_live", "dstpu_fleet_queue_depth",
                  "dstpu_fleet_failovers_total", "dstpu_fleet_flight_dropped_total",
                  "dstpu_fleet_journal_bytes", "dstpu_fleet_resumed_tokens_total",
                  "dstpu_fleet_alerts_firing"):
        assert gauge in text, gauge


def test_fleet_rolls_up_firing_slo_alerts(tiny_engine, tmp_path):
    mon = InMemoryMonitor()
    store = TC.FileCoordinationStore(str(tmp_path / "coord"))

    def rules():
        return [SloRule.parse("serve/queue_depth < 0", name="qd0"),
                SloRule.parse("serve/queue_depth < 1e9", name="qd9")]

    members = [TF.FleetMember(f"engine{i}",
                              tiny_engine.supervised_serving(monitor=InMemoryMonitor(),
                                                             slo_rules=rules(), **SERVE_KW),
                              store, lease_s=100.0) for i in range(2)]
    router = TF.FleetRouter(store, members, lease_s=100.0, miss_limit=3, monitor=mon)
    router.run(_stream(6, seed=2), max_ticks=500)
    for m in members:
        m.beat(force=True)
    firing = router.health()["alerts_firing"]
    assert firing and all(rule == "qd0" for _eid, rule in firing)
    for eid in {eid for eid, _rule in firing}:
        assert store.get(f"fleet/engines/{eid}")["alerts_firing"] == ["qd0"]
    router._write_gauges()
    assert mon.latest("fleet/alerts_firing") == float(len(firing))


def test_fleet_journal_flush_ms_time_based_cadence(tiny_engine, tmp_path):
    clock = [0.0]
    store = TC.FileCoordinationStore(str(tmp_path / "coord"), clock=lambda: clock[0])
    members = [TF.FleetMember("engine0", tiny_engine.supervised_serving(max_restarts=5,
                                                                        **SERVE_KW),
                              store, lease_s=100.0)]
    router = TF.FleetRouter(store, members, lease_s=100.0, journal_every_k=None,
                            journal_flush_ms=2000.0)
    results = router.run(_copies(_stream(2, seed=31, new_choices=(8,))), max_ticks=500,
                         on_tick=lambda r, n: clock.__setitem__(0, clock[0] + 1.0))
    assert len(results) == 2 and router.journal_flushes_total >= 2
    lats = router.journal_cas_latencies()
    assert lats and all(t >= 0 for t in lats)
    assert router.health()["journal_flushes_total"] == router.journal_flushes_total
    with pytest.raises(ValueError, match="journal_flush_ms"):
        TF.FleetRouter(store, members, journal_flush_ms=0.0)


# ---------------------------------------------------------------------------
# Prefix affinity and adapters
# ---------------------------------------------------------------------------

def test_fleet_prefix_affinity_routes_to_resident_engine_then_failover(tiny_engine, tmp_path):
    rng = np.random.default_rng(23)
    system = rng.integers(1, 250, 17).astype(np.int32)
    donor = TS.Request(rid="donor", input_ids=np.concatenate([system, [3, 4]]).astype(np.int32),
                       max_new_tokens=3)
    follower = TS.Request(rid="follower",
                          input_ids=np.concatenate([system, [9, 8, 7]]).astype(np.int32),
                          max_new_tokens=8)
    filler = TS.Request(rid="filler", input_ids=rng.integers(1, 250, 6).astype(np.int32),
                        max_new_tokens=8)

    def fresh(r):
        return TS.Request(rid=r.rid, input_ids=r.input_ids, max_new_tokens=r.max_new_tokens)

    ref = {r.rid: r.output_ids for r in tiny_engine.serving(**REF_KW).run(
        [fresh(r) for r in (donor, follower, filler)])}
    clock = [0.0]
    store = TC.FileCoordinationStore(str(tmp_path / "coord"), clock=lambda: clock[0])
    mon = InMemoryMonitor()
    members = [TF.FleetMember(f"engine{i}",
                              tiny_engine.supervised_serving(max_restarts=5, **SERVE_KW),
                              store, lease_s=1.0) for i in range(2)]
    router = TF.FleetRouter(store, members, lease_s=100.0, miss_limit=3, journal_every_k=1,
                            monitor=mon)

    def tick(n=1):
        for _ in range(n):
            router.step()
            clock[0] += 1.0

    router.submit(fresh(donor))
    assert router._owner["donor"] == "engine0"
    while router.outstanding():
        tick()
    doc = store.get(f"{TF.FLEET_RESIDENCY_PREFIX}/engine0")
    keys = chain_keys(donor.input_ids, 8, limit=len(donor.input_ids) - 1)
    assert keys and all(k in {int(dk) for dk, _ in doc["digest"]} for k in keys)
    router.submit(fresh(filler))
    assert router._owner["filler"] == "engine0"
    router.submit(fresh(follower))
    assert router._owner["follower"] == "engine0" and router.affinity_routes_total >= 1
    tick(3)
    router.members["engine0"].kill()
    results = {r.rid: r for r in router.run(
        [], max_ticks=500, on_tick=lambda r, n: clock.__setitem__(0, clock[0] + 1.0))}
    for rid in ("donor", "filler", "follower"):
        np.testing.assert_array_equal(results[rid].output_ids if rid in results else ref[rid],
                                      ref[rid])
    assert results["follower"].failovers >= 1 and results["follower"].resumed_tokens > 0
    assert router._owner.get("follower") is None and store.list("fleet/requests") == []
    names = {e[0] for e in mon.events_snapshot()}
    assert {"fleet/residency_entries", "fleet/residency_demoted_pages",
            "fleet/residency_host_bytes", "fleet/affinity_routes_total",
            "fleet/residency_promotions_total"} <= names


def test_fleet_affinity_respects_load_slack(tiny_engine, tmp_path):
    store = TC.FileCoordinationStore(str(tmp_path / "coord"))
    members = [TF.FleetMember(f"engine{i}",
                              tiny_engine.supervised_serving(max_restarts=5, **SERVE_KW),
                              store, lease_s=100.0) for i in range(2)]
    router = TF.FleetRouter(store, members, lease_s=100.0, affinity_load_slack=0)
    rng = np.random.default_rng(29)
    system = rng.integers(1, 250, 17).astype(np.int32)
    router.submit(TS.Request(rid="donor", input_ids=np.concatenate([system, [1, 2]]).astype(
        np.int32), max_new_tokens=2))
    while router.outstanding():
        router.step()
    router.submit(TS.Request(rid="busy", input_ids=rng.integers(1, 250, 5).astype(np.int32),
                             max_new_tokens=4))
    assert router._owner["busy"] == "engine0"
    router.submit(TS.Request(rid="follower", input_ids=np.concatenate([system, [7, 7]]).astype(
        np.int32), max_new_tokens=2))
    assert router._owner["follower"] == "engine1"
    router.run([], max_ticks=200)


PROMPT = np.arange(5, 14, dtype=np.int32)
SAMPLED = SamplingParams(temperature=0.8, top_k=16, top_p=0.9, seed=11)


@pytest.fixture(scope="module")
def registry(tiny_engine):
    """Two tenants with non-zero A and B (rank 4 and 8)."""
    layers = tiny_engine.params["layers"]
    reg = AdapterRegistry(layers)
    for i, (aid, rank) in enumerate((("acme", 4), ("globex", 8))):
        rng = np.random.default_rng(40 + i)
        lora = {}
        for t in ("wq", "wk", "wv", "wo"):
            L, d_in, d_out = (int(s) for s in layers[t].shape)
            lora[t] = {"A": (rng.standard_normal((L, d_in, rank)) / np.sqrt(rank)
                             ).astype(np.float32),
                       "B": (rng.standard_normal((L, rank, d_out)) * 0.05).astype(np.float32)}
        reg.register(aid, lora, LoRAConfig(rank=rank, alpha=2.0 * rank))
    return reg


def test_fleet_failover_resumes_token_exact_under_same_adapter(tiny_engine, registry,
                                                               tmp_path):
    """An adapter-tagged sampled stream killed mid-flight resumes under the
    same adapter (the journal carries ``adapter_id``)."""
    reqs = [TS.Request(rid="g", input_ids=PROMPT.copy(), max_new_tokens=10, adapter_id="acme"),
            TS.Request(rid="s", input_ids=PROMPT.copy(), max_new_tokens=10,
                       adapter_id="globex", sampling=SAMPLED),
            TS.Request(rid="b", input_ids=PROMPT.copy(), max_new_tokens=6)]

    def copies():
        return [TS.Request(rid=r.rid, input_ids=r.input_ids, max_new_tokens=r.max_new_tokens,
                           sampling=r.sampling, adapter_id=r.adapter_id) for r in reqs]

    ref = {r.rid: r.output_ids
           for r in tiny_engine.serving(adapters=registry, **SERVE_KW).run(copies())}
    clock = [0.0]
    store = TC.FileCoordinationStore(str(tmp_path / "coord"), clock=lambda: clock[0])
    members = [TF.FleetMember(f"engine{i}", tiny_engine.supervised_serving(
        max_restarts=5, adapters=registry, **SERVE_KW), store, lease_s=1.0) for i in range(2)]
    router = TF.FleetRouter(store, members, lease_s=100.0, miss_limit=3, journal_every_k=1)
    state = {"journal_adapters": None, "killed": None}

    def on_tick(r, rounds):
        clock[0] += 1.0
        if rounds == 3 and state["journal_adapters"] is None:
            docs = [store.get(f"fleet/requests/{k}") for k in store.list("fleet/requests")]
            state["journal_adapters"] = {d["rid"]: d.get("adapter_id") for d in docs if d}
        if rounds == 4 and state["killed"] is None:
            victim = r._owner.get("g") or r._owner.get("s")
            if victim:
                r.members[victim].kill()
                state["killed"] = victim

    results = router.run(copies(), max_ticks=600, on_tick=on_tick)
    by = {r.rid: r for r in results}
    assert state["killed"] is not None
    assert state["journal_adapters"]["g"] == "acme"
    assert state["journal_adapters"]["s"] == "globex"
    assert sorted(by) == ["b", "g", "s"]
    for rid, res in by.items():
        assert res.finish_reason == "length"
        np.testing.assert_array_equal(res.output_ids, ref[rid])
    failed_over = [r for r in results if r.failovers]
    assert failed_over and any(r.resumed_tokens for r in failed_over)
    assert by["g"].adapter_id == "acme" and by["s"].adapter_id == "globex"
    h = router.health()
    assert h["adapter_routes_total"] >= 1
    for eid, ad in h["engines"].items():
        if ad:
            assert ad["adapters_loaded"] == registry.loaded()


def test_fleet_router_skips_fused_exclusive_member(tiny_engine, registry, tmp_path):
    store = TC.FileCoordinationStore(str(tmp_path / "coord"))
    members = [TF.FleetMember(f"engine{i}", tiny_engine.supervised_serving(
        max_restarts=5, adapters=registry, **SERVE_KW), store, lease_s=100.0)
        for i in range(2)]
    members[0].sup.engine.fuse_adapter("acme")
    router = TF.FleetRouter(store, members, lease_s=100.0, miss_limit=3)
    results = router.run(
        [TS.Request(rid="b", input_ids=PROMPT.copy(), max_new_tokens=4),
         TS.Request(rid="g", input_ids=PROMPT.copy(), max_new_tokens=4, adapter_id="globex"),
         TS.Request(rid="a", input_ids=PROMPT.copy(), max_new_tokens=4, adapter_id="acme")],
        max_ticks=300)
    by = {r.rid: r for r in results}
    assert all(r.finish_reason == "length" for r in results)
    assert router.tokens_by_engine["engine1"] > 0
    assert by["b"].output_ids.size and by["g"].output_ids.size


def test_fleet_sheds_fleetwide_unknown_adapter(tiny_engine, tmp_path):
    mon = InMemoryMonitor()
    store, router = _fleet(tiny_engine, tmp_path, n=2, monitor=mon)
    by = {r.rid: r for r in router.run(
        [TS.Request(rid=0, input_ids=np.array([5, 6, 7], np.int32), max_new_tokens=3),
         TS.Request(rid=1, input_ids=np.array([5, 6, 7], np.int32), max_new_tokens=3,
                    adapter_id="nobody")], max_ticks=300)}
    assert by[0].finish_reason in ("eos", "length")
    assert by[1].finish_reason == "adapter_unknown"
    assert by[1].retry_after_s and by[1].retry_after_s > 0
    assert router.adapter_unknown_total == 1
    assert router.health()["adapter_unknown_total"] == 1
    ad = store.get("fleet/adapters/engine0")
    assert ad is not None and "adapters_loaded" in ad and "fused_adapter_id" in ad

    class _Reg:
        def loaded(self):
            return ["acme"]

    eng = router.members["engine0"].sup.engine
    eng.adapters = _Reg()
    try:
        assert router._adapter_known_fleetwide("acme")
        assert not router._adapter_known_fleetwide("nobody")
    finally:
        eng.adapters = None
    assert "fleet/adapter_unknown_total" in {e[0] for e in mon.events_snapshot()}


# ---------------------------------------------------------------------------
# Sharded admission and weight-epoch flips
# ---------------------------------------------------------------------------

def test_sharded_admission_follower_admits_coordinator_serves(tiny_engine, reference,
                                                              tmp_path):
    store = TC.FileCoordinationStore(str(tmp_path / "coord"))
    members = [TF.FleetMember(f"engine{i}",
                              tiny_engine.supervised_serving(max_restarts=5, **SERVE_KW),
                              store, lease_s=100.0) for i in range(2)]
    coord = TF.FleetRouter(store, members, router_id="r0", lease_s=100.0,
                           admission_partitions=2)
    follower = TF.FleetRouter(store, members, router_id="r1", lease_s=100.0,
                              admission_partitions=2)
    coord.step()
    assert coord.is_coordinator
    reqs, ref = reference
    with pytest.raises(TF.FleetWrongPartition):
        follower.admit(_copies(reqs[:1])[0])
    for _ in range(6):
        follower.step()
        if len(follower._my_partitions) == 2:
            break
    assert follower._my_partitions == {0, 1}
    coord.admit(_copies(reqs[4:5])[0])
    assert coord.outstanding() == 1
    for r in _copies(reqs[:4]):
        follower.admit(r)
    assert follower.partition_admissions_total == 4 and follower.outstanding() == 0
    results = coord.run([], max_ticks=2000, on_tick=lambda r, n: follower.step())
    assert sorted(r.rid for r in results) == sorted(r.rid for r in reqs[:5])
    for r in results:
        np.testing.assert_array_equal(r.output_ids, ref[r.rid])
    assert coord.adopted_admissions_total == 4 and store.list("fleet/requests") == []
    h = coord.health()
    assert h["admission_partitions"] == 2 and h["adopted_admissions_total"] == 4


def test_router_death_reassigns_partitions(tiny_engine, tmp_path):
    clock = [0.0]
    store = TC.FileCoordinationStore(str(tmp_path / "coord"), clock=lambda: clock[0])
    members = [TF.FleetMember("engine0", tiny_engine.supervised_serving(max_restarts=5,
                                                                        **SERVE_KW),
                              store, lease_s=100.0)]

    def mk(rid):
        return TF.FleetRouter(store, members, router_id=rid, lease_s=2.0, miss_limit=3,
                              admission_partitions=3)

    coord, f1, f2 = mk("r0"), mk("r1"), mk("r2")
    coord.step()
    assert coord.is_coordinator
    for _ in range(12):
        f1.step()
        f2.step()
        clock[0] += 0.1
        if len(f1._my_partitions) + len(f2._my_partitions) == 3:
            break
    assert len(f1._my_partitions) + len(f2._my_partitions) == 3
    lost = set(f1._my_partitions)
    clock[0] += 2.0 * 3 + 1.0
    for _ in range(10):
        coord.step()
        f2.step()
        clock[0] += 0.7
        if lost <= f2._my_partitions:
            break
    assert lost <= f2._my_partitions
    assert "r1" in TC.dead_set(store, prefix="fleet/router_dead")


def test_epoch_flip_holds_admission_until_committed(tiny_engine, reference, tmp_path):
    store, router = _fleet(tiny_engine, tmp_path, n=2)
    router.step()
    assert router.is_coordinator and router.fleet_epoch == 0
    assert router.begin_epoch_flip(None) == 1
    reqs, ref = reference
    router.submit(_copies(reqs[:1])[0])
    assert len(router._flip_hold) == 1
    assert all(m.outstanding() == 0 for m in router.members.values())
    for _ in range(20):
        router.step()
        if router._flip is None:
            break
    assert router.fleet_epoch == 1 and router.epoch_flips_total == 1
    assert all(m.weight_epoch() == 1 for m in router.members.values())
    assert store.get("fleet/epoch/current")["epoch"] == 1
    results = router.run([], max_ticks=500)
    assert len(results) == 1
    np.testing.assert_array_equal(results[0].output_ids, ref[reqs[0].rid])
    h = router.health()
    assert h["fleet_epoch"] == 1 and not h["epoch_flip_in_progress"]


def test_epoch_flip_member_death_midprepare_does_not_wedge(tiny_engine, reference, tmp_path):
    clock = [0.0]
    store, router = _fleet(tiny_engine, tmp_path, n=2, clock=lambda: clock[0],
                           member_lease=1.0)
    router.step()
    reqs, ref = reference
    req = _copies(reqs[:1])[0]
    router.submit(req)
    victim = router._owner[req.rid]
    router.begin_epoch_flip(None)
    router.members[victim].kill()
    clock[0] += 1.0 * 3 + 1.0
    for _ in range(50):
        router.step()
        clock[0] += 0.5
        if router._flip is None:
            break
    assert router._flip is None and router.fleet_epoch == 1
    survivor = next(eid for eid in router.members if eid != victim)
    assert router.members[survivor].weight_epoch() == 1
    results = router.run([], max_ticks=1000)
    assert [r.rid for r in results] == [req.rid] and results[0].failovers == 1
    np.testing.assert_array_equal(results[0].output_ids, ref[req.rid])


def test_epoch_flip_successor_adopts_orphaned_flip(tiny_engine, tmp_path):
    clock = [0.0]
    store = TC.FileCoordinationStore(str(tmp_path / "coord"), clock=lambda: clock[0])
    members = [TF.FleetMember("engine0", tiny_engine.supervised_serving(max_restarts=5,
                                                                        **SERVE_KW),
                              store, lease_s=100.0)]
    A = TF.FleetRouter(store, members, router_id="rA", lease_s=2.0, miss_limit=3)
    B = TF.FleetRouter(store, members, router_id="rB", lease_s=2.0, miss_limit=3)
    A.step()
    assert A.is_coordinator
    A.begin_epoch_flip(None, epoch=5)
    clock[0] += 2.0 * 3 + 1.0
    for _ in range(50):
        B.step()
        clock[0] += 0.5
        if B.is_coordinator and B._flip is None:
            break
    assert B.is_coordinator and B.term == 2 and B.fleet_epoch == 5
    assert members[0].weight_epoch() == 5 and store.get("fleet/epoch/flip") is None


def test_epoch_flip_with_new_weights_serves_them_fleetwide(tiny_engine, tmp_path):
    """``begin_epoch_flip(params)`` hands each member the new tree through
    ``prepare_epoch`` (the supervised engine's ``update_params``): after the
    commit every member serves the new weights, token-equal to an engine
    built on them."""
    new = dict(tiny_engine.params, lm_head=tiny_engine.params["lm_head"] * -1.0)
    store, router = _fleet(tiny_engine, tmp_path, n=2)
    router.step()
    assert router.begin_epoch_flip(new) == 1
    for _ in range(20):
        router.step()
        if router._flip is None:
            break
    assert router.fleet_epoch == 1
    reqs = _stream(4, seed=41)
    got = {r.rid: r.output_ids for r in router.run(_copies(reqs), max_ticks=500)}
    flipped = deepspeed_tpu_torch.init_inference(
        CausalLM("tiny", dtype=torch.float32), config={"dtype": "float32"}, device="cpu",
        params=new)
    want = {r.rid: r.output_ids for r in flipped.serving(**REF_KW).run(_copies(reqs))}
    old = {r.rid: r.output_ids for r in tiny_engine.serving(**REF_KW).run(_copies(reqs))}
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert any(not np.array_equal(want[rid], old[rid]) for rid in want)
    assert all(m.weight_epoch() == 1 for m in router.members.values())


# ---------------------------------------------------------------------------
# Tracing, SLO rules, a partitioned coordinator
# ---------------------------------------------------------------------------

def _trace_stream(n, seed, plen, new):
    rng = np.random.default_rng(seed)
    return [TS.Request(rid=i, input_ids=rng.integers(1, 250, int(rng.integers(*plen))
                                                     ).astype(np.int32),
                       max_new_tokens=int(rng.integers(*new))) for i in range(n)]


def test_fleet_failover_continues_one_trace_and_assembles_two_tracks(tiny_engine, tmp_path):
    configure_tracer(enabled=True, capacity=1 << 15)
    get_tracer().reset()
    try:
        clock = [0.0]
        store = TC.FileCoordinationStore(str(tmp_path / "coord"), clock=lambda: clock[0])
        members = [TF.FleetMember(f"engine{i}", tiny_engine.supervised_serving(**SERVE_KW),
                                  store, lease_s=1.0) for i in range(2)]
        for m in members:
            m.trace_publish_interval_s = 0.0
        router = TF.FleetRouter(store, members, lease_s=100.0, miss_limit=3,
                                journal_every_k=2)
        router.trace_publish_interval_s = 0.0

        def on_tick(r, rounds):
            clock[0] += 1.0
            if rounds == 4 and r.members["engine0"].alive:
                r.members["engine0"].kill()
                r._failover("engine0", "test kill")

        results = router.run(_trace_stream(4, 2, (5, 10), (8, 10)), max_ticks=4000,
                             on_tick=on_tick)
        failed_over = [r for r in results if r.failovers]
        assert failed_over
        for r in failed_over:
            events = [e[0] for e in r.lifecycle]
            assert r.trace_id and "failover" in events
            assert all(e[2] == "engine0" for e in r.lifecycle if e[0] == "failover")
            if r.resumed_tokens:
                assert "resume" in events
        for m in members:
            if m.alive:
                m.publish_trace_segments(force=True)
        router.publish_trace_segments(force=True)
        doc = assemble_fleet_trace(load_segments(store))
    finally:
        configure_tracer(enabled=False)
        get_tracer().reset()
    owners = doc["otherData"]["owners"]
    assert "router0" in owners and "engine1" in owners
    evs = events_for_trace(doc, failed_over[0].trace_id)
    assert len({e["pid"] for e in evs}) >= 2
    stamps = [e["ts"] for e in evs]
    assert stamps == sorted(stamps)
    router_pid = owners.index("router0") + 1
    names = {e["name"] for e in doc["traceEvents"]
             if e.get("ph") == "X" and e["pid"] == router_pid}
    assert {"fleet.tick", "fleet.failover"} <= names


def test_fleet_journal_carries_trace_id_for_takeover(tiny_engine, tmp_path):
    store = TC.FileCoordinationStore(str(tmp_path / "coord"))
    members = [TF.FleetMember("engine0", tiny_engine.supervised_serving(**SERVE_KW), store,
                              lease_s=100.0)]
    router = TF.FleetRouter(store, members, lease_s=100.0)
    router.submit(TS.Request(rid=1, input_ids=np.arange(1, 9, dtype=np.int32),
                             max_new_tokens=40, arrival_time=5.0))
    doc = store.get("fleet/requests/i1")
    assert doc is not None and doc["trace_id"]
    standby = TF.FleetRouter(store, members, router_id="router1", lease_s=100.0)
    standby.is_coordinator = False
    standby._take_over(TC.CoordinatorLease("router1", 2, 0.0, 100.0))
    assert standby._requests[1].trace_id == doc["trace_id"]


def test_router_slo_rules_fire_on_fleet_gauges(tiny_engine, tmp_path):
    mon = InMemoryMonitor()
    store = TC.FileCoordinationStore(str(tmp_path / "coord"))
    members = [TF.FleetMember("engine0", tiny_engine.supervised_serving(**SERVE_KW), store,
                              lease_s=100.0)]
    router = TF.FleetRouter(
        store, members, lease_s=100.0, monitor=mon,
        slo_rules=[SloRule.parse("fleet/engines_live > 5", name="enough_engines"),
                   SloRule.parse("fleet/journal_bytes < 1048576", name="journal_small")])
    router.run(_stream(2, seed=4), max_ticks=500)
    assert router.router_alerts() == ["enough_engines"]
    h = router.health()
    assert h["router_alerts"] == ["enough_engines"]
    assert h["router_slo_states"]["journal_small"]["firing"] is False
    text = prometheus_text(monitor=mon)
    assert 'dstpu_alert{rule="enough_engines"} 1' in text
    assert 'dstpu_alert{rule="journal_small"} 0' in text
    assert "dstpu_fleet_trace_spans_published_total" in text


def test_partitioned_coordinator_self_fences_and_parks(tiny_engine, tmp_path):
    """A partitioned coordinator fences itself within a lease of its last
    renewal (no dispatch, admissions parked, GC deferred without a store
    op) and stands down the fence once the store answers."""
    clock = [0.0]
    backend = TC.FileCoordinationStore(str(tmp_path / "coord"), clock=lambda: clock[0])
    view = FaultyStore(backend, client="r0")
    member = TF.FleetMember("engine0", tiny_engine.supervised_serving(max_restarts=2,
                                                                      **SERVE_KW),
                            backend, lease_s=10.0)
    member.beat(force=True)
    router = TF.FleetRouter(view, [member], router_id="r0", lease_s=1.0, journal_every_k=1)
    router.step()
    assert router.is_coordinator and not router.self_fenced
    router.submit(TS.Request(rid="a", input_ids=np.arange(1, 6, dtype=np.int32),
                             max_new_tokens=4))
    router.step()
    disp0 = router.dispatches_total
    assert disp0 >= 1
    view.partitioned = True
    for _ in range(30):
        router.step()
        clock[0] += 0.1
        if router.self_fenced:
            break
    assert router.self_fenced and router.is_coordinator and router.fences_total == 1
    router.submit(TS.Request(rid="b", input_ids=np.arange(1, 6, dtype=np.int32),
                             max_new_tokens=4))
    for _ in range(10):
        router.step()
        clock[0] += 0.1
    assert router.dispatches_total == disp0
    assert [req.rid for req, _requeue in router._parked] == ["b"]
    ops0 = view.ops_total
    router._journal_delete("a")
    router._flush_token_journal()
    assert view.ops_total == ops0 and "a" in router._pending_gc
    assert router.health()["self_fenced"] == 1
    view.partitioned = False
    for _ in range(30):
        router.step()
        clock[0] += 0.1
        if not router._parked and not router._pending_gc:
            break
    assert not router.self_fenced and router.is_coordinator
    assert router.dispatches_total > disp0
    assert {r.rid for r in router.run([], max_ticks=2000)} == {"a", "b"}


# ---------------------------------------------------------------------------
# One store directory, two packages
# ---------------------------------------------------------------------------

def test_port_router_finishes_what_a_jax_router_journaled(engines, reference, tmp_path):
    """A JAX router over JAX members journals the stream and dies with its
    members mid-stream; a port router on the same directory, with proxies
    for the dead members and two port members, adopts the JAX journal,
    fails the dead members' streams over (resuming after the JAX-journaled
    tokens) and finishes every stream token-exactly."""
    jeng, teng = engines
    reqs, ref = reference
    clock = [0.0]
    coord = str(tmp_path / "coord")
    jstore = JC.FileCoordinationStore(coord, clock=lambda: clock[0])
    jmembers = [JF.FleetMember(f"engine{i}", jeng.supervised_serving(max_restarts=5,
                                                                      **SERVE_KW),
                               jstore, lease_s=1.0) for i in range(2)]
    jrouter = JF.FleetRouter(jstore, jmembers, lease_s=5.0, miss_limit=3, journal_every_k=1)
    for r in _copies(reqs, JS.Request):
        jrouter.submit(r)
    for _ in range(3):
        jrouter.step()
        clock[0] += 0.5
    done_by_jax = {r.rid: r for r in jrouter.take_results()}
    journaled = {d: jstore.get(f"fleet/requests/{d}") for d in jstore.list("fleet/requests")}
    assert any(doc.get("tokens") for doc in journaled.values())
    jrouter.kill()
    for m in jmembers:
        m.kill()
    clock[0] += 30.0
    store = TC.FileCoordinationStore(coord, clock=lambda: clock[0])
    members = [StoreMemberProxy(f"engine{i}", store, router_id="router1", lease_s=1.0)
               for i in range(2)]
    members += [TF.FleetMember(f"engine{i}", teng.supervised_serving(max_restarts=5,
                                                                     **SERVE_KW),
                               store, lease_s=1.0) for i in (2, 3)]
    router = TF.FleetRouter(store, members, router_id="router1", lease_s=5.0, miss_limit=3,
                            journal_every_k=1)
    results = router.run([], max_ticks=2000,
                         on_tick=lambda r, n: clock.__setitem__(0, clock[0] + 0.5))
    by = {r.rid: r for r in results}
    assert sorted(set(by) | set(done_by_jax)) == sorted(r.rid for r in reqs)
    assert not set(by) & set(done_by_jax)
    for rid, r in by.items():
        assert r.finish_reason in ("eos", "length")
        np.testing.assert_array_equal(r.output_ids, ref[rid])
    assert router.term == 2 and sorted(router._failed_engines) == ["engine0", "engine1"]
    assert any(r.resumed_tokens > 0 for r in by.values())
    assert store.list("fleet/requests") == []


# ---------------------------------------------------------------------------
# The chaos soak (tests/_torch_fleet_soak.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def soak_params():
    """The JAX soak's weights (``PRNGKey(0)``), carried over."""
    jmodel = JaxCausalLM("tiny", dtype=jnp.float32, attn_impl="xla")
    return params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                  jmodel.init_fn(jax.random.PRNGKey(0))), "cpu")


def test_fleet_chaos_soak_seed_matches_jax(soak_params, tmp_path):
    """Seed 3 of ``chaos_soak --mode fleet`` (a lease kill mid-stream with
    journaled batches outstanding) on the JAX soak's weights: the port's
    statistics equal the JAX soak's, and its greedy streams equal the JAX
    reference (sampled ones are held to the port's own fault-free run)."""
    import sys

    sys.path.insert(0, str(soak.ROOT) + "/tools")
    try:
        from chaos_soak import run_fleet_soak as jax_soak
    finally:
        sys.path.remove(str(soak.ROOT) + "/tools")
    got = soak.run_fleet_soak(seed=3, coord_dir=str(tmp_path / "port"), n_requests=8,
                              params=soak_params)
    want = jax_soak(seed=3, coord_dir=str(tmp_path / "jax"), n_requests=8, verbose=False)
    for key in ("kill_mode", "victim", "killed_coordinator", "dead_engines", "terminal",
                "failovers", "resumed_results", "resumed_tokens", "final_term",
                "final_generation", "parity_checked", "sampled_resumed_results",
                "adapter_resumed_results"):
        assert got[key] == want[key], (key, got[key], want[key])


@pytest.mark.parametrize("seed,mode,coordinator", [(1, "lease", True), (4, "budget", False),
                                                   (3, "lease", False), (7, "lease", False)])
def test_fleet_chaos_soak_deterministic_seed(seed, mode, coordinator, tmp_path):
    """The JAX package's pinned seeds: 1 (a lease kill and the coordinator),
    4 (a restart budget exhausted), 3 (mid-stream resume), 7 (sampled
    streams resumed)."""
    stats = soak.run_fleet_soak(seed=seed, coord_dir=str(tmp_path / "coord"), n_requests=8)
    assert stats["kill_mode"] == mode and stats["killed_coordinator"] == coordinator
    assert stats["terminal"] == 8 == stats["parity_checked"]
    assert stats["failovers"] > 0
    if coordinator:
        assert stats["final_term"] == 2 and stats["dead_engines"] == ["engine0"]
    if seed in (3, 7):
        assert stats["resumed_results"] > 0 and stats["resumed_tokens"] > 0
    if seed == 7:
        assert stats["sampled_parity_checked"] > 0 and stats["sampled_resumed_results"] > 0


@pytest.mark.parametrize("seed", [0, 2, 5])
def test_fleet_chaos_soak_other_seeds(seed, tmp_path):
    stats = soak.run_fleet_soak(seed=seed, coord_dir=str(tmp_path / "coord"), n_requests=8)
    assert stats["terminal"] == 8 == stats["parity_checked"]


def test_fleet_chaos_soak_trace_assembly_pinned_seed(tmp_path):
    """Seed 3 with the tracer on: each failed-over stream is one trace on
    the victim's and a survivor's tracks, in order."""
    stats = soak.run_fleet_soak(seed=3, coord_dir=str(tmp_path / "coord"), n_requests=8,
                                collect_traces=str(tmp_path / "trace"))
    assert stats["kill_mode"] == "lease" and stats["resumed_tokens"] > 0
    assert stats["trace_rids_checked"] > 0 and stats["trace_two_track_rids"] > 0
    assert stats["trace_spans_assembled"] > 0
