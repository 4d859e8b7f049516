"""The port's store fault proxy (``deepspeed_tpu_torch/elasticity/
store_faults.py``) and retry policy against the JAX package's.

Held against ``deepspeed_tpu``: the same rule specs and seeds over the same
op sequence fire the same faults (kind, op and call) in both packages, the
environment's rule lists parse alike (and refuse alike).  The port's own:
latency counted into the percentiles, the partition toggle, stale reads,
torn writes quarantined and recovered, the retry policy absorbing transient
faults and failing fast on a dark store, and a watchdog that never declares
a peer dead from a failed scan.
"""
import json

import pytest

from deepspeed_tpu.elasticity import coordination as JC
from deepspeed_tpu.elasticity import store_faults as JF

from deepspeed_tpu_torch.elasticity import coordination as TC
from deepspeed_tpu_torch.elasticity import store_faults as TF
from deepspeed_tpu_torch.resilience import clear_injector


@pytest.fixture(autouse=True)
def _clean_injector():
    clear_injector()
    yield
    clear_injector()


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


SPECS = {
    "coin-get": [{"ops": ["get"], "kind": "error", "probability": 0.5, "seed": 7}],
    "coin-put-seed8": [{"ops": ["put", "cas"], "kind": "timeout", "probability": 0.3,
                        "seed": 8}],
    "every-3rd-list": [{"ops": "list", "kind": "error", "every": 3}],
    "at-call-cas": [{"ops": ["cas"], "kind": "error", "at_call": 4},
                    {"ops": "*", "kind": "error", "probability": 0.1, "seed": 3,
                     "max_fires": 5}],
    "window": [{"kind": "blackout", "from_t": 103.0, "until_t": 106.0}],
    "prefix-client": [{"ops": ["get", "put"], "kind": "error", "key_prefix": "fleet/",
                       "client": "c", "probability": 0.7, "seed": 1},
                      {"ops": ["get"], "kind": "stale_read", "every": 2, "seed": 2}],
    "torn": [{"ops": ["put"], "kind": "torn_write", "every": 4}],
}


def _program(cmod, fmod, tmp_path, specs):
    """One op sequence through a FaultyStore; the outcome of each op."""
    clock = Clock()
    inner = cmod.FileCoordinationStore(str(tmp_path), clock=clock)
    store = fmod.FaultyStore(inner, client="c",
                             rules=[fmod.StoreFaultRule.from_spec(s) for s in specs])
    out = []
    for i in range(60):
        clock.t = 100.0 + i * 0.25
        key = ("fleet/" if i % 3 else "pod/") + f"k{i % 5}"
        op = ("get", "put", "cas", "list", "delete", "compare_delete")[i % 6]
        try:
            if op == "get":
                res = store.get(key)
            elif op == "put":
                res = store.put(key, {"i": i})
            elif op == "cas":
                res = store.compare_and_swap(key, store.inner.get(key), {"i": i})
            elif op == "list":
                res = store.list("fleet")
            elif op == "delete":
                res = store.delete(key)
            else:
                cur = store.inner.get(key)
                res = store.compare_and_delete(key, cur) if cur is not None else None
            out.append((op, "ok", res))
        except Exception as e:   # the class names agree, not the objects
            out.append((op, type(e).__name__, str(e)))
    return out, dict(store.faults_by_kind), store.faults_total, store.ops_total


@pytest.mark.parametrize("name", list(SPECS))
def test_fault_programs_fire_alike_in_both_packages(name, tmp_path):
    got = _program(TC, TF, tmp_path / "port", SPECS[name])
    want = _program(JC, JF, tmp_path / "jax", SPECS[name])
    assert got == want
    assert got[2] > 0


@pytest.mark.parametrize("raw", [
    "", "  ", json.dumps([{"ops": ["get"], "kind": "latency", "delay_s": 0.0}]),
    json.dumps({"kind": "error"}), json.dumps([{"kind": "nope"}]),
    json.dumps([{"ops": ["bad"]}]), json.dumps([{"kind": "error", "bogus": 1}]), "[{"])
def test_rules_from_env_parse_and_refuse_alike(raw):
    def outcome(mod):
        try:
            return ("ok", [(r.ops, r.kind, r.delay_s) for r in mod.rules_from_env(raw)])
        except Exception as e:
            return ("raised", type(e).__name__)
    assert outcome(TF) == outcome(JF)


def test_maybe_faulty_arms_from_the_environment(tmp_path, monkeypatch):
    store = TC.FileCoordinationStore(str(tmp_path))
    monkeypatch.delenv(TF.STORE_FAULTS_ENV, raising=False)
    assert TF.maybe_faulty(store, "c") is store
    monkeypatch.setenv(TF.STORE_FAULTS_ENV, json.dumps([{"ops": ["get"], "kind": "error"}]))
    wrapped = TF.maybe_faulty(store, "c")
    assert isinstance(wrapped, TF.FaultyStore) and wrapped.root == store.root
    with pytest.raises(TF.InjectedStoreFault):
        wrapped.get("x")


def test_latency_partition_and_stale_reads(tmp_path):
    inner = TC.FileCoordinationStore(str(tmp_path), clock=Clock())
    s = TF.FaultyStore(inner, client="c", rules=[
        TF.StoreFaultRule(ops=("put",), kind="latency", delay_s=0.002),
        TF.StoreFaultRule(ops=("get",), kind="stale_read", at_call=3)])
    for v in range(3):
        s.put("k", {"v": v})
    assert s.op_latency_percentiles()["put"]["p50"] >= 0.002
    assert s.get("k") == {"v": 2} and s.get("k") == {"v": 2}
    assert s.get("k") == {"v": 1}                 # the stale read: the older doc
    s.partitioned = True
    with pytest.raises(TC.StoreUnavailable):
        s.get("k")
    s.partitioned = False
    assert s.faults_by_kind == {"stale_read": 1, "blackout": 1} and s.now() == inner.now()


def test_torn_write_is_quarantined_and_recovered(tmp_path):
    inner = TC.FileCoordinationStore(str(tmp_path))
    s = TF.FaultyStore(inner, client="c",
                       rules=[TF.StoreFaultRule(ops=("put",), kind="torn_write", at_call=2)])
    s.put("pod/k", {"v": 1})
    with pytest.raises(TF.InjectedStoreFault, match="torn"):
        s.put("pod/k", {"v": 2, "pad": "x" * 40})
    assert s.get("pod/k") is None and inner.corrupt_docs_total == 1
    assert (tmp_path / "pod" / "k.corrupt").exists()
    assert inner.compare_and_swap("pod/k", None, {"v": 3}) and s.get("pod/k") == {"v": 3}
    assert s.list("pod") == ["k"]


def test_retry_policy_absorbs_transients_and_fails_fast_when_dark(tmp_path):
    inner = TC.FileCoordinationStore(str(tmp_path))
    s = TF.FaultyStore(inner, client="c", rules=[
        TF.StoreFaultRule(ops=("cas",), kind="error", max_fires=3)])
    before = TC.store_retries_total()
    assert TC.bump_generation(s) == 1 and TC.store_retries_total() - before >= 3
    pol = TC.StoreRetryPolicy(deadline_s=5.0, sleep=lambda _s: None)
    s.partitioned = True
    with pytest.raises(TC.StoreUnavailable):
        pol.run("dark", lambda: s.get("generation"))
    assert pol.retries_total == 0
    pol = TC.StoreRetryPolicy(deadline_s=0.0, sleep=lambda _s: None)
    with pytest.raises(TC.StoreUnavailable, match="no successful store op"):
        pol.run("always", lambda: TC.StoreRetryPolicy.RETRY)


def test_watchdog_never_declares_a_peer_from_failed_scans(tmp_path):
    clock = Clock()
    inner = TC.FileCoordinationStore(str(tmp_path), clock=clock)
    s = TF.FaultyStore(inner, client="h0")
    TC.beat(inner, "h1", 1, 1.0)
    seen = []
    wd = TC.HeartbeatWatchdog(s, "h0", 1, ["h0", "h1"], lease_s=1.0, miss_limit=2,
                              on_peer_dead=seen.append, grace_beats=0, store_fail_grace=2)
    wd.tick_once()
    s.partitioned = True
    for _ in range(3):
        clock.t += 1.0
        wd.tick_once()
    assert wd.store_unreachable and wd.store_failures_total == 3 and seen == []
    s.partitioned = False
    TC.beat(inner, "h1", 1, 1.0)
    wd.tick_once()                  # the heal's observation round declares nothing
    assert seen == [] and not wd.store_unreachable
    clock.t += 3.0
    wd.tick_once()                  # h1 stays silent: now it is dead
    assert seen == ["h1"] and TC.dead_set(inner) == ["h1"]
