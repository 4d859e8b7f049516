"""The port's member daemon and its router-side proxy
(``deepspeed_tpu_torch/inference/fleet_daemon.py``), the member entry point
(``python -m deepspeed_tpu_torch.inference.fleet_member``), the launcher's
``--fleet_daemon`` run and the copied store history checker
(``tests/_torch_store_check.py``), on the CPU.

Held against the JAX package on one store directory: assignments a JAX
``StoreMemberProxy`` appends are served by a port daemon (and the other way
round), token-equal to the JAX engine; the checker copy gives
``tools/store_check.py``'s verdict on the same histories, clean and with one
planted violation of each invariant; the store primitives the fleet leans
on that ``tests/test_torch_pod.py`` does not hold (CAS locks and their
back-off, tombstone expiry, racing compare-deletes and candidates, bounded
channels and racing consumers), with clients of both packages on one
directory.  The port's own: a daemon coupled to
its router through the store alone (token-exact, the journal collected,
the ``recycle`` and ``shutdown`` verbs), results published before a death
staying claimable, the outbox through a store blackout, the entry point's
flags and environment fallbacks, member processes with one SIGKILLed
mid-stream and the stalled leader (``tests/_torch_fleet_soak.py``), the
launcher's fleet of two daemons under a serving script, and recorded
histories of the port's pod (a lost peer, a live adoption) and fleet (a
coordinator failover) passing the checker.
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.elasticity import coordination as JC
from deepspeed_tpu.inference import fleet as JF
from deepspeed_tpu.inference import fleet_daemon as JD
from deepspeed_tpu.inference import serving as JS
from deepspeed_tpu.models import CausalLM as JaxCausalLM

import deepspeed_tpu_torch
from deepspeed_tpu_torch.elasticity import FaultyStore
from deepspeed_tpu_torch.elasticity import coordination as TC
from deepspeed_tpu_torch.elasticity import pod_agent as TP
from deepspeed_tpu_torch.elasticity import replication as TR
from deepspeed_tpu_torch.inference import fleet as TF
from deepspeed_tpu_torch.inference import fleet_daemon as TD
from deepspeed_tpu_torch.inference import fleet_member as TM
from deepspeed_tpu_torch.inference import serving as TS
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.resilience import clear_injector

from . import _torch_fleet_soak as soak
from . import _torch_store_check as port_check
from ._torch_ranks import make_batches
from .test_torch_pod import Peer, _tiny

ROOT = Path(__file__).resolve().parents[1]
SERVE_KW = dict(b_slots=2, page_size=8, max_model_len=64)
JAX = SimpleNamespace(Store=JC.FileCoordinationStore, Member=JF.FleetMember,
                      Router=JF.FleetRouter, Request=JS.Request, Daemon=JD.FleetMemberDaemon,
                      Proxy=JD.StoreMemberProxy)
PORT = SimpleNamespace(Store=TC.FileCoordinationStore, Member=TF.FleetMember,
                       Router=TF.FleetRouter, Request=TS.Request, Daemon=TD.FleetMemberDaemon,
                       Proxy=TD.StoreMemberProxy)


def _tools_store_check():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import store_check
    finally:
        sys.path.remove(str(ROOT / "tools"))
    return store_check


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_injector():
    clear_injector()
    yield
    clear_injector()


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


def _stream(n, seed=7, cls=TS.Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, input_ids=rng.integers(1, 250, int(rng.integers(3, 12))).astype(np.int32),
                max_new_tokens=int(rng.choice((4, 6, 8))))
            for i in range(n)]


@pytest.fixture(scope="module")
def reference(engines):
    """The JAX engine's outputs for the stream (the port's equal them:
    ``tests/test_torch_fleet.py``)."""
    jeng, _ = engines
    return {r.rid: r.output_ids
            for r in jeng.serving(b_slots=3, page_size=8, max_model_len=64).run(
                _stream(4, cls=JS.Request))}


# ---------------------------------------------------------------------------
# A daemon coupled to its router through the store alone
# ---------------------------------------------------------------------------

def test_store_member_daemon_serves_token_exact_and_verbs(engines, reference, tmp_path):
    _, teng = engines
    store = TC.FileCoordinationStore(str(tmp_path / "coord"))
    member = TF.FleetMember("engine0", teng.supervised_serving(max_restarts=5, **SERVE_KW),
                            store, lease_s=100.0)
    member.beat(force=True)
    daemon = TD.FleetMemberDaemon(member, store)
    proxy = TD.StoreMemberProxy("engine0", store, lease_s=100.0)
    proxy.beat()
    router = TF.FleetRouter(store, [proxy], lease_s=100.0)
    results = router.run(_stream(4), max_ticks=2000, on_tick=lambda r, n: daemon.poll_once())
    assert sorted(r.rid for r in results) == [0, 1, 2, 3]
    for r in results:
        np.testing.assert_array_equal(r.output_ids, reference[r.rid])
    assert store.list("fleet/requests") == []
    assert proxy.recycle()
    daemon.poll_once()
    assert member.alive
    proxy.send_control("shutdown")
    daemon.poll_once()
    assert daemon.shutdown


def test_store_member_proxy_dead_member_results_stay_claimable(tmp_path):
    store = TC.FileCoordinationStore(str(tmp_path / "coord"))
    proxy = TD.StoreMemberProxy("engine0", store, lease_s=1.0)
    TC.channel_append(store, "fleet/results/engine0",
                      {"rid": 1, "input_ids": [1, 2], "output_ids": [3],
                       "finish_reason": "length", "prefill_bucket": 8}, "engine0")
    proxy.alive = False
    assert proxy.stream_progress() == {}
    assert [r.rid for r in proxy.take_results()] == [1]


@pytest.mark.parametrize("router_pkg,member_pkg", [("jax", "port"), ("port", "jax")])
def test_assignments_cross_packages_on_one_store(engines, reference, router_pkg,
                                                 member_pkg, tmp_path):
    """A router of one package appends assignments through its
    ``StoreMemberProxy``; a daemon of the other consumes them, serves, and
    publishes results the router collects: token-equal to the JAX engine,
    the journal collected, the ``shutdown`` verb honoured."""
    jeng, teng = engines
    R, M = (JAX if router_pkg == "jax" else PORT), (JAX if member_pkg == "jax" else PORT)
    eng = jeng if member_pkg == "jax" else teng
    coord = str(tmp_path / "coord")
    mstore, rstore = M.Store(coord), R.Store(coord)
    member = M.Member("engine0", eng.supervised_serving(max_restarts=5, **SERVE_KW), mstore,
                      lease_s=100.0)
    member.beat(force=True)
    daemon = M.Daemon(member, mstore)
    proxy = R.Proxy("engine0", rstore, lease_s=100.0)
    proxy.beat()
    router = R.Router(rstore, [proxy], lease_s=100.0, journal_every_k=1)
    results = router.run(_stream(4, cls=R.Request), max_ticks=4000,
                         on_tick=lambda r, n: daemon.poll_once())
    assert sorted(r.rid for r in results) == [0, 1, 2, 3]
    for r in results:
        assert r.finish_reason in ("eos", "length")
        np.testing.assert_array_equal(r.output_ids, reference[r.rid])
    assert rstore.list("fleet/requests") == []
    proxy.send_control("shutdown")
    daemon.poll_once()
    assert daemon.shutdown


def test_outbox_buffers_heals_republishes_and_stale_drops(engines, tmp_path):
    """Results buffer in the outbox through a blackout, republish on heal
    when the journal still names this engine, and drop when a survivor
    re-stamped the entry; a cap overflow is counted."""
    _, teng = engines
    clock = [0.0]
    backend = TC.FileCoordinationStore(str(tmp_path / "coord"), clock=lambda: clock[0])
    view = FaultyStore(backend, client="engine0")
    member = TF.FleetMember("engine0", teng.supervised_serving(max_restarts=2, **SERVE_KW),
                            view, lease_s=1.0)
    member.beat(force=True)
    daemon = TD.FleetMemberDaemon(member, view, outbox_cap=2)
    proxy = TD.StoreMemberProxy("engine0", backend, router_id="r0", lease_s=1.0)
    for i in range(3):
        proxy.submit(TS.Request(rid=f"q{i}", input_ids=np.arange(1, 6, dtype=np.int32),
                                max_new_tokens=4))
    daemon.poll_once()
    view.partitioned = True
    for _ in range(40):
        daemon.poll_once()
        clock[0] += 0.05
        if daemon.outbox_dropped_total + len(daemon._outbox) == 3:
            break
    assert daemon._store_dark and daemon.store_unavailable_total >= 1
    assert daemon.outbox_dropped_total == 1 and len(daemon._outbox) == 2
    keep, stolen = [doc.get("rid") for doc in daemon._outbox]
    backend.put(f"fleet/requests/{TF._rid_key(keep)}",
                {"rid": keep, "engine": "engine0", "tokens": []})
    backend.put(f"fleet/requests/{TF._rid_key(stolen)}",
                {"rid": stolen, "engine": "engine1", "tokens": []})
    view.partitioned = False
    daemon.poll_once()
    assert daemon.outbox_republished_total == 1 and daemon.outbox_stale_dropped_total == 1
    assert len(daemon._outbox) == 0 and not daemon._store_dark
    assert [r.rid for r in proxy.take_results()] == [keep]


# ---------------------------------------------------------------------------
# Store primitives the fleet leans on, not held by tests/test_torch_pod.py
# ---------------------------------------------------------------------------

def _race(n, fn):
    """``fn(i)`` in ``n`` threads released together; their results."""
    out, start = [None] * n, threading.Barrier(n)

    def run(i):
        start.wait()
        out[i] = fn(i)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    return out


def _both(tmp_path, clock=None):
    root = str(tmp_path / "coord")
    return TC.FileCoordinationStore(root, clock=clock), JC.FileCoordinationStore(root,
                                                                                clock=clock)


def test_cas_lock_files_invisible_and_contention_backs_off(tmp_path):
    """A writer's CAS lock never reads as a document; a held lock makes the
    CAS back off and win after it is released, counted in
    ``cas_contended_total``."""
    t, j = _both(tmp_path)
    t.compare_and_swap("dead/h0", None, {"v": 1})
    open(j._path("dead/h1") + ".lock", "w").close()
    assert t.list("dead") == j.list("dead") == ["h0"] and t.get("dead/h1") is None
    os.remove(j._path("dead/h1") + ".lock")
    t.put("k", {"v": 0})
    lock = t._path("k") + ".lock"
    open(lock, "w").close()
    done = []
    th = threading.Thread(target=lambda: done.append(t.compare_and_swap("k", {"v": 0},
                                                                        {"v": 1})))
    th.start()
    time.sleep(0.05)
    os.remove(lock)
    th.join(timeout=30)
    assert done == [True] and t.cas_contended_total >= 1 and j.get("k") == {"v": 1}


def test_tombstone_expires_by_ttl_and_hides_from_list(tmp_path):
    t, j = _both(tmp_path)
    t.put("j/a", {"v": 1})
    j.put("j/b", {"v": 2})
    assert t.compare_and_delete("j/a", {"v": 1})
    assert t.list("j") == j.list("j") == ["b"]
    assert not j.compare_and_swap("j/a", None, {"v": 3})
    tomb = t._path("j/a") + ".tomb"
    past = time.time() - t.tombstone_ttl_s - 1.0
    os.utime(tomb, (past, past))
    assert j.compare_and_swap("j/a", None, {"v": 3}) and t.get("j/a") == {"v": 3}
    with pytest.raises(ValueError, match="expected"):
        t.compare_and_delete("j/a", None)


def test_racing_deleters_and_candidates_of_both_packages(tmp_path):
    """Compare-deletes and coordinator candidates of the two packages race
    on one directory: one deleter wins, one candidate takes the term."""
    clock = [100.0]
    t, j = _both(tmp_path, clock=lambda: clock[0])
    t.put("k", {"v": 7})
    wins = _race(4, lambda i: (t, j)[i % 2].compare_and_delete("k", {"v": 7}))
    assert sum(wins) == 1 and j.get("k") is None
    TC.elect_coordinator(t, "dead", lease_s=1.0)
    clock[0] = 200.0
    won = [w for w in _race(4, lambda i: (TC, JC)[i % 2].elect_coordinator(
        (t, j)[i % 2], f"r{i}", lease_s=5.0)) if w is not None]
    assert len(won) == 1 and won[0].term == 2
    assert JC.read_coordinator(j).leader_id == TC.read_coordinator(t).leader_id
    assert won[0].leader_id == TC.read_coordinator(t).leader_id


def test_channels_bounded_and_consumed_once_across_packages(tmp_path):
    """A bounded channel drops its oldest items and counts them alike in
    both packages; consumers of both packages racing claim each item
    exactly once."""
    t, j = _both(tmp_path)
    for i in range(4):
        (TC, JC)[i % 2].channel_append((t, j)[i % 2], "c2", {"i": i}, "w", max_items=2)
    assert TC.channel_stats(t, "c2") == JC.channel_stats(j, "c2")
    assert TC.channel_stats(t, "c2")["dropped"] == 2
    assert [d["i"] for _, d in JC.channel_consume(j, "c2", "r")] == [2, 3]
    for i in range(6):
        TC.channel_append(t, "ch", {"i": i}, "w")
    got = _race(4, lambda i: (TC, JC)[i % 2].channel_consume((t, j)[i % 2], "ch", f"c{i}"))
    assert sorted(d["i"] for items in got for _, d in items) == list(range(6))


# ---------------------------------------------------------------------------
# The member entry point, member processes, the launcher
# ---------------------------------------------------------------------------

def test_fleet_member_flags_and_environment(monkeypatch, capsys):
    """``tools/fleet_member.py``'s flags and ``DS_TPU_FLEET_*`` fallbacks;
    an explicit flag wins; no engine id or store is a usage error."""
    for key in ("DS_TPU_FLEET_ENGINE_ID", "DS_TPU_FLEET_COORD_DIR", "DS_TPU_FLEET_LEASE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit) as e:
        TM.parse_args(["--coord_dir", "/x"])
    assert e.value.code == 2 and "--engine_id" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        TM.parse_args(["--engine_id", "engine0"])
    assert "--coord_dir" in capsys.readouterr().err
    monkeypatch.setenv("DS_TPU_FLEET_ENGINE_ID", "engine3")
    monkeypatch.setenv("DS_TPU_FLEET_COORD_DIR", "/store")
    monkeypatch.setenv("DS_TPU_FLEET_LEASE", "2.5")
    a = TM.parse_args([])
    assert (a.engine_id, a.coord_dir, a.lease_s) == ("engine3", "/store", 2.5)
    assert (a.b_slots, a.page_size, a.max_model_len, a.max_restarts) == (2, 8, 64, 5)
    assert a.device is None and a.ready_file is None
    b = TM.parse_args(["--engine_id", "e9", "--lease_s", "1", "--device", "cpu"])
    assert (b.engine_id, b.lease_s, b.device) == ("e9", 1.0, "cpu")


def test_fleet_member_runs_on_the_card_unless_told(monkeypatch, tmp_path):
    """Without ``--device`` the member asks for CUDA, which this machine
    lacks: it raises rather than serving on the CPU."""
    monkeypatch.delenv("DS_ACCELERATOR", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        TM.main(["--engine_id", "e0", "--coord_dir", str(tmp_path)])


def test_fleet_procs_chaos_soak_deterministic_seed(tmp_path):
    """Member daemons as processes, one SIGKILLed mid-stream: none lost,
    none served twice, token-exact resumes across the process boundary,
    the survivor shut down cleanly; then the stalled leader (delete fenced,
    append stood down, resurrection tombstoned)."""
    stats = soak.run_fleet_procs_soak(seed=18, root=str(tmp_path))
    assert stats["terminal"] == 6 == stats["parity_checked"]
    assert stats["failovers"] >= 1 and stats["resumed_tokens"] > 0
    assert set(stats["survivor_rcs"].values()) == {0}
    assert stats["stalled_final_term"] == 2 and stats["stalled_parity_checked"] == 6


def test_launcher_fleet_daemons_serve_a_script(tmp_path):
    """``--fleet 2 --fleet_daemon``: the launcher starts two member daemons
    (the entry point, engine0 and engine1, on the CPU under ``--simulate``),
    exports the contract to the serving script, whose stream is token-equal
    to an in-process engine, and reaps the daemons after it exits."""
    (tmp_path / "out").mkdir()
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"out": str(tmp_path / "out"), "seed": 2, "n_requests": 6}))
    coord = tmp_path / "coord"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    res = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher", "--simulate", "1",
         "--fleet", "2", "--fleet_daemon", "--fleet_coord_dir", str(coord),
         "--fleet_lease", "5.0", "--module", "tests._torch_fleet_soak", str(spec)],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    rec = json.loads((tmp_path / "out" / "fleet_serve.json").read_text())
    assert rec["env"]["DS_TPU_FLEET_SIZE"] == "2" and rec["env"]["DS_TPU_FLEET_DAEMON"] == "1"
    assert rec["env"]["DS_TPU_FLEET_COORD_DIR"] == str(coord)
    assert rec["env"]["DS_TPU_FLEET_LEASE"] == "5.0"
    assert rec["token_equal"] and rec["finish"] == ["length"] and not rec["journal_left"]
    assert len(rec["rids"]) == 4 and sorted(rec["tokens_by_engine"]) == ["engine0", "engine1"]
    store = TC.FileCoordinationStore(str(coord))
    assert sorted(store.list("fleet/heartbeat")) == ["engine0", "engine1"]


# ---------------------------------------------------------------------------
# The store history checker: the copy against tools/store_check.py
# ---------------------------------------------------------------------------

def _cas(i, key, expected, new, client="a", ok=True):
    return {"i": i, "client": client, "op": "cas", "key": key, "t": float(i),
            "expected": expected, "new": new, "ok": ok}


def _append(i, key, exp_doc, seq, payload, client="e0"):
    items = list((exp_doc or {}).get("items") or []) + [[seq, payload]]
    return _cas(i, key, exp_doc, {"seq": seq, "items": items, "consumer": None}, client)


def _planted():
    res = "fleet/results/e0"
    a1 = _append(0, res, None, 1, {"rid": "r1"})
    consume = _cas(1, res, a1["new"], {"seq": 1, "items": [], "consumer": "r0"}, "r0")
    adopt = {"victim": "h1", "adopter": "h0", "step": 4, "slab_generation": 1}
    return {
        "clean": [_cas(0, "fleet/coordinator", None, {"leader_id": "r0", "term": 1}),
                  _cas(1, "fleet/requests/i1", None, {"rid": 1}),
                  a1 | {"i": 2}, consume | {"i": 3},
                  {"i": 4, "client": "a", "op": "compare_delete", "key": "fleet/requests/i1",
                   "t": 4.0, "expected": {"rid": 1}, "ok": True}],
        "stale_cas": [_cas(0, "k", None, {"v": 1}), _cas(1, "k", {"v": 99}, {"v": 2}, "b")],
        "stale_compare_delete": [
            _cas(0, "k", None, {"v": 1}),
            {"i": 1, "client": "b", "op": "compare_delete", "key": "k", "t": 1.0,
             "expected": {"v": 5}, "ok": True}],
        "two_leaders": [_cas(0, "fleet/coordinator", None, {"leader_id": "a", "term": 3}),
                        _cas(1, "fleet/coordinator", {"leader_id": "a", "term": 3},
                             {"leader_id": "b", "term": 3}, "b")],
        "generation_backwards": [_cas(0, "fleet/generation", None, {"generation": 2}),
                                 _cas(1, "fleet/generation", {"generation": 2},
                                      {"generation": 1})],
        "resurrection": [
            _cas(0, "fleet/requests/i7", None, {"rid": 7}),
            {"i": 1, "client": "a", "op": "compare_delete", "key": "fleet/requests/i7",
             "t": 1.0, "expected": {"rid": 7}, "ok": True},
            _cas(2, "fleet/requests/i7", None, {"rid": 7}, "b")],
        "channel_seq": [a1, _append(1, res, a1["new"], 1, {"rid": "r2"})],
        "double_consume": [a1, consume,
                           _cas(2, res, {"seq": 1, "items": [], "consumer": "r0"},
                                {"seq": 1, "items": [], "consumer": "r1"}, "r1"),
                           _cas(3, res, a1["new"], {"seq": 1, "items": [], "consumer": "r1"},
                                "r1")],
        "duplicate_serve": [a1, _append(1, res, a1["new"], 2, {"rid": "r1"})],
        "adoption_fence": [_cas(0, "dead/h1", None, {"generation": 3}),
                           _cas(1, "pod/adopt/gen4/h1", None, adopt, "h0")],
        "two_adopters": [_cas(0, "pod/adopt/gen2/h1", None, adopt, "h0"),
                         _cas(1, "pod/adopt/gen2/h1", adopt, adopt | {"adopter": "h2"}, "h2")],
    }


@pytest.mark.parametrize("case", list(_planted()))
def test_store_check_copy_gives_the_tools_verdict(case):
    events = _planted()[case]
    mine = port_check.check_history(events)
    theirs = _tools_store_check().check_history(events)
    assert mine.to_dict() == theirs.to_dict()
    assert mine.ok == (case == "clean"), mine.violations


def _check_both(events, tmp_path, name):
    """The copy's and the tools checker's verdicts on a saved history, and
    on it with one stale CAS and one early adoption planted."""
    path = tmp_path / f"{name}.jsonl"
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    loaded = port_check.load_history(str(path))
    mine, theirs = port_check.check_history(loaded), _tools_store_check().check_history(loaded)
    assert mine.to_dict() == theirs.to_dict()
    assert mine.ok, mine.violations[:5]
    n = len(events)
    planted = events + [
        _cas(n, "dead/hX", None, {"generation": 9}, "z"),
        _cas(n + 1, "pod/adopt/gen9/hX", None,
             {"victim": "hX", "adopter": "h0", "step": 1, "slab_generation": 2}, "z"),
        _cas(n + 2, events[-1]["key"] or "k", {"never": "current"}, {"v": 1}, "z")]
    bad, tbad = port_check.check_history(planted), _tools_store_check().check_history(planted)
    assert bad.to_dict() == tbad.to_dict() and not bad.ok
    assert any("fence" in v for v in bad.violations)
    assert any("stale" in v for v in bad.violations)
    assert port_check.main([str(path)]) == 0
    return mine


def test_port_fleet_history_with_a_coordinator_failover_passes(tmp_path):
    """Seed 1's soak (a member's lease lapses, then the coordinator dies and
    the standby takes over) with every client's operations recorded."""
    stats = soak.run_fleet_soak(seed=1, coord_dir=str(tmp_path / "coord"), n_requests=8,
                                record=True)
    assert stats["killed_coordinator"] and stats["final_term"] == 2
    verdict = _check_both(stats["history"], tmp_path, "fleet")
    assert verdict.counts["cas"] > 50
    keys = {ev["key"] for ev in stats["history"]}
    assert "fleet/coordinator" in keys and "fleet/generation" in keys


def test_port_pod_history_of_a_lost_peer_passes(tmp_path):
    """The lost-peer rehearsal of ``tests/test_torch_pod.py`` on the tiny
    engine, recorded: h1 (a thread) dies at step 4's save, h0's watchdog
    declares it, the round raises ``PodPeerLost``; the next generation
    resumes from the pod-committed step 2."""
    rec = port_check.RecordingStore(TC.FileCoordinationStore(str(tmp_path / "coord")),
                                    client="h0")
    ckpt = str(tmp_path / "ckpt")
    batches = make_batches(6, 2, seed=5)
    gen = TC.bump_generation(rec)
    ctx = TP.PodContext(rec, "h0", ["h0", "h1"], gen, lease_s=0.2, miss_limit=3,
                        commit_timeout_s=3.0)
    peer = Peer(rec.handle("h1"), ckpt, "h1", gen, die_at="global_step4")
    dead_seen = []
    wd = ctx.watchdog(on_peer_dead=dead_seen.append).start()
    agent = TP.PodElasticAgent(_tiny(), ckpt, ctx, watchdog=wd, ckpt_every=2)
    try:
        with pytest.raises(TP.PodPeerLost):
            agent.run(lambda e, s: e.train_batch(batch=batches[s]), 6)
    finally:
        wd.stop()
        peer.join()
        agent.guard.uninstall()
    assert dead_seen == ["h1"]
    gen = TC.bump_generation(rec)
    second = TP.PodElasticAgent(_tiny(), ckpt, TP.PodContext(rec, "h0", ["h0"], gen,
                                                             lease_s=0.2,
                                                             commit_timeout_s=5.0),
                                ckpt_every=2)
    try:
        assert second.run(lambda e, s: e.train_batch(batch=batches[s]), 6) == 6
    finally:
        second.guard.uninstall()
    assert second.resumed_tag == "global_step2"
    verdict = _check_both(rec.events, tmp_path, "pod_lost_peer")
    assert verdict.counts["cas"] >= 2
    assert {"dead/h1", "generation"} <= {ev["key"] for ev in rec.events}


def test_port_pod_history_of_a_live_adoption_passes(tmp_path):
    """The live adoption of ``tests/test_torch_pod.py`` recorded: h0 seals
    replicas, h1 dies after step 5, the next generation adopts h1's slab
    under the ``pod/adopt`` fence and resumes at the cut."""
    rec = port_check.RecordingStore(TC.FileCoordinationStore(str(tmp_path / "coord")),
                                    client="h0")
    h1 = rec.handle("h1")
    batches = make_batches(6, 2, seed=5)
    eng = _tiny()
    rep = TR.HostReplicator(rec, "h0", 1, ["h0", "h1"], eng.replica_snapshot,
                            replica_every_k=2)
    for s, b in enumerate(batches[:5]):
        eng.train_batch(batch=b)
        rep.maybe_replicate(s + 1)
        if (s + 1) % 2 == 0:
            TR.publish_replica(h1, "h1", TR.seal_entry(b"h1 shard", s + 1, 1), buddy="h0")
    rep.stop()
    TC.record_dead(rec, "h1", 1, "h0")
    agent = TP.PodElasticAgent(_tiny(), str(tmp_path / "ckpt"), TP.PodContext(rec, "h0",
                                                                            ["h0"], 2),
                               adopt_prev_hosts=["h0", "h1"], adopt_dead=["h1"])
    try:
        agent.run(lambda e, s: e.train_batch(batch=batches[s]), 6)
    finally:
        agent.guard.uninstall()
    assert agent.adopted_step == 4
    verdict = _check_both(rec.events, tmp_path, "pod_adoption")
    assert verdict.counts["adopt"] == 1
