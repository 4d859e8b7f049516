"""The port's serving-fleet chaos soaks (after ``tools/chaos_soak.py``'s
``run_fleet_soak``, its trace checks and ``run_fleet_procs_soak``, which
import the JAX package).  Imports no JAX.

:func:`run_fleet_soak` -- one in-process fleet session under a seeded kill:
the seed draws the victim engine, the router round it dies at and the kill
mode, ``lease`` (the member's lease stops renewing; detection is
``miss_limit`` missed periods on the injected store clock) or ``budget``
(injected ``serve.decode`` faults exhaust the member's restart budget: it
writes its ``fleet/dead`` marker and failover is immediate); half the seeds
also kill the coordinator router a few rounds later, and the standby takes
over with the journal.  A third of the stream is sampled and a third
adapter-tagged.  ``collect_traces=<dir>`` runs it with the tracer on and
checks the assembled fleet trace; ``record=True`` puts the recording proxy
of ``tests/_torch_store_check.py`` between every client and the store and
returns its events under ``"history"``.

:func:`run_fleet_procs_soak` -- member daemons as real processes (``python
-m deepspeed_tpu_torch.inference.fleet_member --device cpu``) driven through
``StoreMemberProxy`` handles on a real-clock store, one SIGKILLed once the
journal shows it mid-stream; then the stalled-leader scenario on an
injected clock (the deposed leader's compare-delete and token append lose,
the tombstone blocks its resurrection write).

Both assert: a terminal result per rid (none lost, none served twice),
outputs token-equal to a fault-free single-engine run of the same weights,
balanced page accounting on the survivors, the victim visibly dead through
the store, the journal empty after collection, and generations monotonic
across terms.  Seeds and the store clock make every in-process run
deterministic.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from random import Random

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_KW = dict(b_slots=2, page_size=8, max_model_len=64)


def tiny_engine(params=None):
    """The soaks' engine: ``CausalLM("tiny")`` in fp32 on the CPU, with
    ``params`` (a port tree) or the init seeded with 0, which is what
    ``fleet_member`` serves."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    model = CausalLM("tiny", dtype=torch.float32)
    if params is None:
        params = model.init_fn(torch.Generator().manual_seed(0), device="cpu",
                               dtype=torch.float32)
    engine = deepspeed_tpu_torch.init_inference(model, config={"dtype": "float32"},
                                                params=params, device="cpu")
    return model, engine


def _registry(engine, seed: int):
    """Two LoRA tenants (rank 4) with non-zero factors, shared by every
    member and the reference."""
    from deepspeed_tpu_torch.inference import AdapterRegistry
    from deepspeed_tpu_torch.runtime.lora import LoRAConfig

    layers = engine.params["layers"]
    reg = AdapterRegistry(layers)
    for t_i, aid in enumerate(("acme", "globex")):
        cfg = LoRAConfig(rank=4, alpha=8.0)
        trng = np.random.default_rng(seed * 100 + t_i)
        lora = {}
        for t in cfg.targets:
            L, d_in, d_out = (int(s) for s in layers[t].shape)
            lora[t] = {"A": trng.standard_normal((L, d_in, 4)).astype(np.float32) * 0.5,
                       "B": trng.standard_normal((L, 4, d_out)).astype(np.float32) * 0.05}
        reg.register(aid, lora, cfg)
    return reg


def fleet_stream(seed: int, n_requests: int, vocab: int):
    """The soak's stream: half sharing a seeded system prompt, every third
    sampled, every third (offset) adapter-tagged (``chaos_soak``'s draws)."""
    from deepspeed_tpu_torch.inference import Request, SamplingParams

    nprng = np.random.default_rng(seed)
    system = nprng.integers(1, vocab, 11).astype(np.int32)

    def prompt(i):
        if i % 2 == 0:
            uniq = nprng.integers(1, vocab, int(nprng.integers(2, 6))).astype(np.int32)
            return np.concatenate([system, uniq])
        return nprng.integers(1, vocab, int(nprng.integers(3, 14))).astype(np.int32)

    def lane(i):
        if i % 3 != 1:
            return None
        return SamplingParams(temperature=0.8 if i % 2 else 1.2,
                              top_k=0 if i % 6 == 1 else 12, top_p=0.9, seed=500 + i)

    def adapter(i):
        return None if i % 3 != 2 else ("acme", "globex")[(i // 3) % 2]

    return [Request(rid=i, input_ids=prompt(i), max_new_tokens=int(nprng.choice((4, 6, 8))),
                    sampling=lane(i), adapter_id=adapter(i))
            for i in range(n_requests)]


def _copies(base):
    from deepspeed_tpu_torch.inference import Request

    return [Request(rid=r.rid, input_ids=r.input_ids, max_new_tokens=r.max_new_tokens,
                    sampling=r.sampling, adapter_id=r.adapter_id, trace_id=r.trace_id)
            for r in base]


def run_fleet_soak(seed: int, coord_dir: str, n_requests: int = 10, n_engines: int = 3,
                   params=None, collect_traces: str = None, record: bool = False) -> dict:
    """One in-process fleet session under the seed's kill (module
    docstring).  Returns the stats of ``chaos_soak.run_fleet_soak`` plus
    ``"by_rid"`` (each result's output, failovers and resumed tokens)."""
    from deepspeed_tpu_torch.elasticity import (FileCoordinationStore, dead_set,
                                                lease_table, read_generation)
    from deepspeed_tpu_torch.inference import FleetMember, FleetRouter
    from deepspeed_tpu_torch.resilience import (SITE_SERVE_DECODE, FaultInjector,
                                                clear_injector, install_injector)

    rng = Random(seed)
    model, engine = tiny_engine(params)
    reg = _registry(engine, seed)
    base = fleet_stream(seed, n_requests, model.config.vocab_size)
    ref_serve = engine.serving(b_slots=3, page_size=8, max_model_len=64, adapters=reg)
    ref = {r.rid: r.output_ids for r in ref_serve.run(_copies(base))}
    ref_serve.close()
    del ref_serve

    if collect_traces:
        from deepspeed_tpu_torch.observability import configure_tracer, get_tracer

        configure_tracer(enabled=True, capacity=1 << 16)
        get_tracer().reset()
    try:
        victim = f"engine{rng.randrange(n_engines)}"
        kill_mode = rng.choice(("lease", "budget"))
        kill_round = rng.randint(2, 6)
        kill_coordinator = rng.random() < 0.5
        coord_kill_round = kill_round + rng.randint(1, 3)

        LEASE_S, MISS, ROUTER_LEASE = 1.0, 3, 30.0
        clock_box = [0.0]
        backend = FileCoordinationStore(coord_dir, clock=lambda: clock_box[0])
        recorder = None
        if record:
            from tests._torch_store_check import RecordingStore

            recorder = RecordingStore(backend, client="router0")
        view = (lambda client: recorder.handle(client)) if record else (lambda client: backend)
        store = view("router0")
        members = [FleetMember(f"engine{i}",
                               engine.supervised_serving(
                                   max_restarts=0 if kill_mode == "budget" else 5,
                                   adapters=reg, **SERVE_KW),
                               view(f"engine{i}"), lease_s=LEASE_S)
                   for i in range(n_engines)]
        router = FleetRouter(store, members, router_id="router0", lease_s=ROUTER_LEASE,
                             miss_limit=MISS, journal_every_k=2)
        standby = (FleetRouter(view("router1"), members, router_id="router1",
                               lease_s=ROUTER_LEASE, miss_limit=MISS, journal_every_k=2)
                   if kill_coordinator else None)
        if collect_traces:
            for m in members:
                m.trace_publish_interval_s = 0.0
            for r in (router, standby):
                if r is not None:
                    r.trace_publish_interval_s = 0.0

        inj = FaultInjector()
        if kill_mode == "budget":
            inj.add(site=SITE_SERVE_DECODE, kind="raise", at_call=rng.randint(3, 3 * n_engines))
        install_injector(inj)
        gens = []
        state = {"victim_killed": False}

        def on_tick(r, rounds):
            clock_box[0] += 1.0
            gens.append(read_generation(backend, key=r.generation_key))
            if kill_mode == "lease" and rounds == kill_round and not state["victim_killed"]:
                r.members[victim].kill()
                state["victim_killed"] = True
            if kill_coordinator and rounds == coord_kill_round and r.alive and r is router:
                r.kill()

        try:
            try:
                results = router.run(_copies(base), max_ticks=4000, on_tick=on_tick)
            except RuntimeError:
                # the coordinator's own step raising is the in-process
                # stand-in for its process dying: the standby converges
                if not (kill_coordinator and not router.alive):
                    raise
                results = list(router.take_results())
                results += standby.run([], max_ticks=4000, on_tick=on_tick)
        finally:
            clear_injector()

        live = standby if (standby is not None and standby.is_coordinator) else router
        by_rid = {}
        for res in results:
            assert res.rid not in by_rid, f"fleet soak seed={seed}: rid {res.rid} served twice"
            by_rid[res.rid] = res
        assert sorted(by_rid) == sorted(r.rid for r in base), \
            f"fleet soak seed={seed}: lost {sorted(set(r.rid for r in base) - set(by_rid))}"
        sampled = {r.rid for r in base if r.sampling is not None}
        tagged = {r.rid: r.adapter_id for r in base if r.adapter_id is not None}
        parity = resumed_results = resumed_tokens = 0
        sampled_parity = sampled_resumed = adapter_parity = adapter_resumed = 0
        for rid, res in by_rid.items():
            assert res.finish_reason in ("eos", "length"), (seed, rid, res.finish_reason)
            assert np.array_equal(res.output_ids, ref[rid]), \
                f"fleet soak seed={seed}: rid {rid} diverged after failover"
            parity += 1
            sampled_parity += rid in sampled
            if rid in tagged:
                adapter_parity += 1
                assert res.adapter_id == tagged[rid], (seed, rid, res.adapter_id)
            if res.resumed_tokens:
                assert res.resumed_tokens <= len(res.output_ids), res
                resumed_results += 1
                resumed_tokens += res.resumed_tokens
                sampled_resumed += rid in sampled
                adapter_resumed += rid in tagged
        for eid, m in live.members.items():
            if m.alive:
                acct = m.sup.engine.page_accounting()
                assert acct["balanced"], f"fleet soak seed={seed}: {eid}: {acct}"
        dead_ids = live._failed_engines
        if kill_mode == "budget":
            assert dead_ids, f"fleet soak seed={seed}: the budget kill never landed"
        for eid in dead_ids:
            marked = eid in dead_set(backend, prefix="fleet/dead")
            lease = lease_table(backend, prefix="fleet/heartbeat").get(eid)
            lapsed = lease is None or lease.missed(clock_box[0]) >= MISS
            assert marked or lapsed, f"fleet soak seed={seed}: {eid} failed over while alive"
        if kill_mode == "lease":
            assert victim in dead_ids, f"fleet soak seed={seed}: {victim} never declared dead"
        if not kill_coordinator:
            assert router.failovers_total == sum(r.failovers for r in by_rid.values()), \
                f"fleet soak seed={seed}: failover accounting mismatch"
        assert all(b >= a for a, b in zip(gens, gens[1:])), \
            f"fleet soak seed={seed}: generation not monotonic: {gens}"
        if kill_coordinator:
            assert standby.is_coordinator and standby.term == 2, \
                f"fleet soak seed={seed}: election never converged (term {standby.term})"
        leftover = backend.list("fleet/requests")
        assert not leftover, f"fleet soak seed={seed}: journal entries leaked: {leftover}"
        trace_stats = {}
        if collect_traces:
            trace_stats = _fleet_trace_checks(
                seed, collect_traces, backend, live,
                [r for r in (router, standby) if r is not None],
                list(by_rid.values()), set(dead_ids), kill_mode)
        stats = {
            "seed": seed, "submitted": len(base), "terminal": len(by_rid),
            "parity_checked": parity, "kill_mode": kill_mode, "victim": victim,
            "killed_coordinator": kill_coordinator, "dead_engines": sorted(dead_ids),
            "failovers": live.failovers_total, "resumed_results": resumed_results,
            "resumed_tokens": resumed_tokens, "sampled_parity_checked": sampled_parity,
            "sampled_resumed_results": sampled_resumed, "adapter_tagged": len(tagged),
            "adapter_parity_checked": adapter_parity,
            "adapter_resumed_results": adapter_resumed, "faults_fired": len(inj.log),
            "final_term": live.term, "final_generation": live.generation,
            "by_rid": {rid: {"output_ids": [int(t) for t in r.output_ids],
                             "failovers": r.failovers, "resumed_tokens": r.resumed_tokens}
                       for rid, r in by_rid.items()},
            **trace_stats,
        }
        if record:
            stats["history"] = recorder.events
        for m in members:
            m.sup.engine.close()
        return stats
    finally:
        if collect_traces:
            from deepspeed_tpu_torch.observability import configure_tracer, get_tracer

            configure_tracer(enabled=False)
            get_tracer().reset()


def _fleet_trace_checks(seed: int, out_dir: str, store, live_router, routers, results,
                        dead_ids, kill_mode) -> dict:
    """Assemble the soaked fleet's published trace: a failed-over completed
    stream is one ``trace_id`` whose spans cover the dead engine's and a
    survivor's tracks, the victim's pre-kill spans (its admissions and the
    decode ticks naming the rid in ``slot_rids``) ending before the
    survivor's post-failover prefill.  The tracer is off before the checks
    run."""
    from deepspeed_tpu_torch.observability import configure_tracer, get_tracer
    from deepspeed_tpu_torch.observability.trace_assembly import (assemble_fleet_trace,
                                                                  events_for_trace,
                                                                  load_segments)

    os.makedirs(out_dir, exist_ok=True)
    try:
        for m in live_router.members.values():
            if m.alive:
                m.publish_trace_segments(force=True)
        for r in routers:
            r.publish_trace_segments(force=True)
        path = os.path.join(out_dir, "fleet_trace.json")
        doc = assemble_fleet_trace(load_segments(store), out_path=path)
    finally:
        configure_tracer(enabled=False)
        get_tracer().reset()
    owners = doc["otherData"]["owners"]
    pid_of = {o: i for i, o in enumerate(owners, start=1)}
    dead_pids = {pid_of[e] for e in dead_ids if e in pid_of}
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    checked = two_track = 0
    for res in results:
        if not res.failovers or res.finish_reason not in ("eos", "length"):
            continue
        tid = res.trace_id
        assert tid, f"fleet soak seed={seed}: failed-over rid {res.rid} has no trace_id"
        if any(e[0] == "finish" and e[2] == "journal" for e in res.lifecycle):
            continue              # finished from the journal: no survivor span
        evs = events_for_trace(doc, tid)
        rid_s = str(res.rid)
        victim_evs = [e for e in evs if e["pid"] in dead_pids]
        victim_decodes = [
            e for e in spans
            if e["pid"] in dead_pids and e["name"] in ("serve.decode", "serve.tick")
            and rid_s in (((e.get("args") or {}).get("slot_rids") or {}).values())]
        if not victim_evs and not victim_decodes:
            continue              # the kill came before the victim's first publish
        survivor_evs = [e for e in evs if e["pid"] not in dead_pids]
        assert survivor_evs, f"fleet soak seed={seed}: trace {tid} has no survivor spans"
        checked += 1
        two_track += bool(victim_evs)
        pre_end = max(e["ts"] + e["dur"] for e in victim_evs + victim_decodes)
        post = [e["ts"] for e in survivor_evs if e["name"] == "serve.prefill"]
        assert post, f"fleet soak seed={seed}: trace {tid} has no survivor prefill"
        assert pre_end <= min(post), \
            f"fleet soak seed={seed}: trace {tid}'s pre-kill spans overlap the failover"
    if kill_mode == "lease":
        assert checked > 0, f"fleet soak seed={seed}: no stream had victim spans to order"
    return {"trace_path": path, "trace_owners": owners, "trace_rids_checked": checked,
            "trace_two_track_rids": two_track, "trace_spans_assembled": len(spans)}


def member_cmd(engine_id: str, coord_dir: str, lease_s: float, ready_file: str) -> list:
    """The command of one port member daemon on the CPU."""
    return [sys.executable, "-m", "deepspeed_tpu_torch.inference.fleet_member",
            "--engine_id", engine_id, "--coord_dir", coord_dir, "--lease_s", str(lease_s),
            "--idle_sleep_s", "0.002", "--max_restarts", "5", "--ready_file", ready_file,
            "--device", "cpu"]


def member_env() -> dict:
    return dict(os.environ, PYTHONPATH=ROOT, DS_ACCELERATOR="cpu", OMP_NUM_THREADS="1")


def wait_ready(procs: dict, root: str, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    for eid, proc in procs.items():
        ready = os.path.join(root, f"ready_{eid}")
        while not os.path.exists(ready):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(f"member {eid} never came ready (rc {proc.poll()}; "
                                   f"see {root}/{eid}.log)")
            time.sleep(0.05)


def run_fleet_procs_soak(seed: int, root: str, n_requests: int = 6,
                         n_members: int = 2) -> dict:
    """Member daemons as processes, one SIGKILLed mid-stream, then the
    stalled-leader scenario (module docstring)."""
    from deepspeed_tpu_torch.elasticity import FileCoordinationStore, dead_set, lease_table
    from deepspeed_tpu_torch.inference import (FleetRouter, Request, SamplingParams,
                                               StoreMemberProxy)

    rng = Random(seed)
    model, engine = tiny_engine()
    nprng = np.random.default_rng(seed)

    def lane(i):
        if i % 3 != 1:
            return None
        return SamplingParams(temperature=0.8 if i % 2 else 1.2,
                              top_k=0 if i % 6 == 1 else 12, top_p=0.9, seed=900 + i)

    # 16 new tokens: the window with journaled tokens outstanding and the
    # stream unfinished stays open across many real-clock rounds
    base = [Request(rid=i, input_ids=nprng.integers(1, model.config.vocab_size,
                                                    int(nprng.integers(3, 12))).astype(np.int32),
                    max_new_tokens=16, sampling=lane(i), trace_id=f"procs-{seed}-{i}")
            for i in range(n_requests)]
    ref_serve = engine.serving(b_slots=3, page_size=8, max_model_len=64)
    ref = {r.rid: r.output_ids for r in ref_serve.run(_copies(base))}
    ref_serve.close()

    coord_dir = os.path.join(root, "coord")
    store = FileCoordinationStore(coord_dir)      # the real clock
    LEASE_S, MISS = 1.0, 3
    procs, logs = {}, {}
    try:
        for i in range(n_members):
            eid = f"engine{i}"
            logs[eid] = open(os.path.join(root, f"{eid}.log"), "w")
            procs[eid] = subprocess.Popen(
                member_cmd(eid, coord_dir, LEASE_S, os.path.join(root, f"ready_{eid}")),
                env=member_env(), cwd=ROOT, stdout=logs[eid], stderr=subprocess.STDOUT)
        wait_ready(procs, root)
        proxies = [StoreMemberProxy(f"engine{i}", store, router_id="router0", lease_s=LEASE_S)
                   for i in range(n_members)]
        for p in proxies:
            p.beat()
        router = FleetRouter(store, proxies, router_id="router0", lease_s=30.0,
                             miss_limit=MISS, journal_every_k=1)
        victim = f"engine{rng.randrange(n_members)}"
        state = {"killed": False, "kill_round": None}

        def on_tick(r, rounds):
            time.sleep(0.005)
            if state["killed"]:
                return
            mid_stream = any(
                doc.get("engine") == victim and doc.get("tokens")
                and len(doc["tokens"]) < r._requests[rid].max_new_tokens
                for rid, doc in r._journal_docs.items() if rid in r._requests)
            if mid_stream or rounds >= 600:
                os.kill(procs[victim].pid, signal.SIGKILL)
                state["killed"], state["kill_round"] = True, rounds

        results = router.run(_copies(base), max_ticks=60000, on_tick=on_tick)
        assert state["killed"], f"fleet_procs seed={seed}: the stream finished before the kill"
        by_rid = {}
        for res in results:
            assert res.rid not in by_rid, f"fleet_procs seed={seed}: rid {res.rid} served twice"
            by_rid[res.rid] = res
        assert sorted(by_rid) == sorted(r.rid for r in base), f"fleet_procs seed={seed}: lost"
        resumed_results = resumed_tokens = 0
        for rid, res in by_rid.items():
            assert res.finish_reason in ("eos", "length"), res.finish_reason
            assert np.array_equal(res.output_ids, ref[rid]), \
                f"fleet_procs seed={seed}: rid {rid} diverged across the process boundary"
            assert res.trace_id == f"procs-{seed}-{rid}", (rid, res.trace_id)
            if res.resumed_tokens:
                resumed_results += 1
                resumed_tokens += res.resumed_tokens
        assert router.failovers_total >= 1, f"fleet_procs seed={seed}: no failover"
        assert victim in router._failed_engines, f"fleet_procs seed={seed}: {victim} not dead"
        lease = lease_table(store, prefix="fleet/heartbeat").get(victim)
        assert (lease is None or lease.missed(store.now()) >= MISS
                or victim in dead_set(store, prefix="fleet/dead"))
        assert not store.list("fleet/requests"), "journal entries leaked"
        for p in proxies:
            if p.alive:
                p.send_control("shutdown")
        rcs = {}
        for eid, proc in procs.items():
            if eid != victim:
                rcs[eid] = proc.wait(timeout=60)
        stats = {"seed": seed, "submitted": len(base), "terminal": len(by_rid),
                 "parity_checked": len(by_rid), "victim": victim,
                 "kill_round": state["kill_round"], "failovers": router.failovers_total,
                 "resumed_results": resumed_results, "resumed_tokens": resumed_tokens,
                 "survivor_rcs": rcs,
                 "channel_dropped": sum(p.channel_dropped_total for p in proxies)}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
        for f in logs.values():
            f.close()
    stats.update(stalled_leader_scenario(seed, os.path.join(root, "stalled"), engine, ref,
                                         base))
    return stats


def stalled_leader_scenario(seed: int, coord_dir: str, engine, ref: dict, base: list) -> dict:
    """Router A leads until a stream is journaled mid-flight, then stalls;
    B wins term 2 and re-stamps the journal; A's compare-delete and token
    append lose; B finishes every stream once; its tombstone blocks A's
    resurrection write."""
    from deepspeed_tpu_torch.elasticity import FileCoordinationStore
    from deepspeed_tpu_torch.inference import FleetMember, FleetRouter
    from deepspeed_tpu_torch.inference.fleet import FLEET_REQUESTS_PREFIX, _rid_key

    clock = [0.0]
    store = FileCoordinationStore(coord_dir, clock=lambda: clock[0])
    members = [FleetMember(f"engine{i}", engine.supervised_serving(max_restarts=5, **SERVE_KW),
                           store, lease_s=1.0)
               for i in range(2)]
    ROUTER_LEASE, MISS = 5.0, 3
    A = FleetRouter(store, members, router_id="routerA", lease_s=ROUTER_LEASE,
                    miss_limit=MISS, journal_every_k=1)
    B = FleetRouter(store, members, router_id="routerB", lease_s=ROUTER_LEASE,
                    miss_limit=MISS, journal_every_k=1)
    for r in _copies(base):
        A.submit(r)
    target = None
    for _ in range(200):
        A.step()
        clock[0] += 0.2
        target = next((rid for rid, doc in A._journal_docs.items()
                       if doc.get("engine") and doc.get("tokens") and rid in A._requests),
                      None)
        if target is not None:
            break
    assert target is not None, f"stalled-leader seed={seed}: no mid-stream journal entry"
    key = f"{FLEET_REQUESTS_PREFIX}/{_rid_key(target)}"
    stale_doc = dict(A._journal_docs[target])
    assert stale_doc.get("owner") == "routerA"
    clock[0] += ROUTER_LEASE * MISS + 1.0
    for _ in range(50):
        B.step()
        clock[0] += 0.2
        if B.is_coordinator:
            break
    assert B.is_coordinator and B.term == 2, f"stalled-leader seed={seed}: term {B.term}"
    assert (store.get(key) or {}).get("owner") == "routerB", store.get(key)
    A._journal_delete(target)
    assert (store.get(key) or {}).get("owner") == "routerB", \
        f"stalled-leader seed={seed}: the deposed leader deleted the successor's entry"
    A._flush_token_journal()
    assert target not in A._journal_docs
    assert store.get(key).get("owner") == "routerB"
    results = list(A.take_results())
    results += B.run([], max_ticks=4000,
                     on_tick=lambda r, n: clock.__setitem__(0, clock[0] + 1.0))
    by_rid = {}
    for res in results:
        assert res.rid not in by_rid, f"stalled-leader seed={seed}: rid {res.rid} served twice"
        by_rid[res.rid] = res
    assert sorted(by_rid) == sorted(r.rid for r in base)
    for rid, res in by_rid.items():
        assert res.finish_reason in ("eos", "length")
        assert np.array_equal(res.output_ids, ref[rid]), f"stalled-leader: rid {rid} diverged"
    assert not store.list(FLEET_REQUESTS_PREFIX)
    assert not store.compare_and_swap(key, None, stale_doc), \
        f"stalled-leader seed={seed}: the tombstone did not block the resurrection"
    assert store.get(key) is None
    for m in members:
        m.sup.engine.close()
    return {"stalled_target": target, "stalled_final_term": B.term,
            "stalled_parity_checked": len(by_rid)}


def serve_main(spec_path: str) -> int:
    """A serving script for ``python -m deepspeed_tpu_torch.launcher --fleet
    N --fleet_daemon ... --module tests._torch_fleet_soak SPEC``: reads the
    launcher's ``DS_TPU_FLEET_*`` contract, waits for the N member daemons'
    advertisements, routes a seeded stream through ``StoreMemberProxy``
    handles, holds it to an in-process engine of the same weights, shuts
    the members down and writes its record to ``<out>/fleet_serve.json``."""
    import json

    from deepspeed_tpu_torch.elasticity import FileCoordinationStore
    from deepspeed_tpu_torch.inference import FleetRouter, StoreMemberProxy

    with open(spec_path) as f:
        spec = json.load(f)
    env = os.environ
    n = int(env["DS_TPU_FLEET_SIZE"])
    lease = float(env["DS_TPU_FLEET_LEASE"])
    store = FileCoordinationStore(env["DS_TPU_FLEET_COORD_DIR"])
    deadline = time.monotonic() + 120.0
    while len(store.list("fleet/engines")) < n:
        if time.monotonic() > deadline:
            raise RuntimeError(f"member daemons never advertised: {store.list('fleet/engines')}")
        time.sleep(0.05)
    model, engine = tiny_engine()
    base = fleet_stream(int(spec.get("seed", 0)), int(spec.get("n_requests", 6)),
                        model.config.vocab_size)
    base = [r for r in base if r.adapter_id is None]      # the members load no adapters
    ref = {r.rid: r.output_ids for r in engine.serving(b_slots=3, page_size=8,
                                                       max_model_len=64).run(_copies(base))}
    proxies = [StoreMemberProxy(f"engine{i}", store, lease_s=lease) for i in range(n)]
    for p in proxies:
        p.beat()
    router = FleetRouter(store, proxies, lease_s=30.0,
                         miss_limit=int(env["DS_TPU_FLEET_MISS_LIMIT"]), journal_every_k=1)
    results = router.run(_copies(base), max_ticks=200000,
                         on_tick=lambda r, rounds: time.sleep(0.002))
    rec = {"env": {k: v for k, v in env.items() if k.startswith("DS_TPU_FLEET")},
           "rids": sorted(r.rid for r in results),
           "token_equal": all(np.array_equal(r.output_ids, ref[r.rid]) for r in results),
           "finish": sorted({r.finish_reason for r in results}),
           "tokens_by_engine": dict(router.tokens_by_engine),
           "journal_left": store.list("fleet/requests")}
    for p in proxies:
        p.send_control("shutdown")
    with open(os.path.join(spec["out"], "fleet_serve.json"), "w") as f:
        json.dump(rec, f)
    return 0


if __name__ == "__main__":
    sys.exit(serve_main(sys.argv[1]))
