"""The port's pod half (``deepspeed_tpu_torch/elasticity/{coordination,
replication,pod_agent}.py``, the pod scope of ``resilience/integrity.py``,
the launcher's pod mode) against the JAX package's, and its own contracts.

Held against ``deepspeed_tpu`` on the same inputs: a JAX
``FileCoordinationStore`` and a port one on ONE directory (documents read
both ways and byte-equal on disk, CAS races between the packages' clients
with exactly one winner, generation bumps from both sides losing no
update, leases written by one aged by the other on an injected clock,
tombstones, stale locks, quarantined documents, elections and channels);
``shrink_to_healthy`` over a grid; ``buddy_ring``, the sealed entries'
bytes and ``plan_adoption`` over the same store contents;
``PodSupervisor``'s round sequences for the same recorded deaths; trace
segments a port publisher wrote read by JAX's ``load_segments``; a tiny
``CausalLM`` on a simulated two-host pod losing its peer at a save and
resuming, bit-equal to the port's uninterrupted run and within 5e-6 of the
JAX engine's uninterrupted fp64 trajectory.

The port's own: the DCP files' attribution to hosts, the torn pod tag
quarantined by the coordinator only, the replica slab's round trip (bf16
included), a slab of another data-parallel world refused with a loud
fallback, live adoption at an unchanged world, the over-cap slab refused
before it is encoded, a collective that raises before the lease lapses
ending in 87, and the launcher's pod mode: a two-host gloo pod whose second
host's spawner is SIGKILLed (the first host's rank exits 87, the next round
runs without the dead host and resumes from the pod-committed tag), and an
all-dead pool returning 86.  Injected clocks, sub-second leases, zero
backoffs; no wall-clock asserts.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu.elasticity import coordination as JC
from deepspeed_tpu.elasticity import pod_agent as JP
from deepspeed_tpu.elasticity import replication as JR
from deepspeed_tpu.observability import trace_assembly as JTA
from deepspeed_tpu.runtime.config import ElasticityConfig as JaxElasticityConfig

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.elasticity import coordination as TC
from deepspeed_tpu_torch.elasticity import pod_agent as TP
from deepspeed_tpu_torch.elasticity import replication as TR
from deepspeed_tpu_torch.elasticity import ElasticityIncompatibleWorldSize
from deepspeed_tpu_torch.launcher import runner
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.observability import trace_assembly as TTA
from deepspeed_tpu_torch.observability.trace import Tracer
from deepspeed_tpu_torch.resilience import (CheckpointIntegrityError, PodCommitTimeout,
                                            clear_injector,
                                            commit_pod_manifest, host_payload_files,
                                            pod_checkpoint_progress_fn, pod_committed,
                                            read_host_manifests, verify_pod_checkpoint_dir,
                                            write_host_manifest)
from deepspeed_tpu_torch.runtime.config import ElasticityConfig as PortElasticityConfig
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

from ._torch_ranks import make_batches, run_ranks
from .test_torch_elasticity import (GOLDEN_TOL, PARAM_OFF_SHARE, PARAM_TOL_EVERY,
                                    STEPS, _fp64_engine, _masters, golden)  # noqa: F401

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_injector():
    clear_injector()
    yield
    clear_injector()


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _stores(tmp_path, clock=None, **kw):
    root = str(tmp_path / "coord")
    return (TC.FileCoordinationStore(root, clock=clock, **kw),
            JC.FileCoordinationStore(root, clock=clock, **kw))


# ---------------------------------------------------------------------------
# One store directory, two packages
# ---------------------------------------------------------------------------

DOCS = {"heartbeat/h0": {"host_id": "h0", "generation": 3, "beat_t": 1.5,
                         "lease_s": 2.0, "attrs": {"step": 7}},
        "rendezvous/gen2/h1": {"host_id": "h1", "t": 0.25},
        "fleet/journal/a.b": {"items": [[1, {"x": [1, 2.5, None]}]], "u": "é"}}


def test_documents_read_both_ways_and_match_on_disk(tmp_path):
    t, j = _stores(tmp_path)
    for i, (key, doc) in enumerate(DOCS.items()):
        (t if i % 2 else j).put(key, doc)
    for key, doc in DOCS.items():
        assert t.get(key) == j.get(key) == doc
    assert t.list("rendezvous/gen2") == j.list("rendezvous/gen2") == ["h1"]
    # the same document written by each package is the same bytes
    t.put("same/port", DOCS["fleet/journal/a.b"])
    j.put("same/jax", DOCS["fleet/journal/a.b"])
    root = tmp_path / "coord" / "same"
    assert (root / "port").read_bytes() == (root / "jax").read_bytes()
    t.delete("heartbeat/h0")
    assert j.get("heartbeat/h0") is None and j.list("heartbeat") == []
    with pytest.raises(ValueError):
        t.get("../escape")


@pytest.mark.parametrize("round_", range(3))
def test_cas_race_between_packages_has_one_winner(round_, tmp_path):
    roots = str(tmp_path / "coord")
    clients = [TC.FileCoordinationStore(roots), JC.FileCoordinationStore(roots)] * 4
    won, start = [], threading.Barrier(len(clients))

    def race(i, store):
        start.wait()
        if store.compare_and_swap("election", None, {"who": i}):
            won.append(i)
    threads = [threading.Thread(target=race, args=(i, s)) for i, s in enumerate(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(won) == 1
    assert clients[0].get("election") == clients[1].get("election") == {"who": won[0]}
    assert not any(n.endswith(".lock") for n in os.listdir(roots))


def test_generation_bumps_from_both_packages_lose_no_update(tmp_path):
    t, j = _stores(tmp_path)
    got, lock = [], threading.Lock()

    def bump(mod, store):
        for _ in range(10):
            g = mod.bump_generation(store)
            with lock:
                got.append(g)
    threads = [threading.Thread(target=bump, args=(m, s))
               for m, s in ((TC, t), (JC, j), (TC, t), (JC, j))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert sorted(got) == list(range(1, 41))
    assert TC.read_generation(j) == JC.read_generation(t) == 40


def test_leases_of_one_package_aged_by_the_other(tmp_path):
    clock = Clock()
    t, j = _stores(tmp_path, clock=clock)
    TC.beat(t, "h0", 1, lease_s=1.0, step=3)
    JC.beat(j, "h1", 1, lease_s=1.0)
    for advance, want in ((0.0, []), (2.0, []), (1.5, ["h0", "h1"])):
        clock.t += advance
        assert TC.dead_hosts(j, 1, miss_limit=3) == JC.dead_hosts(t, 1, miss_limit=3) == want
    JC.beat(j, "h1", 1, lease_s=1.0)      # a fresh beat by JAX revives h1
    assert TC.dead_hosts(t, 1, 3, expected=["h0", "h1", "h2"]) == ["h0", "h2"]
    assert TC.lease_table(j)["h0"].attrs == {"step": 3}
    assert {h: dataclasses.astuple(l) for h, l in JC.lease_table(t).items()} == \
        {h: dataclasses.astuple(l) for h, l in TC.lease_table(t).items()}
    # dead markers: the first reporter wins, a stale generation never clobbers
    TC.record_dead(t, "h0", 2, "h1")
    JC.record_dead(j, "h0", 1, "h9")
    assert JC.dead_set(t) == TC.dead_set(j) == ["h0"]
    assert j.get("dead/h0")["reported_by"] == "h1"
    JC.clear_dead(j, "h0")
    assert TC.dead_set(t) == []


def test_tombstones_locks_and_quarantine_shared(tmp_path):
    t, j = _stores(tmp_path, lock_stale_s=0.0, cas_timeout_s=2.0)
    t.put("d/k", {"v": 1})
    assert t.compare_and_delete("d/k", {"v": 1})
    assert not j.compare_and_swap("d/k", None, {"v": 2})   # fenced by the port's tomb
    j.clear_tombstone("d/k")
    assert t.compare_and_swap("d/k", None, {"v": 3})
    # a lock orphaned by a JAX writer is broken by a port writer
    d = tmp_path / "coord" / "d"
    lock = d / "k.lock"
    lock.write_text("")
    os.utime(lock, (time.time() - 10, time.time() - 10))
    assert t.compare_and_swap("d/k", {"v": 3}, {"v": 4}) and not lock.exists()
    # a torn document: quarantined the same way by either, invisible to list
    (d / "torn").write_text('{"half": ')
    assert t.get("d/torn") is None and t.corrupt_docs_total == 1
    (d / "torn").write_text('{"half": ')
    assert j.get("d/torn") is None
    assert sorted(os.listdir(d)) == ["k", "torn.corrupt", "torn.corrupt.1"]
    assert t.list("d") == j.list("d") == ["k"]


def test_election_channels_and_rendezvous_across_packages(tmp_path):
    clock = Clock()
    t, j = _stores(tmp_path, clock=clock)
    lease = TC.elect_coordinator(t, "port", 1.0)
    assert lease.term == 1 and JC.elect_coordinator(j, "jax", 1.0) is None
    assert JC.read_coordinator(j).leader_id == "port"
    clock.t += 1.5
    assert JC.elect_coordinator(j, "jax", 1.0).term == 2
    assert TC.elect_coordinator(t, "port", 1.0) is None
    assert JC.resign_coordinator(j, "jax") and TC.elect_coordinator(t, "port", 1.0).term == 3
    seqs = [TC.channel_append(t, "fleet/ch", {"n": i}, "port") for i in range(3)]
    seqs.append(JC.channel_append(j, "fleet/ch", {"n": 3}, "jax"))
    assert seqs == [1, 2, 3, 4]
    assert JC.channel_consume(j, "fleet/ch", "c") == [(i + 1, {"n": i}) for i in range(4)]
    assert TC.channel_stats(t, "fleet/ch") == JC.channel_stats(j, "fleet/ch")
    threads = [threading.Thread(target=m.rendezvous, args=(s, h, 5, ["a", "b"], 10.0))
               for m, s, h in ((TC, t, "a"), (JC, j, "b"))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert sorted(j.list("rendezvous/gen5")) == ["a", "b"]


def test_advertisements_roll_up_alike(tmp_path):
    from deepspeed_tpu.monitor import InMemoryMonitor as JM

    from deepspeed_tpu_torch.monitor import InMemoryMonitor as TM

    clock = Clock()
    t, j = _stores(tmp_path, clock=clock)
    TC.advertise_host(t, "h0", 1, step=2)
    JC.advertise_host(j, "h1", 1)
    tm, jm = TM(), JM()
    assert TC.rollup_host_gauges(j, tm, tick=1) == JC.rollup_host_gauges(t, jm, tick=1)
    assert TC.host_advertisements(j)["h0"]["attrs"] == {"step": 2}


# ---------------------------------------------------------------------------
# The trace segments
# ---------------------------------------------------------------------------

def test_port_publisher_segments_load_in_jax(tmp_path):
    t, j = _stores(tmp_path)
    tracer = Tracer(enabled=True)
    for i in range(3):
        with tracer.span("serve.tick", rid=i, engine="e0"):
            pass
    pub = TTA.TraceSegmentPublisher(t, "e0", max_spans=2)
    assert pub.publish(tracer, force=True) == 3
    assert pub.publish(tracer, force=True) == 0     # incremental
    assert pub.dropped_total == 1
    got, want = TTA.load_segments(t), JTA.load_segments(j)
    assert got == want and got["e0"]["dropped"] == 1
    assert [s["tags"]["rid"] for s in got["e0"]["spans"]] == [1, 2]
    assert JTA.assemble_fleet_trace(want)["traceEvents"] == \
        TTA.assemble_fleet_trace(got)["traceEvents"]


# ---------------------------------------------------------------------------
# Plans, buddies, adoption plans and supervisor rounds against JAX
# ---------------------------------------------------------------------------

SHRINK_BLOCKS = [
    {"enabled": True, "max_train_batch_size": 16, "micro_batch_sizes": [2, 4],
     "min_gpus": 1, "max_gpus": 4},
    {"enabled": True, "max_train_batch_size": 4, "micro_batch_sizes": [1],
     "min_gpus": 1, "max_gpus": 4},
    {"enabled": True, "max_train_batch_size": 96, "micro_batch_sizes": [2, 3],
     "min_gpus": 2, "max_gpus": 12},
    {"enabled": True, "max_train_batch_size": 256, "micro_batch_sizes": [2, 4],
     "min_gpus": 8, "max_gpus": 64, "version": 0.2, "num_gpus_per_node": 8},
]


def _outcome(fn, *args, **kw):
    try:
        members, plan = fn(*args, **kw)
        return ("ok", members, plan.as_triad(), list(plan.valid_device_counts))
    except Exception as e:
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("block", range(len(SHRINK_BLOCKS)))
def test_shrink_to_healthy_matches_jax(block):
    cfg = SHRINK_BLOCKS[block]
    for n_hosts in (0, 1, 2, 3, 4, 5, 8):
        hosts = [f"host{i}" for i in range(n_hosts)][::-1]
        for chips in (1, 2, 4, 8):
            got = _outcome(TP.shrink_to_healthy, PortElasticityConfig(**cfg), hosts, chips)
            want = _outcome(JP.shrink_to_healthy, JaxElasticityConfig(**cfg), hosts, chips)
            assert got == want, (n_hosts, chips)
    with pytest.raises(ElasticityIncompatibleWorldSize):
        TP.shrink_to_healthy(PortElasticityConfig(**SHRINK_BLOCKS[0]), [])


@pytest.mark.parametrize("hosts", [[], ["h0"], ["h1", "h0"], ["c", "a", "b"],
                                   [f"w{i}" for i in (3, 11, 2, 10)]], ids=str)
def test_buddy_ring_matches_jax(hosts):
    assert TR.buddy_ring(hosts) == JR.buddy_ring(hosts)


def test_sealed_entries_match_jax():
    payload = bytes(range(256)) * 3
    got, want = TR.seal_entry(payload, 6, 2), JR.seal_entry(payload, 6, 2)
    assert got == want and json.dumps(got) == json.dumps(want)
    assert TR.verify_entry(want) == JR.verify_entry(got) == payload
    for field_, value in (("sha256", "0" * 64), ("bytes", 1), ("payload", "!!")):
        bad = dict(got, **{field_: value})
        with pytest.raises(TR.ReplicaIntegrityError):
            TR.verify_entry(bad)
        with pytest.raises(JR.ReplicaIntegrityError):
            JR.verify_entry(bad)


HOSTS = ["h0", "h1", "h2"]
ADOPTION_CASES = {
    "newest-cut": ({h: [2, 4] for h in HOSTS}, 1, [("h1", 1)], ["h1"]),
    "mid-seal": ({"h0": [2, 4], "h1": [2], "h2": [2, 4]}, 1, [("h1", 1)], ["h1"]),
    "missing-slab": ({"h0": [2], "h1": [2]}, 1, [("h1", 1)], ["h1"]),
    "double-kill": ({h: [2] for h in HOSTS}, 1, [], ["h1", "h2"]),
    "fence": ({h: [2, 4] for h in HOSTS}, 1, [("h1", 2)], ["h1"]),
    "no-victim": ({h: [2] for h in HOSTS}, 1, [], ["elsewhere"]),
}


def _plan(mod, store, dead):
    try:
        plan = mod.plan_adoption(store, HOSTS, dead)
        return ("ok", plan["step"], plan["generation"], plan["victims"],
                {h: e["sha256"] for h, e in plan["entries"].items()})
    except mod.ReplicaAdoptionError as e:
        return ("raised", str(e))


@pytest.mark.parametrize("case", list(ADOPTION_CASES))
def test_plan_adoption_matches_jax_on_the_same_store(case, tmp_path):
    steps_by_host, generation, dead_marks, dead = ADOPTION_CASES[case]
    t, j = _stores(tmp_path)
    ring = TR.buddy_ring(sorted(steps_by_host))
    for i, (h, steps) in enumerate(sorted(steps_by_host.items())):
        for step in steps:
            # the packages take turns writing the slabs
            mod, store = (TR, t) if (i + step) % 2 else (JR, j)
            mod.publish_replica(store, h, mod.seal_entry(f"{h}@{step}".encode(), step,
                                                         generation), buddy=ring.get(h))
    for victim, gen in dead_marks:
        TC.record_dead(t, victim, gen, "h0")
    assert _plan(TR, t, dead) == _plan(JR, j, dead)
    if case == "newest-cut":
        assert TR.claim_adoption(t, 3, "h1", "h2", 4, 1)
        assert not JR.claim_adoption(j, 3, "h1", "h0", 4, 1)
        assert JR.claim_adoption(j, 3, "h1", "h2", 4, 1)


DEATHS = {"one-of-four": (["host0", "host1", "host2", "host3"], {1: ["host3"]}),
          "two-rounds": (["host0", "host1", "host2", "host3"], {1: ["host1"], 2: ["host0"]}),
          "all": (["host0", "host1"], {1: ["host0", "host1"]})}


def _rounds(mod, cmod, tmp_path, hosts, deaths):
    store = cmod.FileCoordinationStore(str(tmp_path))
    cfg = (PortElasticityConfig if mod is TP else JaxElasticityConfig)(
        enabled=True, max_train_batch_size=16, micro_batch_sizes=[2, 4], min_gpus=1,
        max_gpus=4)
    seen = []

    def attempt(rnd):
        seen.append((rnd.generation, list(rnd.hosts), rnd.plan.as_triad(),
                     list(rnd.prev_hosts), list(rnd.dead)))
        for h in deaths.get(len(seen), []):
            cmod.record_dead(store, h, rnd.generation, "watchdog")
        return cmod.RC_POD_PEER_LOST if len(seen) in deaths else 0

    sup = mod.PodSupervisor(store, cfg, attempt, hosts, backoff_s=0, max_restarts=4)
    return seen, sup.run(), sup.diagnosis


@pytest.mark.parametrize("case", list(DEATHS))
def test_pod_supervisor_rounds_match_jax(case, tmp_path):
    hosts, deaths = DEATHS[case]
    got = _rounds(TP, TC, tmp_path / "port", hosts, deaths)
    assert got == _rounds(JP, JC, tmp_path / "jax", hosts, deaths)
    if case == "all":
        assert got[1] == TP.RC_POD_UNRECOVERABLE and "unrecoverable" in got[2]


# ---------------------------------------------------------------------------
# The pod scope of a tag: attribution, commit, verification
# ---------------------------------------------------------------------------

LAYOUT = ["state/__0_0.distcp", "state/__1_0.distcp", "state/.metadata",
          "client_state.json", "ds_config.json", "offload_optimizer/rank1/m.npy",
          "comm_state/rank0.pt"]


def _tag(tmp_path, layout=LAYOUT):
    tag = tmp_path / "global_step3"
    for rel in layout:
        p = tag / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(rel.encode() * 3)
    (tag / "manifest.json").write_text(json.dumps({"global_steps": 3}))
    return str(tag)


def test_dcp_files_attributed_to_their_hosts(tmp_path):
    tag = _tag(tmp_path)
    h0, h1 = host_payload_files(tag, [0]), host_payload_files(tag, 1)
    assert sorted(h0 + h1) == sorted(LAYOUT) and not set(h0) & set(h1)
    assert sorted(h1) == ["offload_optimizer/rank1/m.npy", "state/__1_0.distcp"]
    assert host_payload_files(tag, [0, 1]) == sorted(LAYOUT)
    for host, ranks in (("h0", [0]), ("h1", [1])):
        write_host_manifest(tag, host, 2, 3, files=host_payload_files(tag, ranks),
                            owner=ranks[0])
    commit_pod_manifest(tag, 2, ["h1", "h0"], timeout_s=1.0)
    assert verify_pod_checkpoint_dir(tag)["hosts"] == ["h0", "h1"]
    os.remove(os.path.join(tag, "state", "__1_0.distcp"))
    with pytest.raises(CheckpointIntegrityError, match=r"hosth1:state/__1_0\.distcp: missing"):
        verify_pod_checkpoint_dir(tag)


def test_misattributed_shard_refuses_the_commit(tmp_path):
    tag = _tag(tmp_path)
    write_host_manifest(tag, "h0", 1, 3, files=["state/__1_0.distcp"], owner=0)
    with pytest.raises(CheckpointIntegrityError, match="misattribution"):
        commit_pod_manifest(tag, 1, ["h0"], timeout_s=1.0)
    # a host of two ranks stamps both
    write_host_manifest(tag, "h0", 1, 3, files=host_payload_files(tag, [0, 1]), owner=0,
                        ranks=[0, 1])
    commit_pod_manifest(tag, 1, ["h0"], timeout_s=1.0)
    assert read_host_manifests(tag)["h0"]["ranks"] == [0, 1]


def test_commit_waits_for_the_generation_and_progress_counts_pod_tags(tmp_path):
    tag = _tag(tmp_path)
    progress = pod_checkpoint_progress_fn(str(tmp_path))
    write_host_manifest(tag, "h0", 2, 3, files=["state/__0_0.distcp"], owner=0)
    write_host_manifest(tag, "h1", 1, 3)                  # a stale generation
    with pytest.raises(PodCommitTimeout) as e:
        commit_pod_manifest(tag, 2, ["h0", "h1"], timeout_s=0.2, poll_s=0.05)
    assert e.value.missing == ["h1"] and not pod_committed(tag) and progress() == -1
    write_host_manifest(tag, "h1", 2, 3)
    commit_pod_manifest(tag, 2, ["h0", "h1"], timeout_s=1.0)
    assert progress() == 3
    # the JAX package reads the port's pod manifest and host manifests
    from deepspeed_tpu.resilience import integrity as JI

    from deepspeed_tpu_torch.resilience.integrity import read_pod_manifest

    assert JI.read_pod_manifest(tag) == read_pod_manifest(tag)
    assert JI.read_host_manifests(tag) == read_host_manifests(tag)


# ---------------------------------------------------------------------------
# Engines on a simulated pod
# ---------------------------------------------------------------------------

TINY = {"train_micro_batch_size_per_gpu": 2, "seed": 0,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}, "steps_per_print": 10 ** 9}


def _tiny(dtype=torch.float32, config=TINY):
    eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=dtype), config=config, device="cpu")
    return eng


def _write_shard(tag_dir, host):
    rel = os.path.join("shards", f"{host}.bin")
    os.makedirs(os.path.join(tag_dir, "shards"), exist_ok=True)
    with open(os.path.join(tag_dir, rel), "wb") as f:
        f.write(f"shard of {host}".encode() * 4)
    return [rel]


class Peer:
    """A simulated host as a thread: beats its lease and lands a host
    manifest for every commit the coordinator announces, until it dies
    (``die_at``: the tag at which it stops, before its manifest)."""

    def __init__(self, store, ckpt, host, generation, lease_s=0.2, die_at=None):
        self.store, self.ckpt, self.host, self.gen = store, ckpt, host, generation
        self.lease_s, self.die_at = lease_s, die_at
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        TC.beat(store, host, generation, lease_s)
        self.thread.start()

    def _loop(self):
        done = set()
        while not self.stop.is_set():
            tag = TP.pending_commit(self.store, self.gen)
            if tag is not None and tag == self.die_at:
                return            # dead: no more beats, no manifest
            TC.beat(self.store, self.host, self.gen, self.lease_s)
            if tag is not None and tag not in done:
                done.add(tag)
                d = os.path.join(self.ckpt, tag)
                write_host_manifest(d, self.host, self.gen,
                                    int(tag.replace("global_step", "")),
                                    files=_write_shard(d, self.host))
            time.sleep(0.01)

    def join(self):
        self.stop.set()
        self.thread.join(timeout=10)


def test_lost_peer_at_a_save_resumes_bit_equal_and_matches_jax_fp64(golden, tmp_path):
    """Generation 1: a two-host pod (this engine is h0, a thread is h1)
    pod-commits step 2; h1 dies at step 4's save, h0's commit waits, its
    watchdog declares h1 dead and the round raises ``PodPeerLost``.
    Generation 2 at [h0]: the torn global_step4 is quarantined and the run
    resumes from global_step2 to the end."""
    params_np, batches, jax_losses, jax_params = golden
    ref = _fp64_engine(params_np)
    want = [float(ref.train_batch(batch=b)) for b in batches]
    store, ckpt = TC.FileCoordinationStore(str(tmp_path / "coord")), str(tmp_path / "ckpt")
    losses, dead_seen = [], []

    def step_fn(engine, step):
        losses.append(float(engine.train_batch(batch=batches[step])))

    gen = TC.bump_generation(store)
    ctx = TP.PodContext(store, "h0", ["h0", "h1"], gen, lease_s=0.2, miss_limit=3,
                        commit_timeout_s=3.0)
    peer = Peer(store, ckpt, "h1", gen, die_at="global_step4")
    wd = ctx.watchdog(on_peer_dead=dead_seen.append).start()
    agent = TP.PodElasticAgent(_fp64_engine(params_np), ckpt, ctx, watchdog=wd, ckpt_every=2)
    try:
        with pytest.raises(TP.PodPeerLost) as e:
            agent.run(step_fn, STEPS)
    finally:
        wd.stop()
        peer.join()
        agent.guard.uninstall()
    assert e.value.host == "h1" and e.value.rc == 87 and dead_seen == ["h1"]
    assert TC.dead_set(store) == ["h1"] and len(losses) == 4
    assert pod_committed(os.path.join(ckpt, "global_step2"))
    assert not pod_committed(os.path.join(ckpt, "global_step4"))

    gen = TC.bump_generation(store)
    ctx = TP.PodContext(store, "h0", [h for h in ["h0", "h1"] if h not in TC.dead_set(store)],
                        gen, lease_s=0.2, commit_timeout_s=5.0)
    second = TP.PodElasticAgent(_fp64_engine(params_np), ckpt, ctx, ckpt_every=2)
    resumed = []
    try:
        assert second.run(lambda e_, s: resumed.append(
            float(e_.train_batch(batch=batches[s]))), STEPS) == STEPS
    finally:
        second.guard.uninstall()
    assert second.resumed_tag == "global_step2" and second.timings["sweep_s"] >= 0
    assert sorted(os.listdir(ckpt)) == ["global_step2", "global_step4", "global_step4.corrupt",
                                        "global_step6", "latest"]
    for tag in ("global_step4", "global_step6"):
        pod = verify_pod_checkpoint_dir(os.path.join(ckpt, tag))
        assert pod["generation"] == 2 and pod["hosts"] == ["h0"]
    got = losses[:2] + resumed
    assert got == want                                          # bit for bit
    final, ref_final = _masters(second.engine), _masters(ref)
    assert all(torch.equal(final[k], ref_final[k]) for k in ref_final)
    np.testing.assert_allclose(got, jax_losses, **GOLDEN_TOL)
    for k, v in jax_params.items():
        np.testing.assert_allclose(final[k].numpy(), v, err_msg=k, **PARAM_TOL_EVERY)
        assert (~np.isclose(final[k].numpy(), v, **GOLDEN_TOL)).mean() <= PARAM_OFF_SHARE, k


def test_torn_tag_ahead_of_latest_is_quarantined_by_the_coordinator_only(tmp_path):
    ckpt, store = tmp_path / "ckpt", TC.FileCoordinationStore(str(tmp_path / "coord"))
    for step, torn in ((2, False), (4, True), (6, False), (8, False)):
        d = ckpt / f"global_step{step}"
        d.mkdir(parents=True)
        (d / "manifest.json").write_text(json.dumps({"global_steps": step}))
        (d / "client_state.json").write_text(json.dumps({"global_steps": step}))
        if not torn:
            write_host_manifest(str(d), "h0", 1, step)
            commit_pod_manifest(str(d), 1, ["h0"], timeout_s=1.0)
    (ckpt / "global_step10").mkdir()                   # a torn tag ahead of latest
    (ckpt / "latest").write_text("global_step8")
    for host, local_rank, moved in (("h1", 0, False), ("h0", 1, False), ("h0", 0, True)):
        ctx = TP.PodContext(store, host, ["h0", "h1"], 2, local_rank=local_rank)
        agent = TP.PodElasticAgent(None, str(ckpt), ctx, keep=2)
        try:
            agent._sweep_torn_pod_tags()
            assert (ckpt / "global_step10.corrupt").is_dir() == moved
            assert (ckpt / "global_step4.corrupt").is_dir() == moved
        finally:
            agent.guard.uninstall()
    # pruning is pod-scope: torn tags neither count nor go
    (ckpt / "global_step5").mkdir()
    (ckpt / "global_step5" / "manifest.json").write_text(json.dumps({"global_steps": 5}))
    agent = TP.PodElasticAgent(None, str(ckpt), ctx, keep=2)
    try:
        agent._prune_generations()
    finally:
        agent.guard.uninstall()
    assert sorted(os.listdir(ckpt)) == ["global_step10.corrupt", "global_step4.corrupt",
                                        "global_step5", "global_step6", "global_step8",
                                        "latest"]


def test_save_attests_the_engines_dcp_files(tmp_path):
    eng = _tiny()
    eng.train_batch(batch=make_batches(1, 2, seed=1)[0])
    store = TC.FileCoordinationStore(str(tmp_path / "coord"))
    ctx = TP.PodContext(store, "h0", ["h0"], 1, commit_timeout_s=5.0, host_ranks=[0])
    tag = TP.save_pod_checkpoint(eng, str(tmp_path / "ckpt"), ctx)
    listed = read_host_manifests(tag)["h0"]
    assert listed["owner"] == 0 and "state/__0_0.distcp" in listed["files"]
    assert {"state/.metadata", "client_state.json", "ds_config.json"} <= set(listed["files"])
    assert set(ctx.timings) == {"engine_save_s", "host_manifest_s", "pod_commit_wait_s"}
    assert (tmp_path / "ckpt" / "latest").read_text() == "global_step1"
    assert TP.pending_commit(store, 1) == "global_step1"
    os.remove(os.path.join(tag, "state", "__0_0.distcp"))
    with pytest.raises(CheckpointIntegrityError, match="missing"):
        verify_pod_checkpoint_dir(tag)


# ---------------------------------------------------------------------------
# Replica slabs and adoption
# ---------------------------------------------------------------------------

def _state_equal(a, b):
    ta, tb = tree_flatten_with_path(dataclasses.asdict(a.state)), \
        tree_flatten_with_path(dataclasses.asdict(b.state))
    return len(ta) == len(tb) and all(
        pa == pb and (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        for (pa, x), (pb, y) in zip(ta, tb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_replica_slab_round_trip_is_bit_exact(dtype):
    from deepspeed_tpu_torch.runtime.checkpoint_engine.replica_snapshot import MAGIC

    cfg = {**TINY, **({"bf16": {"enabled": True}} if dtype == torch.bfloat16 else {})}
    a, b = _tiny(dtype, cfg), _tiny(dtype, {**cfg, "seed": 9})
    batches = make_batches(3, 2, seed=4)
    for x in batches[:2]:
        a.train_batch(batch=x)
    slab = a.replica_snapshot()
    assert bytes(slab[:len(MAGIC)]) == b"DSTPUREP1" and len(slab) == a.replica_nbytes()
    head = json.loads(bytes(slab[len(MAGIC) + 8:len(MAGIC) + 8 + int.from_bytes(
        slab[len(MAGIC):len(MAGIC) + 8], "little")]))
    assert head["global_steps"] == 2 and head["format"] == 1
    assert (dtype == torch.bfloat16) == ("bfloat16" in {l["dtype"] for l in head["leaves"]})
    assert b.replica_ingest(bytes(slab)) == 2 and _state_equal(a, b)
    assert float(a.train_batch(batch=batches[2])) == float(b.train_batch(batch=batches[2]))
    assert bytes(a.replica_snapshot()) == bytes(b.replica_snapshot())
    for bad in (b"garbage", bytes(slab) + b"x", bytes(slab)[:-3]):
        with pytest.raises(ValueError):
            b.replica_ingest(bad)


ZERO2 = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "seed": 0,
         "zero_optimization": {"stage": 2}, "steps_per_print": 10 ** 9,
         "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}


def test_slab_of_another_world_refuses_and_adoption_falls_back_loudly(tmp_path):
    """Slabs sealed by a ZeRO-2 job of two ranks do not fit the one-rank
    engine of the next round: ingestion raises, adoption falls back to the
    checkpoint walk (``replica_fallbacks_total`` + 1)."""
    slabs = run_ranks(2, "replica_slab", tmp_path, config=ZERO2, steps=2, seed=4)
    cfg = {**ZERO2, "train_micro_batch_size_per_gpu": 2}
    eng = _tiny(config=cfg)
    with pytest.raises(ValueError, match="mismatch"):
        eng.replica_ingest(bytes(slabs[0].numpy()))
    store = TC.FileCoordinationStore(str(tmp_path / "coord"))
    for h, slab in zip(["h0", "h1"], slabs):
        TR.publish_replica(store, h, TR.seal_entry(bytes(slab.numpy()), 2, 1),
                           buddy="h1" if h == "h0" else "h0")
    TC.record_dead(store, "h1", 1, "h0")
    ckpt = str(tmp_path / "ckpt")
    eng.train_batch(batch=make_batches(1, 4, seed=4)[0])
    TP.save_pod_checkpoint(eng, ckpt, TP.PodContext(store, "h0", ["h0"], 1))
    before = TR.replica_fallbacks_total()
    ctx = TP.PodContext(store, "h0", ["h0"], 2)
    agent = TP.PodElasticAgent(_tiny(config=cfg), ckpt, ctx,
                               adopt_prev_hosts=["h0", "h1"], adopt_dead=["h1"])
    try:
        assert agent.restore_if_present() == 1 and agent.resumed_tag == "global_step1"
    finally:
        agent.guard.uninstall()
    assert TR.replica_fallbacks_total() == before + 1 and agent.adopted_step is None


def test_live_adoption_at_an_unchanged_world_resumes_at_the_cut(tmp_path):
    store, ckpt = TC.FileCoordinationStore(str(tmp_path / "coord")), str(tmp_path / "ckpt")
    batches = make_batches(6, 2, seed=5)
    ref = _tiny()
    want = [float(ref.train_batch(batch=b)) for b in batches]
    eng = _tiny()
    rep = TR.HostReplicator(store, "h0", 1, ["h0", "h1"], eng.replica_snapshot,
                            replica_every_k=2)
    assert rep.slab_bytes_fn == eng.replica_nbytes
    losses = []
    for s, b in enumerate(batches[:5]):
        losses.append(float(eng.train_batch(batch=b)))
        rep.maybe_replicate(s + 1)
        if (s + 1) % 2 == 0:      # the peer seals the same boundaries
            TR.publish_replica(store, "h1", TR.seal_entry(b"h1 shard", s + 1, 1), buddy="h0")
    rep.stop()
    assert rep.seals_total == 2 and rep.publish_failures == 0
    TC.record_dead(store, "h1", 1, "h0")       # h1 dies after step 5
    before = TR.replica_adoptions_total()
    ctx = TP.PodContext(store, "h0", ["h0"], 2)
    agent = TP.PodElasticAgent(_tiny(), ckpt, ctx, adopt_prev_hosts=["h0", "h1"],
                               adopt_dead=["h1"])
    got = []
    try:
        agent.run(lambda e, s: got.append(float(e.train_batch(batch=batches[s]))), 6)
    finally:
        agent.guard.uninstall()
    assert agent.adopted_step == agent.resumed_step == 4        # the cut: no rollback
    assert TR.replica_adoptions_total() == before + 1
    assert losses[:4] + got == want
    assert store.get("pod/adopt/gen2/h1")["adopter"] == "h0"


def test_over_cap_slab_is_refused_before_it_is_encoded(tmp_path, monkeypatch):
    store = TC.FileCoordinationStore(str(tmp_path))
    calls = []

    def never(*a):
        calls.append(a)
        raise AssertionError("a refused slab was built, checksummed or encoded")

    class Engine:   # the engine's pair of hooks: the size is known first
        replica_snapshot = never

        def replica_nbytes(self):
            return TR.REPLICA_MAX_BYTES + 1
    rep = TR.HostReplicator(store, "h0", 1, ["h0", "h1"], Engine().replica_snapshot,
                            replica_every_k=1)
    monkeypatch.setattr(TR, "seal_entry", never)
    assert rep.maybe_replicate(1) is False and not rep.seal_now(2)
    assert rep.publish_failures == 2 and TR.read_replica(store, "h0") is None and not calls
    # a source without a size hook: the snapshot's length decides, before
    # any encoding
    big = bytes(TR.REPLICA_MAX_BYTES + 1)
    rep = TR.HostReplicator(store, "h0", 1, ["h0", "h1"], lambda: big, replica_every_k=1)
    assert rep.maybe_replicate(1) is False and rep.publish_failures == 1 and not calls
    rep.stop()


def test_a_collective_that_raises_before_the_lease_lapses_ends_in_87(tmp_path):
    """Over gloo a dead peer can make a collective raise (connection reset)
    before its lease expires: the agent waits for the scan and raises
    ``PodPeerLost`` (exit 87), not the collective's error (exit 1); with
    every peer alive the error is re-raised."""
    store = TC.FileCoordinationStore(str(tmp_path / "coord"))
    for peer_alive in (False, True):
        TC.bump_generation(store)
        gen = TC.read_generation(store)
        ctx = TP.PodContext(store, "h0", ["h0", "h1"], gen, lease_s=0.1, miss_limit=3)
        TC.beat(store, "h1", gen, 0.1)
        stop = threading.Event()
        if peer_alive:
            def keep_beating():
                while not stop.is_set():
                    TC.beat(store, "h1", gen, 0.1)
                    time.sleep(0.02)
            threading.Thread(target=keep_beating, daemon=True).start()
        declared = []
        wd = ctx.watchdog(on_peer_dead=declared.append, grace_beats=0).start()
        agent = TP.PodElasticAgent(None, str(tmp_path / f"ckpt{gen}"), ctx, watchdog=wd)

        def step_fn(engine, step):
            raise RuntimeError("[gloo] Connection reset by peer")
        try:
            if peer_alive:
                with pytest.raises(RuntimeError, match="Connection reset"):
                    agent.run(step_fn, 3)
            else:
                with pytest.raises(TP.PodPeerLost) as e:
                    agent.run(step_fn, 3)
                assert e.value.rc == 87 and declared == ["h1"]
                assert isinstance(e.value.__cause__, RuntimeError)
        finally:
            stop.set()
            wd.stop()
            agent.guard.uninstall()


def test_watchdog_publishes_the_dead_after_their_markers(tmp_path):
    """A step loop that sees ``watchdog.dead`` may exit the process at
    once, so the dead markers must already be durable: the next round
    reads them to leave the dead host out."""
    clock = Clock()
    seen = []

    class Store(TC.FileCoordinationStore):
        def compare_and_swap(self, key, expected, new):
            if key.startswith("dead/"):
                seen.append(list(wd.dead))
            return super().compare_and_swap(key, expected, new)
    store = Store(str(tmp_path), clock=clock)
    TC.beat(store, "h1", 1, 1.0)
    wd = TC.HeartbeatWatchdog(store, "h0", 1, ["h0", "h1"], lease_s=1.0, miss_limit=2,
                              on_peer_dead=lambda h: None, grace_beats=0)
    wd.beat_once()
    clock.t += 2.5
    wd.tick_once()
    assert seen == [[]] and wd.dead == ["h1"] and TC.dead_set(store) == ["h1"]


def test_scanning_watchdog_renews_nothing_but_declares(tmp_path):
    clock = Clock()
    store = TC.FileCoordinationStore(str(tmp_path), clock=clock)
    TC.beat(store, "h1", 1, 1.0)
    seen = []
    wd = TC.HeartbeatWatchdog(store, "h0", 1, ["h0", "h1"], lease_s=1.0, miss_limit=2,
                              renew=False, on_peer_dead=seen.append, grace_beats=1)
    wd.beat_once()
    assert store.list("heartbeat") == ["h1"] and wd.beats == 1
    clock.t += 2.5
    wd.tick_once()
    assert seen == ["h1"] and TC.dead_set(store) == ["h1"]
    assert store.list("heartbeat") == ["h1"] and store.list("pod/hosts") == []


# ---------------------------------------------------------------------------
# The launcher's pod mode
# ---------------------------------------------------------------------------

def test_pod_attempt_bumps_the_generation_and_exports_the_contract(tmp_path, monkeypatch):
    coord = str(tmp_path / "coord")
    args = runner.parse_args(["--pod_coord_dir", coord, "--pod_lease", "2.5",
                              "--elastic_restarts", "3", "train.py"])
    seen = []
    monkeypatch.setattr(runner, "_dispatch",
                        lambda a: seen.append(os.environ["DS_TPU_POD_GENERATION"]) or 0)
    try:
        attempt = runner._pod_attempt(args)
        assert attempt(0) == attempt(1) == 0 and seen == ["1", "2"]
        assert os.environ["DS_TPU_POD_COORD_DIR"] == coord
        assert os.environ["DS_TPU_POD_LEASE"] == "2.5"
        assert os.environ["DS_TPU_POD_MISS_LIMIT"] == "3"
        assert runner._pod_env(args)["DS_TPU_POD_GENERATION"] == "2"
        assert JC.read_generation(JC.FileCoordinationStore(coord)) == 2
    finally:
        for key in ("DS_TPU_POD_COORD_DIR", "DS_TPU_POD_GENERATION", "DS_TPU_POD_LEASE",
                    "DS_TPU_POD_MISS_LIMIT"):
            os.environ.pop(key, None)
    assert runner._pod_env(args)["DS_TPU_POD_GENERATION"] == "2"   # the store's, unset


def test_pod_context_from_the_launchers_environment(tmp_path):
    coord = tmp_path / "coord"
    store = TC.FileCoordinationStore(str(coord))
    TC.record_dead(store, "hC", 1, "hA")
    info = runner.encode_world_info(OrderedDict([("hA", [0, 1]), ("hB", [0, 1]),
                                                 ("hC", [0])]))
    env = {"DS_TPU_POD_COORD_DIR": str(coord), "DS_TPU_POD_GENERATION": "4",
           "DS_TPU_POD_LEASE": "0.5", "DS_TPU_POD_MISS_LIMIT": "2",
           "DS_TPU_WORLD_INFO": info, "NODE_RANK": "1", "RANK": "3", "LOCAL_RANK": "1",
           "LOCAL_WORLD_SIZE": "2", "DS_TPU_POD_HOST": "hB"}
    ctx = TP.PodContext.from_env(env=env)
    assert (ctx.host_id, ctx.hosts, ctx.generation, ctx.lease_s, ctx.miss_limit) == \
        ("hB", ["hA", "hB"], 4, 0.5, 2)
    assert ctx.ranks == [2, 3] and ctx.local_rank == 1 and not ctx.is_coordinator
    assert not ctx.watchdog().renew and TP.pod_host_id(env) == "hB"
    # no guessed host id (a wrong one makes hosts act as one) and no
    # guessed rank count (a host would attest only one rank's shards)
    for key in ("DS_TPU_POD_HOST", "LOCAL_WORLD_SIZE"):
        with pytest.raises(RuntimeError, match=key):
            TP.PodContext.from_env(env={k: v for k, v in env.items() if k != key})


@pytest.mark.parametrize("lease,miss", [(None, None), (0.5, 3), (5.0, 3), (10.0, 5)])
def test_pod_reap_grace_outlasts_the_watchdogs_detection(lease, miss):
    env = {} if lease is None else {"DS_TPU_POD_COORD_DIR": "/c", "DS_TPU_POD_LEASE": str(lease),
                                    "DS_TPU_POD_MISS_LIMIT": str(miss)}
    grace = runner.reap_grace_s(env)
    assert grace >= runner.KILL_GRACE_S
    if lease is not None:   # the agent's scan wait after a raise, and a lease more
        assert grace >= lease * miss + lease / 3 + lease


def test_wait_all_or_fail_reaps_on_87():
    hang = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
    lost = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(87)"])
    assert runner.wait_all_or_fail([hang, lost], poll_s=0.05, kill_grace_s=0.5) == 87
    assert hang.poll() is not None


def _child_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
           and not k.startswith("DS_TPU_POD")}
    env.update(DS_ACCELERATOR="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]))
    return env


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


ELASTIC = {"elasticity": {"enabled": True, "max_train_batch_size": 4,
                          "micro_batch_sizes": [1, 2], "min_gpus": 1, "max_gpus": 2},
           "zero_optimization": {"stage": 2},
           "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
           "gradient_clipping": 1.0, "steps_per_print": 10 ** 9, "seed": 3}
RESIZE_TOL = dict(rtol=1e-5, atol=1e-5)


def test_two_host_gloo_pod_loses_a_host_and_reforms(tmp_path):
    """Two host aliases of one rank each (``--launcher local``), ZeRO-2
    over gloo.  Host hB's rank holds after step 3 and its spawner is
    SIGKILLed: hA's rank exits 87 (its watchdog declared hB dead); the next
    round, generation 2, leaves hB out of the pool, runs one rank at the
    plan's gas 2 and resumes from the pod-committed global_step2.  Every
    loss is within 1e-5 of the uninterrupted world-1 run (fp32, full rows).

    The launcher's fail-fast reap starts with hB's spawner gone, before hA
    has declared hB; its base grace is cut below the lease times the miss
    limit, so hA's marker lands only if the reap waits out the detection."""
    ready, spec = tmp_path / "ready", tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "out": str(tmp_path), "mode": "pod", "config": ELASTIC, "steps": 6, "data_seed": 5,
        "ignore": False, "ckpt_dir": str(tmp_path / "ckpt"), "ckpt_every": 2,
        "pod_hosts": ["hA", "hB"], "hold": {"rank": 1, "after_step": 3, "ready": str(ready)}}))
    (tmp_path / "hostfile").write_text("hA slots=1\nhB slots=1\n")
    grace = 0.2
    assert grace < 0.5 * 3
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys; from deepspeed_tpu_torch.launcher import runner; "
         f"runner.KILL_GRACE_S = {grace}; sys.exit(runner.main())",
         "-H", str(tmp_path / "hostfile"),
         "--launcher", "local", "--master_port", str(_free_port()),
         "--pod_coord_dir", str(tmp_path / "coord"), "--pod_lease", "0.5",
         "--pod_miss_limit", "3", "--elastic_restarts", "1", "--elastic_backoff", "0",
         "--elastic_ckpt_dir", str(tmp_path / "ckpt"), "--module", "tests._torch_elastic_child",
         str(spec)], cwd=str(ROOT), env=_child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        deadline = time.monotonic() + 180
        while not ready.exists() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert ready.exists(), proc.stdout.read()[-4000:] if proc.poll() is not None else ""
        spawner = subprocess.run(["pgrep", "-P", str(proc.pid), "-f", "node_rank=1"],
                                 capture_output=True, text=True).stdout.split()
        assert len(spawner) == 1
        os.kill(int(spawner[0]), signal.SIGKILL)
        out, _ = proc.communicate(timeout=240)
    finally:
        try:   # the launcher, its spawners and their ranks
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    assert proc.returncode == 0, out[-4000:]
    recs = [json.loads(line) for line in (tmp_path / "rank0.jsonl").read_text().splitlines()]
    gens = {r["generation"] for r in recs}
    assert gens == {1, 2}
    first = [r for r in recs if r["generation"] == 1]
    second = [r for r in recs if r["generation"] == 2]
    assert first[-1]["event"] == "peer_dead" and first[-1]["dead"] == "hB"
    # hA's spawner returned its rank's 87 when the launcher reaped it
    assert "exited rc=87" in out and "excluding dead host(s) ['hB']" in out
    assert second[0]["hosts"] == ["hA"] and second[-1]["event"] == "exit"
    assert (second[-1]["resumed_tag"], second[-1]["last"]) == ("global_step2", 6)
    steps = [r for r in second if "step" in r]
    assert [r["step"] for r in steps] == [3, 4, 5, 6]
    assert {(r["world"], r["micro"], r["gas"]) for r in steps} == {(1, 2, 2)}
    coord = TC.FileCoordinationStore(str(tmp_path / "coord"))
    assert TC.dead_set(coord) == ["hB"] and TC.read_generation(coord) == 2
    assert verify_pod_checkpoint_dir(str(tmp_path / "ckpt" / "global_step6"))["hosts"] == ["hA"]
    eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32), config=ELASTIC,
                            device="cpu")
    want = [float(eng.train_batch(batch=b)) for b in make_batches(6, 4, seed=5, ignore=False)]
    for r in first + second:
        if "step" in r:
            np.testing.assert_allclose(r["loss"], want[r["step"] - 1], **RESIZE_TOL)


def test_all_dead_pool_returns_86_and_the_supervisor_stops(tmp_path):
    coord = tmp_path / "coord"
    store = TC.FileCoordinationStore(str(coord))
    for h in ("hA", "hB"):
        TC.record_dead(store, h, 1, "op")
    (tmp_path / "hostfile").write_text("hA slots=1\nhB slots=1\n")
    res = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher", "-H", str(tmp_path / "hostfile"),
         "--launcher", "local", "--pod_coord_dir", str(coord), "--elastic_restarts", "3",
         "--elastic_backoff", "0", "--no_python", "true"], cwd=str(ROOT), env=_child_env(),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 86, res.stderr[-4000:]
    assert TC.read_generation(store) == 1                      # one round, no relaunch
    assert "every host in the pool is marked dead" in res.stderr
