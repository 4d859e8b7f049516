"""Pod-level fault tolerance: all-hosts checkpoint commit and shrink-to-
healthy (counterpart of ``deepspeed_tpu/elasticity/pod_agent.py``).

- :func:`save_pod_checkpoint` extends the tag's commit to pod scope: every
  host lands its files and a host manifest, the coordinator publishes
  ``pod_manifest.json`` only after *all* hosts of the generation reported,
  and only then does ``latest`` move.  A crash in between leaves a TORN pod
  tag that the restore quarantines.
- :class:`PodElasticAgent` is :class:`~.elastic_agent.ElasticAgent` with
  the pod-scope commit on save and pod-scope verification on restore; DCP
  reshards on load, so a tag written by 4 hosts restores at 2.
- :class:`PodSupervisor` drives rounds: each reads the store's dead-host
  markers, shrinks the job to the largest healthy slice the elastic plan
  admits, bumps the pod generation and hands the :class:`PodRound` to the
  caller.  A round that exits :data:`~.coordination.RC_POD_PEER_LOST` is
  the expected shrink signal.

The port launches one process per GPU, where the JAX package runs one
controller per host.  The split: the host id is the launcher's name for
the node (``DS_TPU_POD_HOST``, which every launcher path exports in pod
mode); ``LOCAL_RANK`` 0 renews the host's lease (with the step in
its attrs) and, once the DCP save's barrier says every rank's shards are
durable, writes the host manifest attesting the files of the host's
global ranks; every rank runs a scanning watchdog, so every rank of a
surviving host exits 87 on its own (``os._exit`` from the watchdog's
thread: a dead peer wedges NCCL, and no collective runs on that path).
The pod coordinator is the first host of the sorted membership; its
``LOCAL_RANK`` 0 announces each commit, waits for the host manifests,
publishes the pod manifest and ``latest``, and alone quarantines torn tags.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .coordination import (CoordinationStore, FileCoordinationStore, HeartbeatWatchdog,
                           RC_POD_PEER_LOST, bump_generation, dead_set,
                           elect_coordinator, read_generation)
from .elastic_agent import ElasticAgent, _group_world, _max_over_ranks
from .elasticity import (ElasticPlan, ElasticityIncompatibleWorldSize,
                         compute_elastic_config)
from .replication import (HostReplicator, ReplicaAdoptionError,
                          adopt_replicas, note_adoption_fallback,
                          replica_adoptions_total, replica_fallbacks_total)
from .supervisor import Supervisor, SupervisorStandDown
from ..observability.trace import trace_span
from ..resilience.fault_injection import SITE_LATEST_PUBLISH, maybe_fire
from ..resilience.integrity import (LATEST_FILE, candidate_tags, commit_pod_manifest,
                                    host_payload_files, pod_committed, quarantine_tag,
                                    verify_pod_checkpoint_dir, write_host_manifest)
from ..utils.logging import log_dist, logger

# a healthy slice below the elastic plan's floor cannot run the job at the
# planned batch — permanent until hosts come back; distinct from
# RC_POD_PEER_LOST (87, transient membership loss) and RC_HANG (85)
RC_POD_UNRECOVERABLE = 86

# the training-pod coordinator election key (the serving fleet elects under
# fleet/coordinator on the same store)
POD_COORDINATOR_KEY = "pod/coordinator"

class PodPeerLost(RuntimeError):
    """Raised in the step loop when the heartbeat watchdog declared a peer
    dead: the process must exit ``rc`` (:data:`RC_POD_PEER_LOST`) so the
    supervisor re-forms at the healthy slice."""

    rc = RC_POD_PEER_LOST

    def __init__(self, host: str):
        super().__init__(f"pod peer {host!r} declared dead by lease; "
                         f"exiting round for re-formation")
        self.host = host


def pod_host_id(env=None) -> str:
    """This process's host id: ``DS_TPU_POD_HOST``, the launcher's name for
    the node.  No fallback: a guessed id (the first host, the machine's
    name) makes several hosts act as one, and their leases lapse."""
    env = os.environ if env is None else env
    if not env.get("DS_TPU_POD_HOST"):
        raise RuntimeError("DS_TPU_POD_HOST is not set: pod mode needs the "
                           "launcher's name for this host (start the job with "
                           "the launcher's --pod_coord_dir)")
    return env["DS_TPU_POD_HOST"]


# --------------------------------------------------------- pod-scope commit

def save_pod_checkpoint(engine, save_dir: str, ctx: "PodContext",
                        tag: Optional[str] = None,
                        client_state: Optional[dict] = None) -> str:
    """One pod-scope checkpoint from this process's view; every rank of the
    job calls it (the engine's save is collective).  Peers without an
    engine (simulated hosts) pass ``engine=None`` and the tag.

    Order: the engine's save (``save_latest=False``: ``latest`` must not
    move before the POD commit) and its commit barrier; then, on the
    host's ``LOCAL_RANK`` 0 only, the host's extra files
    (``ctx.shard_writer``) and its manifest (the ``ckpt.shard_commit``
    fault unit).  The coordinator then waits for every host manifest of
    this generation, publishes ``pod_manifest.json`` and only then
    ``latest``.  ``ctx.timings`` gets this save's parts."""
    if tag is None:
        if engine is None:
            raise ValueError("peers without an engine must be given the tag")
        tag = f"global_step{engine.global_steps}"
    ckpt_dir = os.path.join(save_dir, str(tag))
    timings: Dict[str, float] = {}
    with trace_span("ckpt.pod_save", tag=str(tag), host=ctx.host_id,
                    generation=ctx.generation):
        t0 = time.perf_counter()
        if engine is not None:
            engine.save_checkpoint(save_dir, tag=tag, client_state=client_state,
                                   save_latest=False)
            wait = getattr(engine, "wait_for_checkpoint", None)
            if wait is not None:
                wait()   # the host manifest must list DURABLE files
        timings["engine_save_s"] = time.perf_counter() - t0
        os.makedirs(ckpt_dir, exist_ok=True)
        if ctx.local_rank == 0:
            if ctx.is_coordinator:
                # the pending commit, scoped by generation: host-side shard
                # writers key on THIS record, never on directory names,
                # which recur across rounds
                ctx.store.put(f"commit/gen{ctx.generation}",
                              {"tag": str(tag), "t": ctx.store.now()})
            t0 = time.perf_counter()
            shard_files: List[str] = []
            if ctx.shard_writer is not None:
                shard_files = list(ctx.shard_writer(ckpt_dir, ctx.host_id))
            owner = ranks = None
            if engine is not None:
                # the files of this host's global ranks (and, on rank 0's
                # host, the shared ones): sizes and sha256 in the manifest,
                # so verification catches a missing or torn FILE
                ranks = ctx.ranks
                owner = min(ranks)
                shard_files.extend(f for f in host_payload_files(ckpt_dir, ranks)
                                   if f not in shard_files)
            step = int(engine.global_steps) if engine is not None else -1
            write_host_manifest(ckpt_dir, ctx.host_id, ctx.generation, step,
                                files=shard_files, owner=owner, ranks=ranks)
            timings["host_manifest_s"] = time.perf_counter() - t0
            if ctx.is_coordinator:
                t0 = time.perf_counter()
                commit_pod_manifest(ckpt_dir, ctx.generation, expected_hosts=ctx.hosts,
                                    timeout_s=ctx.commit_timeout_s)
                timings["pod_commit_wait_s"] = time.perf_counter() - t0
                maybe_fire(SITE_LATEST_PUBLISH, path=save_dir, tag=str(tag))
                tmp = os.path.join(save_dir, LATEST_FILE + ".tmp")
                with open(tmp, "w") as f:
                    f.write(str(tag))
                os.replace(tmp, os.path.join(save_dir, LATEST_FILE))
                log_dist(f"pod checkpoint {tag} committed by all {len(ctx.hosts)} "
                         f"host(s) of generation {ctx.generation} -> {ckpt_dir}",
                         ranks=None)
    ctx.timings = timings
    return ckpt_dir


def pending_commit(store: CoordinationStore,
                   generation: int) -> Optional[str]:
    """The tag the coordinator most recently announced for commit under
    ``generation`` (None before the first save of the round).  Host-side
    shard writers poll this instead of scanning tag directories."""
    doc = store.get(f"commit/gen{generation}")
    return str(doc["tag"]) if doc else None


@dataclasses.dataclass
class PodContext:
    """One process's view of the pod for one generation."""
    store: CoordinationStore
    host_id: str
    hosts: List[str]                  # sorted membership of this generation
    generation: int
    lease_s: float = 5.0
    miss_limit: int = 3
    commit_timeout_s: float = 120.0
    # extra files a host contributes to a tag before its manifest lands:
    # fn(ckpt_dir, host_id) -> [relative paths] (simulated hosts)
    shard_writer: Optional[Callable[[str, str], Sequence[str]]] = None
    # in-RAM replica cadence (0 = off; elasticity/replication.py)
    replica_every_k: int = 0
    # the process within its host: LOCAL_RANK, and the host's global ranks
    local_rank: int = 0
    host_ranks: Optional[List[int]] = None
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def is_coordinator(self) -> bool:
        return bool(self.hosts) and self.host_id == self.hosts[0]

    @property
    def rank(self) -> int:
        return self.hosts.index(self.host_id)

    @property
    def ranks(self) -> List[int]:
        return list(self.host_ranks) if self.host_ranks else [0]

    @classmethod
    def from_env(cls, hosts: Optional[Sequence[str]] = None, store=None,
                 env=None, **kw) -> "PodContext":
        """The context of a rank the launcher started in pod mode: the store
        at ``DS_TPU_POD_COORD_DIR`` (wrapped by ``DS_TPU_STORE_FAULTS``),
        the generation, lease and miss limit it exported, this host's id
        and global ranks (``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``).
        ``hosts`` defaults to the launched hosts; either way the hosts the
        store marks dead are left out."""
        from .store_faults import maybe_faulty

        env = os.environ if env is None else env
        host = pod_host_id(env)
        missing = [k for k in ("RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
                   + (("DS_TPU_WORLD_INFO",) if hosts is None else ()) if not env.get(k)]
        if missing:
            raise RuntimeError(f"{', '.join(missing)} not set: the launcher gives "
                               "every rank its ranks and the launched hosts")
        if store is None:
            store = maybe_faulty(FileCoordinationStore(env["DS_TPU_POD_COORD_DIR"]),
                                 client=host)
        if hosts is None:
            from ..launcher.runner import decode_world_info

            hosts = list(decode_world_info(env["DS_TPU_WORLD_INFO"]))
        dead = set(dead_set(store))
        local = int(env["LOCAL_RANK"])
        first = int(env["RANK"]) - local
        kw.setdefault("lease_s", float(env.get("DS_TPU_POD_LEASE", 5.0)))
        kw.setdefault("miss_limit", int(env.get("DS_TPU_POD_MISS_LIMIT", 3)))
        return cls(store=store, host_id=host,
                   hosts=sorted(h for h in hosts if h not in dead),
                   generation=int(env.get("DS_TPU_POD_GENERATION", 0) or 0),
                   local_rank=local,
                   host_ranks=list(range(first, first + int(env["LOCAL_WORLD_SIZE"]))),
                   **kw)

    def watchdog(self, **kw) -> HeartbeatWatchdog:
        """This rank's heartbeat watchdog (not started): ``LOCAL_RANK`` 0
        renews the host's lease, every rank scans its peers."""
        return HeartbeatWatchdog(self.store, self.host_id, self.generation, self.hosts,
                                 lease_s=self.lease_s, miss_limit=self.miss_limit,
                                 renew=self.local_rank == 0, **kw)


class PodElasticAgent(ElasticAgent):
    """Elastic agent whose commit and restore are pod-scope.

    Saves run the all-hosts commit; the restore walk also requires
    :func:`~..resilience.integrity.verify_pod_checkpoint_dir`, so a torn pod
    tag is quarantined and the walk falls back a generation, across pod
    sizes.

    With a ``watchdog`` (:class:`~.coordination.HeartbeatWatchdog`), a
    peer declared dead raises :class:`PodPeerLost` at the next step
    boundary, before the stop step's all-reduce.  Over gloo a dead peer can
    make a collective RAISE before its lease expires: :meth:`run` then
    waits up to ``lease_s * miss_limit`` (and one scan period) for the
    scan, and raises :class:`PodPeerLost` if the peer is declared dead
    (the default watchdog exits 87 itself), else re-raises.

    **Live-state adoption**: given the previous round's membership and dead
    set (``adopt_prev_hosts`` / ``adopt_dead``), the restore first tries
    :func:`~.replication.adopt_replicas` and falls back LOUDLY to the
    checkpoint walk on a :class:`~.replication.ReplicaAdoptionError`.  A
    ``replicator`` (:class:`~.replication.HostReplicator`) seals this
    host's slab every ``ctx.replica_every_k`` steps, and synchronously when
    a preemption signal is latched.
    """

    def __init__(self, engine, ckpt_dir: str, ctx: PodContext,
                 watchdog: Optional[HeartbeatWatchdog] = None,
                 replicator: Optional["HostReplicator"] = None,
                 adopt_prev_hosts: Optional[Sequence[str]] = None,
                 adopt_dead: Optional[Sequence[str]] = None, **kw):
        super().__init__(engine, ckpt_dir, **kw)
        self.ctx = ctx
        self.watchdog = watchdog
        self.replicator = replicator
        self.adopt_prev_hosts = tuple(adopt_prev_hosts or ())
        self.adopt_dead = tuple(adopt_dead or ())
        self.adopted_step: Optional[int] = None

    def _save(self) -> None:
        save_pod_checkpoint(self.engine, self.ckpt_dir, self.ctx, tag=self.tag)
        self.timings["pod_save"] = dict(self.ctx.timings)

    def _pre_load_verify(self, tag_dir: str) -> None:
        verify_pod_checkpoint_dir(tag_dir)

    def _tag_committed(self, tag_dir: str) -> bool:
        return super()._tag_committed(tag_dir) and pod_committed(tag_dir)

    def restore_if_present(self) -> int:
        t0 = time.perf_counter()
        self._sweep_torn_pod_tags()
        self.timings["sweep_s"] = time.perf_counter() - t0
        if (self.adopt_prev_hosts and self.adopt_dead
                and self.engine is not None):
            try:
                resumed = adopt_replicas(
                    self.ctx.store, self.engine, self.adopt_prev_hosts,
                    self.adopt_dead, self.ctx.generation, self.ctx.host_id)
            except ReplicaAdoptionError as e:
                # LOUD fallback by contract: the replica layer is an
                # optimization over the durable commit, never a replacement
                note_adoption_fallback()
                logger.error(
                    "pod restore: live-state adoption failed (%s); falling "
                    "back to checkpoint restart", e)
            else:
                self.adopted_step = self.resumed_step = int(resumed)
                log_dist(
                    f"pod resume via live adoption at step {resumed} "
                    f"(generation {self.ctx.generation}; rollback 0 steps "
                    "past the last sealed replica)", ranks=[0])
                return self.resumed_step
        return super().restore_if_present()

    def _sweep_torn_pod_tags(self) -> None:
        """Quarantine every tag that never pod-committed BEFORE the walk: a
        torn tag can sit AHEAD of ``latest`` (its writer died before the
        pointer moved), where the walk never reaches it, and a later save of
        the same step would mix generations into it.  The coordinator's
        ``LOCAL_RANK`` 0 alone renames; every rank then meets it (one
        all-reduce) before listing the tags.  No pod save is in flight at
        restore time, so every uncommitted tag here is torn."""
        if (self.ctx.is_coordinator and self.ctx.local_rank == 0
                and os.path.isdir(self.ckpt_dir)):
            for tag in candidate_tags(self.ckpt_dir):
                tag_dir = os.path.join(self.ckpt_dir, tag)
                if pod_committed(tag_dir):
                    continue
                logger.error(
                    "pod restore: tag %s has no pod manifest (a host died "
                    "before its shard committed); quarantining the torn pod "
                    "checkpoint", tag_dir)
                try:
                    quarantine_tag(self.ckpt_dir, tag)
                except OSError as e:
                    logger.error("pod restore: quarantine of %s failed (%s); "
                                 "skipping", tag_dir, e)
        if _group_world() > 1:
            _max_over_ranks(0)

    def _check_peers(self) -> None:
        if self.watchdog is not None and self.watchdog.dead:
            raise PodPeerLost(self.watchdog.dead[0])

    def stop_agreed(self) -> bool:
        # never enter the stop step's all-reduce with a peer declared dead
        self._check_peers()
        return super().stop_agreed()

    def _await_scan(self) -> Optional[str]:
        """After a collective raised: the first dead peer the watchdog
        declares within ``lease_s * miss_limit`` (and one scan period), or
        None."""
        wd = self.watchdog
        if wd is None:
            return None
        deadline = time.monotonic() + wd.lease_s * wd.miss_limit + wd.renew_s
        while not wd.dead and time.monotonic() < deadline:
            time.sleep(min(0.05, wd.renew_s))
        return wd.dead[0] if wd.dead else None

    def run(self, train_step_fn: Callable, total_steps: int) -> int:
        def stepped(engine, step):
            self._check_peers()
            out = train_step_fn(engine, step)
            if self.watchdog is not None:
                # progress rides the lease so peers + supervisor can watch
                self.watchdog.set_attrs(step=step + 1)
            if self.replicator is not None:
                if self.guard.should_stop:
                    # preemption latched: a synchronous best-effort seal
                    # before the save/exit sequence
                    self.replicator.seal_now(step + 1)
                else:
                    self.replicator.maybe_replicate(step + 1)
            return out

        try:
            return super().run(stepped, total_steps)
        except PodPeerLost:
            raise
        except Exception as e:
            dead = self._await_scan()
            if dead is None:
                raise
            raise PodPeerLost(dead) from e
        finally:
            if self.replicator is not None:
                # drain the in-flight publish: the final slab must be on
                # the store before the next round plans its adoption cut
                self.replicator.stop()


# ------------------------------------------------------- shrink-to-healthy

def shrink_to_healthy(elastic_config, healthy_hosts: Sequence[str],
                      chips_per_host: int = 1,
                      model_parallel_size: int = 1
                      ) -> Tuple[List[str], ElasticPlan]:
    """The largest slice the elastic plan admits within the healthy hosts.

    Device counts come from the same :func:`compute_elastic_config` plan
    the runtime binds to, so the shrunken job trains the SAME global batch
    with a re-derived (micro, gradient-accumulation) pair.  Raises
    :class:`ElasticityIncompatibleWorldSize` when even the smallest valid
    count needs more hosts than are healthy.
    """
    healthy = sorted(healthy_hosts)
    plan0 = compute_elastic_config(elastic_config, 0, chips_per_host,
                                   model_parallel_size)
    avail_devices = len(healthy) * chips_per_host
    fits = [c for c in plan0.valid_device_counts if c <= avail_devices]
    if not fits:
        raise ElasticityIncompatibleWorldSize(
            f"{len(healthy)} healthy host(s) x {chips_per_host} chip(s) = "
            f"{avail_devices} devices cannot run any elastic-compatible "
            f"count {list(plan0.valid_device_counts)}")
    best = max(fits)
    n_hosts = -(-best // chips_per_host)   # ceil
    plan = compute_elastic_config(elastic_config, best, chips_per_host,
                                  model_parallel_size)
    return healthy[:n_hosts], plan


@dataclasses.dataclass(frozen=True)
class PodRound:
    """What one supervisor round hands the attempt: the generation it must
    heartbeat/rendezvous/commit under, the member hosts (coordinator
    first), the batch triad the shrunken world trains with, plus — for the
    live-adoption path — the PREVIOUS round's membership and the dead set
    this round shrank away from (both empty on the first round)."""
    generation: int
    hosts: Tuple[str, ...]
    plan: ElasticPlan
    prev_hosts: Tuple[str, ...] = ()
    dead: Tuple[str, ...] = ()

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)


class PodSupervisor(Supervisor):
    """Round-based pod re-formation on top of the hardened Supervisor.

    ``attempt(round: PodRound) -> int`` runs one full training round at the
    round's membership (launch/fan-out, rendezvous, heartbeats, pod
    checkpoints) and returns the job's exit code.  Before every round the
    supervisor re-reads the coordination store's dead-host markers (written
    by whichever peer's :class:`~.coordination.HeartbeatWatchdog` detected
    the miss), re-plans via :func:`shrink_to_healthy`, and bumps the pod
    generation — so a round after a host loss automatically re-forms at
    the largest healthy slice with the plan's batch triad, and a stale
    host from the previous incarnation can never rendezvous into it
    (records are generation-keyed).

    **Standby takeover** (``supervisor_id=``): the round loop runs under
    :func:`~.coordination.elect_coordinator` on ``pod/coordinator`` — the
    SAME lease protocol the serving-fleet router uses, with the same
    exactly-one-winner CAS proof under racing standbys.  A supervisor that
    does not hold the lease stands by (polls, runs nothing); when the
    leader's lease lapses, exactly one standby takes the next term, adopts
    the CURRENT pod generation and dead-host set from the store (both
    already live there — :func:`bump_generation` continues the monotonic
    counter, :meth:`healthy_hosts` re-reads the markers), and continues
    rounds where the dead leader stopped.  Long rounds must renew via
    :meth:`renew_coordinator` from the step loop (the runbook in
    docs/POD.md); a renewal returning False means a standby deposed us —
    stop leading.  ``supervisor_id=None`` (default) keeps one
    supervisor: no election, rounds run unconditionally.

    Exit semantics: :data:`RC_POD_PEER_LOST` is an ordinary failed round
    (the designed shrink path — backoff, budget, progress accounting all
    apply); an unshrinkable pod returns :data:`RC_POD_UNRECOVERABLE`,
    which is terminal; a standby that never wins within
    ``standby_max_wait_s`` stands down cleanly (no budget burned).
    """

    def __init__(self, store: CoordinationStore, elastic_config,
                 attempt: Callable[[PodRound], int], hosts: Sequence[str],
                 chips_per_host: int = 1, model_parallel_size: int = 1,
                 monitor=None, supervisor_id: Optional[str] = None,
                 election_key: str = POD_COORDINATOR_KEY,
                 coordinator_lease_s: float = 5.0,
                 standby_poll_s: float = 0.05,
                 standby_max_wait_s: Optional[float] = None,
                 **supervisor_kw):
        self.store = store
        self.elastic_config = elastic_config
        self.pod_attempt = attempt
        self.all_hosts = sorted(hosts)
        self.chips_per_host = int(chips_per_host)
        self.model_parallel_size = int(model_parallel_size)
        self.rounds: List[PodRound] = []
        self.supervisor_id = (str(supervisor_id)
                              if supervisor_id is not None else None)
        self.election_key = election_key
        self.coordinator_lease_s = float(coordinator_lease_s)
        self.standby_poll_s = float(standby_poll_s)
        self.standby_max_wait_s = (float(standby_max_wait_s)
                                   if standby_max_wait_s is not None
                                   else None)
        self.is_coordinator = self.supervisor_id is None
        self.term = 0
        self.elections_total = 0
        supervisor_kw.setdefault("terminal_rcs", (RC_POD_UNRECOVERABLE,))
        super().__init__(self._pod_round, monitor=monitor, **supervisor_kw)

    def healthy_hosts(self) -> List[str]:
        dead = set(dead_set(self.store))
        return [h for h in self.all_hosts if h not in dead]

    # ------------------------------------------------------------- election

    def renew_coordinator(self) -> bool:
        """Renew (or re-confirm) this supervisor's coordinator lease.
        Long training rounds call this from their step loop so the lease
        never lapses under a healthy leader; ``False`` means a standby
        deposed us — the caller must stop running the round (the deposer
        adopted the store state and runs it again).  Always ``True`` when
        elections are disabled (``supervisor_id=None``)."""
        if self.supervisor_id is None:
            return True
        lease = elect_coordinator(self.store, self.supervisor_id,
                                  self.coordinator_lease_s,
                                  key=self.election_key)
        self.is_coordinator = lease is not None
        if lease is not None:
            self.term = lease.term
        return lease is not None

    def _await_leadership(self) -> None:
        """Block until this supervisor holds the coordinator lease: the
        standby loop.  Exactly one of N racing candidates wins each term
        (the election CAS); a winner that TAKES OVER a lapsed term adopts
        the store's current pod generation and dead-host set — both are
        re-read from the store every round anyway, so adoption is just
        logging what the next round will naturally see."""
        if self.supervisor_id is None:
            return
        deadline = (time.monotonic() + self.standby_max_wait_s
                    if self.standby_max_wait_s is not None else None)
        while True:
            lease = elect_coordinator(self.store, self.supervisor_id,
                                      self.coordinator_lease_s,
                                      key=self.election_key)
            if lease is not None:
                if lease.term != self.term or not self.is_coordinator:
                    self.elections_total += 1
                    gen = read_generation(self.store)
                    dead = dead_set(self.store)
                    with trace_span("pod.election",
                                    supervisor=self.supervisor_id,
                                    term=lease.term):
                        log_dist(
                            f"pod supervisor {self.supervisor_id!r} leads "
                            f"term {lease.term} (adopting pod generation "
                            f"{gen}, {len(dead)} dead-host marker(s))",
                            ranks=[0])
                self.is_coordinator = True
                self.term = lease.term
                return
            self.is_coordinator = False
            if deadline is not None and time.monotonic() >= deadline:
                raise SupervisorStandDown(
                    f"pod supervisor {self.supervisor_id!r} stood by "
                    f"{self.standby_max_wait_s:.1f}s without the leader's "
                    "lease lapsing — the pod has a healthy leader")
            time.sleep(self.standby_poll_s)

    def _pod_round(self, _restarts: int) -> int:
        self._await_leadership()
        healthy = self.healthy_hosts()
        try:
            members, plan = shrink_to_healthy(
                self.elastic_config, healthy, self.chips_per_host,
                self.model_parallel_size)
        except ElasticityIncompatibleWorldSize as e:
            self.diagnosis = (
                f"pod unrecoverable: {e} — waiting for replacement hosts "
                "will not help this supervisor; clear the dead-host markers "
                "once capacity returns and relaunch")
            logger.error("pod supervisor: %s", self.diagnosis)
            return RC_POD_UNRECOVERABLE
        gen = bump_generation(self.store)
        prev = tuple(self.rounds[-1].hosts) if self.rounds else ()
        dead_now = tuple(sorted(set(self.all_hosts) - set(healthy)))
        rnd = PodRound(generation=gen, hosts=tuple(members), plan=plan,
                       prev_hosts=prev, dead=dead_now)
        self.rounds.append(rnd)
        if len(members) < len(self.all_hosts):
            logger.warning(
                "pod supervisor: generation %d re-forms at %d/%d host(s) "
                "(dead: %s) with batch triad %s", gen, len(members),
                len(self.all_hosts),
                sorted(set(self.all_hosts) - set(members)), plan.as_triad())
        if self.monitor is not None:
            self.monitor.write_events([
                ("pod/generation", float(gen), gen),
                ("pod/round_hosts", float(len(members)), gen),
                ("pod/dead_hosts",
                 float(len(self.all_hosts) - len(healthy)), gen),
                ("pod/coordinator_term", float(self.term), gen),
                ("pod/replica_adoptions_total",
                 float(replica_adoptions_total()), gen),
                ("pod/replica_fallbacks_total",
                 float(replica_fallbacks_total()), gen)])
        with trace_span("pod.round", generation=gen, hosts=len(members)):
            return self.pod_attempt(rnd)
