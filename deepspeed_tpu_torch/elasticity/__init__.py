"""Elastic training (counterpart of ``deepspeed_tpu/elasticity/``; reference
``deepspeed/elasticity/``): batch-size plans that stay valid across
device-count changes, the preemption-aware agent and the launcher's
restart supervisor; the pod half: the coordination store
(``coordination``), its fault proxy (``store_faults``), buddy replicas
(``replication``) and the pod agent and supervisor (``pod_agent``)."""
from .elasticity import (DEEPSPEED_ELASTICITY_CONFIG, ElasticityConfigError,
                         ElasticityError, ElasticityIncompatibleWorldSize,
                         ElasticPlan, compute_elastic_config, elasticity_enabled,
                         ensure_immutable_elastic_config, pick_micro_batch,
                         plan_elastic_batch, valid_device_counts)
from .elastic_agent import (RC_PREEMPTED, ElasticAgent, PreemptionGuard,
                            resolve_plan_for_current_world)
from .supervisor import RC_COMPLETE, RC_INTERRUPT, Supervisor, SupervisorStandDown

from .coordination import (POD_HOSTS_PREFIX, RC_POD_PEER_LOST, CoordinationStore,
                           CoordinatorLease, FileCoordinationStore, HeartbeatWatchdog,
                           HostLease, PodCoordinationError, PodRendezvousTimeout,
                           StoreRetryPolicy, StoreUnavailable, advertise_host, beat,
                           bump_generation, channel_append, channel_consume, channel_stats,
                           clear_dead, dead_hosts, dead_set, dedup_drop_totals,
                           default_retry_policy, elect_coordinator, host_advertisements,
                           lease_table, process_src, publish_residency, read_coordinator,
                           read_generation, read_residency, record_dead, rendezvous,
                           resign_coordinator, rollup_host_gauges, store_retries_total)
from .store_faults import (STORE_FAULTS_ENV, FaultyStore, InjectedStoreFault,
                           InjectedStoreTimeout, StoreFaultRule, maybe_faulty,
                           rules_from_env)
from .replication import (POD_ADOPT_PREFIX, POD_REPLICA_PREFIX, POD_REPLICA_ROUND_PREFIX,
                          REPLICA_KEEP, REPLICA_MAX_BYTES, HostReplicator,
                          ReplicaAdoptionError, ReplicaIntegrityError, adopt_replicas,
                          announce_replica_round, buddy_ring, claim_adoption,
                          note_adoption_fallback, pending_replica_round, plan_adoption,
                          publish_replica, read_replica, replica_adoptions_total,
                          replica_fallbacks_total, seal_entry, verify_entry)
from .pod_agent import (POD_COORDINATOR_KEY, RC_POD_UNRECOVERABLE, PodContext,
                        PodElasticAgent, PodPeerLost, PodRound, PodSupervisor,
                        pending_commit, pod_host_id, save_pod_checkpoint,
                        shrink_to_healthy)

__all__ = ["DEEPSPEED_ELASTICITY_CONFIG", "ElasticityError", "ElasticityConfigError",
           "ElasticityIncompatibleWorldSize", "ElasticPlan", "compute_elastic_config",
           "elasticity_enabled", "ensure_immutable_elastic_config", "pick_micro_batch",
           "plan_elastic_batch", "valid_device_counts", "RC_PREEMPTED", "ElasticAgent",
           "PreemptionGuard", "resolve_plan_for_current_world", "RC_COMPLETE",
           "RC_INTERRUPT", "Supervisor", "SupervisorStandDown",
           "POD_HOSTS_PREFIX", "RC_POD_PEER_LOST", "CoordinationStore", "CoordinatorLease",
           "FileCoordinationStore", "HeartbeatWatchdog", "HostLease", "PodCoordinationError",
           "PodRendezvousTimeout", "StoreRetryPolicy", "StoreUnavailable", "advertise_host",
           "beat", "bump_generation", "channel_append", "channel_consume", "channel_stats",
           "clear_dead", "dead_hosts", "dead_set", "dedup_drop_totals", "default_retry_policy",
           "elect_coordinator", "host_advertisements", "lease_table", "process_src",
           "publish_residency", "read_coordinator", "read_generation", "read_residency",
           "record_dead", "rendezvous", "resign_coordinator", "rollup_host_gauges",
           "store_retries_total", "STORE_FAULTS_ENV", "FaultyStore", "InjectedStoreFault",
           "InjectedStoreTimeout", "StoreFaultRule", "maybe_faulty", "rules_from_env",
           "POD_ADOPT_PREFIX", "POD_REPLICA_PREFIX", "POD_REPLICA_ROUND_PREFIX", "REPLICA_KEEP",
           "REPLICA_MAX_BYTES", "HostReplicator", "ReplicaAdoptionError",
           "ReplicaIntegrityError", "adopt_replicas", "announce_replica_round", "buddy_ring",
           "claim_adoption", "note_adoption_fallback", "pending_replica_round",
           "plan_adoption", "publish_replica", "read_replica", "replica_adoptions_total",
           "replica_fallbacks_total", "seal_entry", "verify_entry", "POD_COORDINATOR_KEY",
           "RC_POD_UNRECOVERABLE", "PodContext", "PodElasticAgent", "PodPeerLost", "PodRound",
           "PodSupervisor", "pending_commit", "pod_host_id", "save_pod_checkpoint",
           "shrink_to_healthy"]
