"""Elastic training (counterpart of ``deepspeed_tpu/elasticity/``; reference
``deepspeed/elasticity/``): batch-size plans that stay valid across
device-count changes, the preemption-aware agent and the launcher's
restart supervisor.  The pod half (the coordination store, its faults,
replication and the pod agent) is ROADMAP queue 1, item 13's next slice."""
from .elasticity import (DEEPSPEED_ELASTICITY_CONFIG, ElasticityConfigError,
                         ElasticityError, ElasticityIncompatibleWorldSize,
                         ElasticPlan, compute_elastic_config, elasticity_enabled,
                         ensure_immutable_elastic_config, pick_micro_batch,
                         plan_elastic_batch, valid_device_counts)
from .elastic_agent import (RC_PREEMPTED, ElasticAgent, PreemptionGuard,
                            resolve_plan_for_current_world)
from .supervisor import RC_COMPLETE, RC_INTERRUPT, Supervisor, SupervisorStandDown

__all__ = ["DEEPSPEED_ELASTICITY_CONFIG", "ElasticityError", "ElasticityConfigError",
           "ElasticityIncompatibleWorldSize", "ElasticPlan", "compute_elastic_config",
           "elasticity_enabled", "ensure_immutable_elastic_config", "pick_micro_batch",
           "plan_elastic_batch", "valid_device_counts", "RC_PREEMPTED", "ElasticAgent",
           "PreemptionGuard", "resolve_plan_for_current_world", "RC_COMPLETE",
           "RC_INTERRUPT", "Supervisor", "SupervisorStandDown"]
