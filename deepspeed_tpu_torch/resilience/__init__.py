"""Resilience (counterpart of ``deepspeed_tpu/resilience/``): the one-host
half of checkpoint integrity and deterministic fault injection (the
serving sites).  The pod and host manifests (ROADMAP queue 1, item 13), the
checkpoint fault sites and the hang watchdog (item 12) are not ported
yet."""
from .fault_injection import (FaultInjector, FaultRule, InjectedFault,
                              SITE_SERVE_ADMIT, SITE_SERVE_DECODE, SITE_SERVE_PREFILL,
                              SITE_SERVE_REPLAY, SITE_SERVE_TICK, clear_injector,
                              get_injector, install_injector, maybe_fire)
from .integrity import (CORRUPT_SUFFIX, INCOMPLETE_MARKER, LATEST_FILE,
                        MANIFEST_FILE, CheckpointIntegrityError, candidate_tags,
                        quarantine_tag, read_tag_step, verify_checkpoint_dir)

__all__ = ["FaultInjector", "FaultRule", "InjectedFault", "SITE_SERVE_ADMIT",
           "SITE_SERVE_DECODE", "SITE_SERVE_PREFILL", "SITE_SERVE_REPLAY",
           "SITE_SERVE_TICK", "clear_injector", "get_injector", "install_injector",
           "maybe_fire", "CORRUPT_SUFFIX", "INCOMPLETE_MARKER", "LATEST_FILE", "MANIFEST_FILE",
           "CheckpointIntegrityError", "candidate_tags", "quarantine_tag",
           "read_tag_step", "verify_checkpoint_dir"]
