"""Resilience (counterpart of ``deepspeed_tpu/resilience/``): the one-host
half of checkpoint integrity, deterministic fault injection and the hang
watchdog.

- ``fault_injection``: :class:`FaultInjector` with named sites in the
  checkpoint path (``ckpt.save``, ``ckpt.publish_latest``, ``ckpt.load``),
  the training step (``train.step``) and paged serving (``serve.tick``/
  ``admit``/``prefill``/``decode``/``replay``);
- ``integrity``: a ``manifest.json`` per tag written at save and verified
  at load; corrupt tags are quarantined (``<tag>.corrupt``);
- ``watchdog``: :class:`HangWatchdog` armed around ``train_batch``,
  async-checkpoint finalization and the serving engine's device calls.

The pod and host manifests and the supervisor's site (ROADMAP queue 1,
item 13) are not ported yet.
"""
from .fault_injection import (FaultInjector, FaultRule, InjectedFault, SITE_CKPT_LOAD,
                              SITE_CKPT_SAVE, SITE_LATEST_PUBLISH, SITE_SERVE_ADMIT,
                              SITE_SERVE_DECODE, SITE_SERVE_PREFILL, SITE_SERVE_REPLAY,
                              SITE_SERVE_TICK, SITE_TRAIN_STEP, clear_injector,
                              get_injector, install_injector, maybe_fire)
from .integrity import (CORRUPT_SUFFIX, INCOMPLETE_MARKER, LATEST_FILE,
                        MANIFEST_FILE, CheckpointIntegrityError, candidate_tags,
                        quarantine_tag, read_tag_step, verify_checkpoint_dir)
from .watchdog import RC_HANG, HangWatchdog, format_stack_report

__all__ = ["FaultInjector", "FaultRule", "InjectedFault", "SITE_CKPT_LOAD",
           "SITE_CKPT_SAVE", "SITE_LATEST_PUBLISH", "SITE_SERVE_ADMIT",
           "SITE_SERVE_DECODE", "SITE_SERVE_PREFILL", "SITE_SERVE_REPLAY",
           "SITE_SERVE_TICK", "SITE_TRAIN_STEP", "clear_injector", "get_injector",
           "install_injector", "maybe_fire", "CORRUPT_SUFFIX", "INCOMPLETE_MARKER",
           "LATEST_FILE", "MANIFEST_FILE", "CheckpointIntegrityError", "candidate_tags",
           "quarantine_tag", "read_tag_step", "verify_checkpoint_dir", "RC_HANG",
           "HangWatchdog", "format_stack_report"]
