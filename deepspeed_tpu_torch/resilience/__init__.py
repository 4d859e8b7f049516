"""Resilience (counterpart of ``deepspeed_tpu/resilience/``): the one-host
half of checkpoint integrity, deterministic fault injection and the hang
watchdog.

- ``fault_injection``: :class:`FaultInjector` with named sites in the
  checkpoint path (``ckpt.save``, ``ckpt.publish_latest``, ``ckpt.load``),
  the training step (``train.step``), the elastic supervisor's rounds
  (``supervisor.attempt``) and paged serving (``serve.tick``/``admit``/
  ``prefill``/``decode``/``replay``);
- ``integrity``: a ``manifest.json`` per tag written at save and verified
  at load; corrupt tags are quarantined (``<tag>.corrupt``);
- ``watchdog``: :class:`HangWatchdog` armed around ``train_batch``,
  async-checkpoint finalization and the serving engine's device calls;
- ``integrity``'s pod scope: host manifests, the coordinator's
  ``pod_manifest.json`` (:func:`commit_pod_manifest`) and its verification;
- :func:`checkpoint_progress_fn` and, in pod mode,
  :func:`pod_checkpoint_progress_fn`: the supervisor's progress signal.
"""
from .fault_injection import (FaultInjector, FaultRule, InjectedFault, SITE_CKPT_LOAD,
                              SITE_CKPT_SAVE, SITE_LATEST_PUBLISH, SITE_SERVE_ADMIT,
                              SITE_SERVE_DECODE, SITE_SERVE_PREFILL, SITE_SERVE_REPLAY,
                              SITE_SERVE_TICK, SITE_SUPERVISOR_ATTEMPT, SITE_TRAIN_STEP,
                              clear_injector,
                              get_injector, install_injector, maybe_fire)
from .integrity import (CORRUPT_SUFFIX, HOST_MANIFEST_DIR, INCOMPLETE_MARKER, LATEST_FILE,
                        MANIFEST_FILE, POD_MANIFEST_FILE, CheckpointIntegrityError,
                        PodCommitTimeout, candidate_tags, commit_pod_manifest,
                        host_payload_files, pod_checkpoint_progress_fn, pod_committed,
                        quarantine_tag, read_host_manifests, read_pod_manifest,
                        read_tag_step, verify_checkpoint_dir, verify_pod_checkpoint_dir,
                        write_host_manifest)
from .watchdog import RC_HANG, HangWatchdog, format_stack_report

__all__ = ["FaultInjector", "FaultRule", "InjectedFault", "SITE_CKPT_LOAD",
           "SITE_CKPT_SAVE", "SITE_LATEST_PUBLISH", "SITE_SERVE_ADMIT",
           "SITE_SERVE_DECODE", "SITE_SERVE_PREFILL", "SITE_SERVE_REPLAY",
           "SITE_SERVE_TICK", "SITE_SUPERVISOR_ATTEMPT", "SITE_TRAIN_STEP", "clear_injector", "get_injector",
           "install_injector", "maybe_fire", "CORRUPT_SUFFIX", "INCOMPLETE_MARKER",
           "LATEST_FILE", "MANIFEST_FILE", "CheckpointIntegrityError", "candidate_tags",
           "quarantine_tag", "read_tag_step", "verify_checkpoint_dir", "RC_HANG",
           "HangWatchdog", "format_stack_report", "checkpoint_progress_fn",
           "HOST_MANIFEST_DIR", "POD_MANIFEST_FILE", "PodCommitTimeout", "commit_pod_manifest",
           "host_payload_files", "pod_checkpoint_progress_fn", "pod_committed",
           "read_host_manifests", "read_pod_manifest", "verify_pod_checkpoint_dir",
           "write_host_manifest"]


def checkpoint_progress_fn(ckpt_dir: str):
    """Progress signal for the supervisor's restart budget: the newest
    committed global step under ``ckpt_dir`` (-1 while nothing is
    committed).  A restart that advanced this number made real progress and
    refreshes the budget; K restarts that did not trip the breaker."""
    import os

    def progress() -> int:
        if not os.path.isdir(ckpt_dir):
            return -1
        best = -1
        for tag in candidate_tags(ckpt_dir):
            tag_dir = os.path.join(ckpt_dir, tag)
            # only manifest-bearing (committed) tags count, the same filter as
            # ElasticAgent._prune_generations: a torn save's step would
            # surface through client_state.json, and counting it would
            # refresh the budget off a tag the restore rejects
            if not os.path.exists(os.path.join(tag_dir, MANIFEST_FILE)):
                continue
            best = max(best, read_tag_step(tag_dir))
        return best

    return progress
