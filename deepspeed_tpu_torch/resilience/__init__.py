"""Resilience (counterpart of ``deepspeed_tpu/resilience/``): the one-host
half of checkpoint integrity.  The pod and host manifests (ROADMAP queue 1,
item 13), fault injection (item 12) and the hang watchdog (item 12) are
not ported yet."""
from .integrity import (CORRUPT_SUFFIX, INCOMPLETE_MARKER, LATEST_FILE,
                        MANIFEST_FILE, CheckpointIntegrityError, candidate_tags,
                        quarantine_tag, read_tag_step, verify_checkpoint_dir)

__all__ = ["CORRUPT_SUFFIX", "INCOMPLETE_MARKER", "LATEST_FILE", "MANIFEST_FILE",
           "CheckpointIntegrityError", "candidate_tags", "quarantine_tag",
           "read_tag_step", "verify_checkpoint_dir"]
