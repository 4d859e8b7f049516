"""Checkpoint integrity: a per-tag manifest written at save, verified at load
(counterpart of ``deepspeed_tpu/resilience/integrity.py``, its one-host
half).

A committed tag directory looks like::

    <tag>/
      state/                # torch.distributed.checkpoint files
      client_state.json     # engine counters + user client_state
      ds_config.json        # config snapshot
      manifest.json         # written LAST (before `latest` is published)

``manifest.json`` records the saved state's keys (shape, dtype), the
sha256 and size of the two JSON sidecars and of every payload file, and
the writers' world size.  It is written (by rank 0 of a data-parallel
job, after every rank's shards are durable) after every other file and
before the ``latest`` pointer, so its presence marks the commit.  A save drops
``.incomplete`` first and removes it with the manifest: a tag that still
holds it is a torn save and is refused, while a tag with neither (a legacy,
pre-manifest save) loads with a warning.  The JAX package lists its
payload by size only; here every payload file is checksummed too, so one
flipped byte fails verification.

Verification failures raise :class:`CheckpointIntegrityError`; a caller
quarantines the tag (rename to ``<tag>.corrupt``) and falls back one
generation (:func:`candidate_tags`).  The pod-scope manifests are not
ported yet (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from ..utils.logging import logger

MANIFEST_FILE = "manifest.json"
MANIFEST_VERSION = 1
CORRUPT_SUFFIX = ".corrupt"
# the newest-committed-tag pointer
LATEST_FILE = "latest"
# dropped at the start of a save, removed when the manifest lands: its
# presence tells a TORN save from a LEGACY pre-manifest tag
INCOMPLETE_MARKER = ".incomplete"
# small sidecars checksummed on every save/load
_CHECKSUMMED = ("client_state.json", "ds_config.json")
# payload subtrees (checksummed file by file)
_PAYLOAD_DIRS = ("state",)
_HASH_THREADS = 8


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint tag failed verification (torn write, corruption, or a
    manifest/content mismatch)."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _payload_files(ckpt_dir: str) -> List[str]:
    """Relative paths of the payload files, sorted."""
    out = []
    for sub in _PAYLOAD_DIRS:
        for root, _dirs, files in os.walk(os.path.join(ckpt_dir, sub)):
            out += [os.path.relpath(os.path.join(root, name), ckpt_dir)
                    for name in files]
    return sorted(out)


def _describe(ckpt_dir: str, names: List[str]) -> Dict[str, Dict]:
    """name -> {sha256, size}, the files hashed in parallel (hashlib lets
    go of the GIL on large reads)."""
    paths = [os.path.join(ckpt_dir, n) for n in names]
    with ThreadPoolExecutor(max_workers=_HASH_THREADS) as pool:
        digests = list(pool.map(_sha256, paths))
    return {n: {"sha256": d, "size": os.path.getsize(p)}
            for n, p, d in zip(names, paths, digests)}


def mark_incomplete(ckpt_dir: str) -> None:
    """Drop the torn-save marker; :func:`write_manifest` removes it once the
    tag commits.  Call before writing any other file of the tag."""
    with open(os.path.join(ckpt_dir, INCOMPLETE_MARKER), "w") as f:
        f.write("save in progress; a crash before manifest.json removes "
                "this tag from the restore path\n")


def build_manifest(tag: str, global_steps: int, tree: Dict[str, Dict],
                   world_size: int = 1) -> Dict:
    """The save-time half: the tag, its step, the saved keys (``tree``:
    key -> {shape, dtype}, global shapes) and the writers' world size;
    checksums are added by :func:`write_manifest` once every rank's payload
    is durable."""
    return {"manifest_version": MANIFEST_VERSION, "tag": str(tag),
            "global_steps": int(global_steps), "writer_world_size": int(world_size),
            "tree": tree}


def _atomic_write_json(path: str, obj) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def write_manifest(ckpt_dir: str, manifest: Dict) -> str:
    """Checksum the sidecars and the payload, write ``manifest.json`` and
    remove the torn-save marker.  Must run after every other file of the tag
    is durable and before ``latest`` moves: the manifest IS the commit."""
    manifest = dict(manifest)
    manifest["files"] = _describe(ckpt_dir, [
        n for n in _CHECKSUMMED if os.path.exists(os.path.join(ckpt_dir, n))])
    manifest["payload"] = _describe(ckpt_dir, _payload_files(ckpt_dir))
    path = _atomic_write_json(os.path.join(ckpt_dir, MANIFEST_FILE), manifest)
    marker = os.path.join(ckpt_dir, INCOMPLETE_MARKER)
    if os.path.exists(marker):
        os.remove(marker)
    return path


def read_manifest(ckpt_dir: str) -> Optional[Dict]:
    path = os.path.join(ckpt_dir, MANIFEST_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        # ValueError covers JSONDecodeError and UnicodeDecodeError: a
        # bit-flipped manifest is often not even valid UTF-8
        raise CheckpointIntegrityError(f"unreadable manifest {path}: {e}") from e


def verify_checkpoint_dir(ckpt_dir: str) -> Optional[Dict]:
    """Verify a tag directory against its manifest.

    Returns the manifest (``None`` for a legacy pre-manifest tag, accepted
    with a warning).  Raises :class:`CheckpointIntegrityError` on a torn
    save, a missing or resized file, a checksum mismatch, a payload file the
    manifest does not list, or an unreadable manifest."""
    if not os.path.isdir(ckpt_dir):
        raise CheckpointIntegrityError(f"checkpoint dir missing: {ckpt_dir}")
    if os.path.exists(os.path.join(ckpt_dir, INCOMPLETE_MARKER)):
        raise CheckpointIntegrityError(
            f"checkpoint {ckpt_dir} is a torn save ({INCOMPLETE_MARKER} "
            "present: the writer died before committing the manifest)")
    manifest = read_manifest(ckpt_dir)
    if manifest is None:
        logger.warning("checkpoint %s has no manifest (pre-manifest save); "
                       "loading unverified", ckpt_dir)
        return None
    listed = {**manifest.get("files", {}), **manifest.get("payload", {})}
    problems: List[str] = []
    present = [n for n in listed if os.path.exists(os.path.join(ckpt_dir, n))]
    problems += [f"{n}: missing" for n in listed if n not in present]
    problems += [f"{n}: not in the manifest" for n in _payload_files(ckpt_dir)
                 if n not in listed]
    sized = [n for n in present
             if os.path.getsize(os.path.join(ckpt_dir, n)) == listed[n]["size"]]
    problems += [f"{n}: size {os.path.getsize(os.path.join(ckpt_dir, n))} != "
                 f"{listed[n]['size']}" for n in present if n not in sized]
    got = _describe(ckpt_dir, sized)
    problems += [f"{n}: checksum mismatch" for n in sized
                 if got[n]["sha256"] != listed[n]["sha256"]]
    if problems:
        raise CheckpointIntegrityError(
            f"checkpoint {ckpt_dir} failed verification: "
            + "; ".join(problems[:8])
            + (f" (+{len(problems) - 8} more)" if len(problems) > 8 else ""))
    return manifest


def read_tag_step(ckpt_dir: str) -> int:
    """Best-effort global step of a tag (manifest first, then the sidecar);
    -1 when unreadable, which sorts such tags last."""
    try:
        m = read_manifest(ckpt_dir)
        if m is not None:
            return int(m.get("global_steps", -1))
    except CheckpointIntegrityError:
        return -1
    try:
        with open(os.path.join(ckpt_dir, "client_state.json")) as f:
            return int(json.load(f).get("global_steps", -1))
    except (OSError, ValueError):
        return -1


def read_latest(save_dir: str) -> Optional[str]:
    """The tag ``save_dir/latest`` names, or None."""
    path = os.path.join(save_dir, LATEST_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().strip()


def candidate_tags(save_dir: str) -> List[str]:
    """Restore candidates newest to oldest: the ``latest`` pointer's tag
    first, then every other non-quarantined tag by descending step."""
    if not os.path.isdir(save_dir):
        return []
    tags = [d for d in os.listdir(save_dir)
            if os.path.isdir(os.path.join(save_dir, d)) and CORRUPT_SUFFIX not in d]
    tags.sort(key=lambda t: (read_tag_step(os.path.join(save_dir, t)), t),
              reverse=True)
    latest = read_latest(save_dir)
    if latest in tags:
        tags.remove(latest)
        tags.insert(0, latest)
    return tags


def quarantine_tag(save_dir: str, tag: str) -> str:
    """Rename a failed tag to ``<tag>.corrupt`` (numbered on collision) so
    the fallback walk never reads it again; drop a ``latest`` naming it."""
    src = os.path.join(save_dir, tag)
    dst = src + CORRUPT_SUFFIX
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{src}{CORRUPT_SUFFIX}.{n}"
    os.replace(src, dst)
    if read_latest(save_dir) == str(tag):
        os.remove(os.path.join(save_dir, LATEST_FILE))
    logger.error("quarantined corrupt checkpoint %s -> %s", src, dst)
    return dst
