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
generation (:func:`candidate_tags`).

The pod scope (:func:`write_host_manifest` ... :func:`pod_checkpoint_progress_fn`)
adds ``host_manifests/host<id>.json`` (the files one host attests, with
sizes and checksums) and ``pod_manifest.json`` (published by the pod
coordinator once every host of the generation reported): a tag without
the pod manifest is a torn pod checkpoint.  A host attests the DCP files
of its own global ranks (``state/__<rank>_<n>.distcp``, the per-rank
``rank<r>`` side files); the host of global rank 0 also attests
``state/.metadata``, the JSON sidecars and every file no rank claims, so
the union over the hosts covers the whole listing.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Union

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
# the pod scope: the coordinator's commit marker and the per-host manifests
POD_MANIFEST_FILE = "pod_manifest.json"
HOST_MANIFEST_DIR = "host_manifests"
# what a host attests: the payload, the per-rank side files (offload
# files, the 1-bit state) and the sidecars
_POD_DIRS = ("state", "offload_optimizer", "comm_state")
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


# ------------------------------------------------------- pod-scope commit
#
# A POD checkpoint is committed only when every host of the writing
# generation has durably landed its files: host k writes
# host_manifests/host<k>.json (its files with sizes + sha256); the
# coordinator waits for every expected host manifest and only then
# publishes pod_manifest.json (atomic).  A tag without it is TORN and is
# never restored from: the pod agent quarantines it.

# the rank that wrote a file: DCP's `__<rank>_<n>.distcp`, or a `rank<r>`
# component (the offload files' and the 1-bit state's per-rank paths)
_DCP_RANK = re.compile(r"^__(\d+)_\d+\.distcp$")
_RANK_COMPONENT = re.compile(r"^rank(\d+)(?:\.\w+)?$")


def _atomic_write_doc(path: str, doc: Dict) -> str:
    """The JAX package's atomic JSON commit, byte for byte (its store and
    pod manifests are read by both packages): dump to a tmp sibling named
    with pid and thread id (concurrent writers never share it), then
    ``os.replace`` into place."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
    os.replace(tmp, path)
    return path


def _pod_listing(ckpt_dir: str) -> List[str]:
    out = [n for n in _CHECKSUMMED if os.path.exists(os.path.join(ckpt_dir, n))]
    for sub in _POD_DIRS:
        for root, _dirs, files in os.walk(os.path.join(ckpt_dir, sub)):
            out += [os.path.relpath(os.path.join(root, name), ckpt_dir)
                    for name in files]
    return sorted(out)


def _path_rank_owner(rel: str) -> Optional[int]:
    """The global rank a checkpoint path names, or None for a shared file
    (``.metadata``, the sidecars): the ONE spelling of the attribution,
    shared by partitioning and verification."""
    for comp in rel.replace(os.sep, "/").split("/"):
        m = _DCP_RANK.match(comp) or _RANK_COMPONENT.match(comp)
        if m is not None:
            return int(m.group(1))
    return None


def host_payload_files(ckpt_dir: str, ranks: Union[int, Iterable[int]] = 0) -> List[str]:
    """The files of a tag one host attests: those its global ``ranks``
    wrote, and, on the host of rank 0, every file no rank claims.  The
    union over the hosts is the whole listing, so a file lost in transit
    fails the pod commit and its verification."""
    ranks = {int(ranks)} if isinstance(ranks, int) else {int(r) for r in ranks}
    mine = []
    for rel in _pod_listing(ckpt_dir):
        owner = _path_rank_owner(rel)
        if owner in ranks or (owner is None and 0 in ranks):
            mine.append(rel)
    return mine


def write_host_manifest(ckpt_dir: str, host_id: str, generation: int,
                        global_steps: int, files: Optional[List[str]] = None,
                        owner: Optional[int] = None,
                        ranks: Optional[List[int]] = None) -> str:
    """Land one host's manifest: relative ``files`` (already durable) with
    size + sha256.  Fires ``ckpt.shard_commit`` first, the commit unit
    fault tests kill to produce torn pod tags.  ``owner`` stamps the
    global rank whose files it attests; a host of several ranks stamps its
    lowest and lists all of them in ``ranks``.  Commit and verification
    cross-check each file's path-derived rank against the stamp."""
    from .fault_injection import SITE_SHARD_COMMIT, maybe_fire

    maybe_fire(SITE_SHARD_COMMIT, path=ckpt_dir, host=host_id, generation=generation)
    names = list(files or [])
    listing = {rel: {"size": meta["size"], "sha256": meta["sha256"]}
               for rel, meta in _describe(ckpt_dir, names).items()}
    doc = {"host_id": str(host_id), "generation": int(generation),
           "global_steps": int(global_steps), "files": {n: listing[n] for n in names}}
    if owner is not None:
        doc["owner"] = int(owner)
    if ranks is not None and len(ranks) > 1:
        doc["ranks"] = sorted(int(r) for r in ranks)
    mdir = os.path.join(ckpt_dir, HOST_MANIFEST_DIR)
    os.makedirs(mdir, exist_ok=True)
    return _atomic_write_doc(os.path.join(mdir, f"host{host_id}.json"), doc)


def _owner_attribution_problems(host: str, manifest: Dict) -> List[str]:
    """A file whose path names a rank outside the manifest's stamp (``owner``,
    or ``ranks`` for a host of several) is a misattributed shard; manifests
    without a stamp (simulated hosts' shard files) skip the check."""
    owner = manifest.get("owner")
    if owner is None:
        return []
    allowed = set(manifest.get("ranks") or [int(owner)])
    problems = []
    for rel in manifest.get("files", {}):
        claimed = _path_rank_owner(rel)
        if claimed is not None and claimed not in allowed:
            problems.append(
                f"host{host}:{rel}: path names rank {claimed} but the manifest "
                f"is stamped owner={int(owner)} — silent shard misattribution")
    return problems


def read_host_manifests(ckpt_dir: str, strict: bool = True) -> Dict[str, Dict]:
    """host_id -> host manifest under the tag.  ``strict=False`` (the
    commit's poll) treats an unreadable one as not yet present; at
    verification unreadable means corrupt and raises."""
    mdir = os.path.join(ckpt_dir, HOST_MANIFEST_DIR)
    out: Dict[str, Dict] = {}
    if not os.path.isdir(mdir):
        return out
    for name in sorted(os.listdir(mdir)):
        if not name.endswith(".json") or ".tmp." in name:
            continue
        try:
            with open(os.path.join(mdir, name)) as f:
                doc = json.load(f)
            out[str(doc["host_id"])] = doc
        except (OSError, ValueError, KeyError) as e:
            if strict:
                raise CheckpointIntegrityError(
                    f"unreadable host manifest {os.path.join(mdir, name)}: {e}") from e
            logger.warning("pod commit: host manifest %s unreadable (%s); "
                           "treating as not yet present", name, e)
    return out


class PodCommitTimeout(RuntimeError):
    """Not every expected host reported its manifest in time: the tag stays
    uncommitted (torn).  Not a :class:`CheckpointIntegrityError`: nothing
    on disk is corrupt, a writer is missing."""

    def __init__(self, msg: str, missing: List[str]):
        super().__init__(msg)
        self.missing = missing


def _file_problems(ckpt_dir: str, host: str, manifest: Dict) -> List[str]:
    problems = _owner_attribution_problems(host, manifest)
    files = manifest.get("files", {})
    present = [r for r in files if os.path.exists(os.path.join(ckpt_dir, r))]
    problems += [f"host{host}:{r}: missing" for r in files if r not in present]
    sized = [r for r in present
             if os.path.getsize(os.path.join(ckpt_dir, r)) == files[r]["size"]]
    problems += [f"host{host}:{r}: size {os.path.getsize(os.path.join(ckpt_dir, r))} "
                 f"!= {files[r]['size']}" for r in present if r not in sized]
    got = _describe(ckpt_dir, sized)
    problems += [f"host{host}:{r}: checksum mismatch" for r in sized
                 if got[r]["sha256"] != files[r]["sha256"]]
    return problems


def commit_pod_manifest(ckpt_dir: str, generation: int, expected_hosts: List[str],
                        timeout_s: float = 120.0, poll_s: float = 0.25) -> str:
    """The coordinator's half of the pod commit: wait until every expected
    host's manifest of THIS generation is present and its files verify,
    then publish ``pod_manifest.json``.  Raises :class:`PodCommitTimeout`
    when a host never reports (the tag stays torn).  Call before
    ``latest`` moves."""
    expected = sorted(set(str(h) for h in expected_hosts))
    deadline = time.monotonic() + timeout_s
    while True:
        manifests = read_host_manifests(ckpt_dir, strict=False)
        present = [h for h in expected
                   if manifests.get(h, {}).get("generation") == generation]
        if len(present) == len(expected):
            break
        if time.monotonic() >= deadline:
            missing = sorted(set(expected) - set(present))
            raise PodCommitTimeout(
                f"pod commit of {ckpt_dir} (generation {generation}) timed out "
                f"after {timeout_s:.1f}s: host(s) {missing} never reported a "
                "shard manifest — the tag stays uncommitted", missing)
        time.sleep(poll_s)
    # a host that reported but whose file tore is a torn pod tag NOW, not at
    # a restore generations later
    problems: List[str] = []
    for host in expected:
        problems += _file_problems(ckpt_dir, host, manifests[host])
    if problems:
        raise CheckpointIntegrityError(
            f"pod commit of {ckpt_dir} refused: " + "; ".join(problems[:8]))
    doc = {"manifest_version": MANIFEST_VERSION, "generation": int(generation),
           "hosts": expected,
           "global_steps": max((int(m.get("global_steps", -1))
                                for m in manifests.values()), default=-1)}
    return _atomic_write_doc(os.path.join(ckpt_dir, POD_MANIFEST_FILE), doc)


def read_pod_manifest(ckpt_dir: str) -> Optional[Dict]:
    path = os.path.join(ckpt_dir, POD_MANIFEST_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointIntegrityError(f"unreadable pod manifest {path}: {e}") from e


def verify_pod_checkpoint_dir(ckpt_dir: str) -> Dict:
    """Verify a tag as a POD checkpoint: the pod manifest is present (else
    the tag is torn), every host it names has a manifest of its generation,
    and every file listed there exists with its size and checksum.  The
    engine's own manifest check still runs on load."""
    pod = read_pod_manifest(ckpt_dir)
    if pod is None:
        raise CheckpointIntegrityError(
            f"checkpoint {ckpt_dir} has no {POD_MANIFEST_FILE}: the pod commit "
            "never completed (a host died before reporting its shard) — torn "
            "pod checkpoint")
    manifests = read_host_manifests(ckpt_dir)
    problems: List[str] = []
    for host in pod.get("hosts", []):
        m = manifests.get(str(host))
        if m is None:
            problems.append(f"host{host}: manifest missing")
            continue
        if int(m.get("generation", -1)) != int(pod["generation"]):
            problems.append(f"host{host}: generation {m.get('generation')} != "
                            f"{pod['generation']}")
        problems += _file_problems(ckpt_dir, str(host), m)
    if problems:
        raise CheckpointIntegrityError(
            f"pod checkpoint {ckpt_dir} failed verification: "
            + "; ".join(problems[:8])
            + (f" (+{len(problems) - 8} more)" if len(problems) > 8 else ""))
    return pod


def pod_committed(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, POD_MANIFEST_FILE))


def pod_checkpoint_progress_fn(ckpt_dir: str):
    """The supervisor's progress signal in pod mode: the newest
    POD-committed global step (-1 while none).  A tag committed by one host
    only does not count: the pod restore rejects it."""
    def progress() -> int:
        if not os.path.isdir(ckpt_dir):
            return -1
        best = -1
        for tag in candidate_tags(ckpt_dir):
            tag_dir = os.path.join(ckpt_dir, tag)
            if pod_committed(tag_dir):
                best = max(best, read_tag_step(tag_dir))
        return best

    return progress
