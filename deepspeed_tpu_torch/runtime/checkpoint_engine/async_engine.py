"""Async checkpointing with commit semantics (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/async_engine.py``; reference
``runtime/checkpoint_engine/nebula_checkpoint_engine.py``).

``save()`` returns once the state is snapshotted to host memory: every
tensor is copied into a host buffer on the current stream (pinned for a
card's tensors, kept for the next save), then the stream is synchronised,
so training may overwrite the device state at once.  A commit thread then
writes the snapshot with ``torch.distributed.checkpoint``, writes the
manifest (the commit marker) and only then publishes ``latest``: a crash
mid-write never leaves ``latest`` naming a torn tag.  A data-parallel
engine's threads write their shards and meet at a barrier of the
checkpoint's own gloo group before rank 0 commits.
``wait_for_pending_checkpoint`` joins that thread and re-raises its
failure.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from .checkpoint_engine import CheckpointEngine
from .dcp_engine import DCPCheckpointEngine, commit_tag
from ...utils.logging import log_dist, logger

# upper bound on joining a wedged commit thread
DEFAULT_FINALIZE_TIMEOUT_S = 600.0


class AsyncCheckpointEngine(CheckpointEngine):
    """Keep ONE instance alive across saves: it owns the host buffers the
    snapshots go to (reused while the state's shapes stay the same)."""

    def __init__(self, config_params=None,
                 timeout_secs: float = DEFAULT_FINALIZE_TIMEOUT_S,
                 process_group=None):
        super().__init__(config_params)
        self.timeout_secs = timeout_secs
        self._host: Dict[str, torch.Tensor] = {}
        self._snapshot: Optional[Dict[str, torch.Tensor]] = None
        self._path: Optional[str] = None
        self._sync = DCPCheckpointEngine(process_group=process_group)

    def _buffer(self, key: str, t: torch.Tensor) -> torch.Tensor:
        buf = self._host.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                              pin_memory=t.is_cuda)
            self._host[key] = buf
        return buf

    def save(self, state_dict: Dict[str, torch.Tensor], path: str) -> None:
        """Snapshot ``state_dict`` to host memory; ``commit`` writes it."""
        snap = {k: self._buffer(k, t).copy_(t, non_blocking=True)
                for k, t in state_dict.items()}
        if any(t.is_cuda for t in state_dict.values()):
            torch.cuda.current_stream().synchronize()
        self._snapshot, self._path = snap, path

    def wrap(self, fn) -> None:
        """Replace the snapshot by ``fn(snapshot)`` (the host shards as
        DTensors of a data-parallel engine)."""
        self._snapshot = fn(self._snapshot)

    def load(self, path: str, target=None):
        return self._sync.load(path, target)

    def commit(self, tag: str) -> bool:
        """Write the snapshot (on the commit thread)."""
        snap, self._snapshot = self._snapshot, None
        self._sync.save(snap, self._path)
        return True


def commit_in_background(engine, save_dir: str, ckpt_dir: str, tag: str,
                         save_latest: bool, manifest: Dict) -> None:
    """Start the commit thread: write the snapshot, then the manifest (the
    commit marker), then (and only then) ``latest``.  The thread is kept on
    the engine for ``wait_for_checkpoint()`` and the next save or load."""
    ce: AsyncCheckpointEngine = engine._async_ckpt_engine

    def finalize():
        try:
            ce.commit(tag)
            commit_tag(engine, ce._sync.process_group, save_dir, ckpt_dir, tag,
                       save_latest, manifest)
        except Exception as e:   # surfaced by the next wait; latest untouched
            # read and cleared only after the join proves this thread dead
            engine._async_ckpt_error = e
            logger.error(f"async checkpoint {tag} failed: {e}")
            return
        log_dist(f"committed async checkpoint {tag} -> {ckpt_dir}", ranks=[0])

    t = threading.Thread(target=finalize, name=f"ckpt-commit-{tag}", daemon=True)
    engine._pending_ckpt_thread = t
    t.start()


def wait_for_pending_checkpoint(engine, timeout_s: Optional[float] = None) -> None:
    """Join the in-flight async save, re-raising its failure if any.  The
    join is bounded (``timeout_s``, else the async engine's
    ``timeout_secs``): a wedged storage write raises rather than hangs."""
    t = engine._pending_ckpt_thread
    if t is not None:
        if timeout_s is None:
            ce = engine._async_ckpt_engine
            timeout_s = ce.timeout_secs if ce is not None else DEFAULT_FINALIZE_TIMEOUT_S
        t.join(timeout=timeout_s)
        if t.is_alive():
            raise RuntimeError(
                f"async checkpoint commit ({t.name}) still running after "
                f"{timeout_s:.0f}s: the storage write is wedged; `latest` still "
                "names the previous committed tag")
        engine._pending_ckpt_thread = None
    err, engine._async_ckpt_error = engine._async_ckpt_error, None
    if err is not None:
        raise RuntimeError("async checkpoint save failed") from err
