"""In-RAM train-state slabs for checkpoint-free pod recovery (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/replica_snapshot.py``).

The replica layer (``elasticity/replication.py``) needs two engine hooks:

- :func:`snapshot_train_state`: this rank's live state as one
  self-describing byte slab in host RAM, a device->host copy and nothing
  else;
- :func:`ingest_train_state`: the state rebuilt from a slab INTO the
  current engine, in place (as a checkpoint load), with the step counters
  (``global_steps`` / ``skipped_steps`` / ``micro_steps``), so the round
  resumes at the sealed step + 1.

The format is the JAX package's: ``MAGIC``, a little-endian u64 header
length, a JSON header (the counters, ``n_leaves`` and each leaf's shape
and dtype name: ``bfloat16``, ``float32``, ...), then each leaf's raw
little-endian bytes.  The leaves are this rank's flat state in
``dcp_engine.engine_state_dict`` order (the progressive-layer-drop
generator, params, masters, step, scaler, the dropout generator, the
optimizer state), ZeRO shards as they are; numpy has no bfloat16, so each
tensor's bytes are written through a ``uint8`` view of its contiguous CPU
copy.  A slab ingests only into an engine of the same config and the same
data-parallel world: a leaf count, shape or dtype that differs is a hard
error, so adoption falls back to the durable checkpoint instead of
loading a half-matching state.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import warnings
from typing import Dict

import torch

MAGIC = b"DSTPUREP1"
_LEN = struct.Struct("<Q")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _flat_state(engine) -> Dict[str, torch.Tensor]:
    """``engine_state_dict``'s keys and order, each value this rank's own
    (an uneven leaf's piece as it is, not gathered whole)."""
    from .dcp_engine import _offload_of, flatten_state

    state = engine.state
    if state is None or _offload_of(engine) is not None:
        raise ValueError("replica slabs carry the engine's device state: an "
                         "offloaded optimizer's host state is not in it")
    if getattr(engine, "_comm_error", None) is not None:
        raise ValueError("replica slabs do not carry the 1-bit optimizers' "
                         "per-rank communication state")
    out: Dict[str, torch.Tensor] = {}
    pld = getattr(engine, "pld_generator", None)
    if pld is not None:
        out["rng/pld"] = pld.get_state()
    flatten_state(state.params, "params", out)
    flatten_state(state.master_params, "master_params", out)
    flatten_state(state.step, "step", out)
    flatten_state(state.scaler, "scaler", out)
    out["rng/dropout"] = engine.generator.get_state()
    flatten_state(state.opt_state, "opt_state", out)
    return out


def _header(engine, leaves) -> bytes:
    return json.dumps({
        "format": 1,
        "global_steps": int(engine.global_steps),
        "skipped_steps": int(engine.skipped_steps),
        "micro_steps": int(engine.micro_steps),
        "n_leaves": len(leaves),
        "leaves": [{"shape": list(x.shape), "dtype": _dtype_name(x.dtype)}
                   for _, x in leaves],
    }, sort_keys=True).encode("utf-8")


def slab_nbytes(engine) -> int:
    """The size :func:`snapshot_train_state` would return, without copying
    anything (the replicator's cap check)."""
    leaves = list(_flat_state(engine).items())
    return (len(MAGIC) + _LEN.size + len(_header(engine, leaves))
            + sum(x.numel() * x.element_size() for _, x in leaves))


def snapshot_train_state(engine) -> bytearray:
    """This rank's live train state as one byte slab (a ``bytearray``: the
    leaves are copied from the card straight into it)."""
    leaves = list(_flat_state(engine).items())
    head = _header(engine, leaves)
    sizes = [x.numel() * x.element_size() for _, x in leaves]
    start = len(MAGIC) + _LEN.size + len(head)
    buf = bytearray(start + sum(sizes))
    buf[:start] = MAGIC + _LEN.pack(len(head)) + head
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # frombuffer's empty-buffer notice
        dst = torch.frombuffer(buf, dtype=torch.uint8) if buf else None
    off = start
    for (_, x), n in zip(leaves, sizes):
        if n:
            dst[off:off + n].copy_(x.detach().contiguous().reshape(-1).view(torch.uint8))
        off += n
    return buf


def ingest_train_state(engine, payload) -> int:
    """Rebuild the engine's state from a :func:`snapshot_train_state` slab,
    in place; returns the restored global step."""
    from .dcp_engine import restore_state

    view = memoryview(payload)
    if bytes(view[:len(MAGIC)]) != MAGIC:
        raise ValueError("replica slab has a bad magic — not a "
                         "snapshot_train_state payload")
    off = len(MAGIC)
    if len(view) < off + _LEN.size:
        raise ValueError("replica slab is truncated in its header")
    (head_len,) = _LEN.unpack_from(view, off)
    off += _LEN.size
    try:
        header = json.loads(bytes(view[off:off + head_len]).decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ValueError(f"replica slab header is unreadable: {e}") from e
    off += head_len
    if int(header.get("format", -1)) != 1:
        raise ValueError(f"replica slab format {header.get('format')} is not supported")
    cur = _flat_state(engine)
    if len(cur) != int(header["n_leaves"]):
        raise ValueError(
            f"replica slab carries {header['n_leaves']} leaves but the engine's "
            f"state has {len(cur)} — config mismatch")
    pieces = []
    for (key, x), spec in zip(cur.items(), header["leaves"]):
        shape = tuple(int(s) for s in spec["shape"])
        if tuple(x.shape) != shape or _dtype_name(x.dtype) != spec["dtype"]:
            raise ValueError(
                f"replica slab leaf {key} is {spec['dtype']}{list(shape)} but the "
                f"engine's is {_dtype_name(x.dtype)}{list(x.shape)} — config or "
                "data-parallel world mismatch")
        n = x.numel() * x.element_size()
        if off + n > len(view):
            raise ValueError("replica slab is truncated mid-leaf")
        pieces.append((key, x, off, n))
        off += n
    if off != len(view):
        raise ValueError("replica slab has trailing bytes — torn payload")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # a read-only buffer: only read here
        src = torch.frombuffer(view, dtype=torch.uint8) if len(view) else None
    for key, x, start, n in pieces:
        # in place, as a load does: a live leaf keeps its device and its
        # aliases (a number's or a generator's fresh tensor is read below);
        # bytes land through a uint8 view, as the leaves sit unaligned
        if not n:
            continue
        dst = x if x.is_contiguous() else torch.empty_like(
            x, memory_format=torch.contiguous_format)
        dst.reshape(-1).view(torch.uint8).copy_(src[start:start + n])
        if dst is not x:
            x.copy_(dst)
    flat, state = cur, engine.state
    engine.state = dataclasses.replace(
        state, params=restore_state(state.params, "params", flat),
        master_params=restore_state(state.master_params, "master_params", flat),
        step=restore_state(state.step, "step", flat),
        scaler=restore_state(state.scaler, "scaler", flat),
        opt_state=restore_state(state.opt_state, "opt_state", flat))
    engine.generator.set_state(flat["rng/dropout"])
    if "rng/pld" in flat:
        engine.pld_generator.set_state(flat["rng/pld"])
    engine.global_steps = int(header["global_steps"])
    engine.skipped_steps = int(header["skipped_steps"])
    engine.micro_steps = int(header["micro_steps"])
    return engine.global_steps
