"""Determinism and replica-consistency checks (counterpart of
``deepspeed_tpu/utils/debug.py``).

- :func:`checksum_tree` — a stable fingerprint of every leaf of a tree, the
  JAX package's recipe byte for byte (sha256 over the leaf's bytes, its
  numpy dtype name and its shape, cut to 16 hex digits), so a numpy tree
  gives the same digests in both packages.
- :func:`assert_replicas_consistent` — every rank of ``torch.distributed``
  contributes one row per (leaf, shard) of its digests; a (leaf, shard)
  that two ranks hold must hold the same bytes.  A plain tensor is one
  piece (index ``"full"``: a replica); a ``DTensor`` is its local shard,
  indexed by its global offset, so shards of one leaf on different ranks
  are not compared.
- :func:`assert_deterministic` — run a function twice and require bitwise
  equal outputs.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict

import numpy as np
import torch

from .logging import log_dist
from .tree import tree_flatten_with_path


def path_str(path) -> str:
    """'/'-joined name of a path: the port's trees already spell their
    paths so (``utils/tree.py``); a sequence of keys is joined."""
    if isinstance(path, str):
        return path
    return "/".join(str(p) for p in path)


def _bytes_dtype_shape(x):
    """(raw bytes, numpy dtype name, shape) of a leaf on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_meta:
            raise ValueError("a meta tensor holds no bytes to fingerprint")
        x = x.cpu().contiguous()
        name = str(x.dtype).replace("torch.", "")
        if x.dtype == torch.bfloat16:   # numpy has no bfloat16: its raw bits
            raw = x.view(torch.int16).numpy().tobytes()
        else:
            raw = x.numpy().tobytes()
        return raw, name, tuple(x.shape)
    arr = np.asarray(x)
    return arr.tobytes(), str(arr.dtype), arr.shape


def _leaf_pieces(x) -> Dict[str, Any]:
    """This process's data of a leaf as {shard-index: tensor}: a DTensor's
    local shard under its global offset, anything else one 'full' piece."""
    if hasattr(x, "to_local") and hasattr(x, "device_mesh"):
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset

        shape, offset = compute_local_shape_and_global_offset(
            x.shape, x.device_mesh, x.placements)
        return {str((tuple(shape), tuple(offset))): x.to_local()}
    return {"full": x}


def _piece_digest(x) -> str:
    raw, dtype, shape = _bytes_dtype_shape(x)
    h = hashlib.sha256()
    h.update(raw + dtype.encode() + str(shape).encode())
    return h.hexdigest()[:16]


def _fingerprint_from_digests(digests: Dict[str, str]) -> str:
    if set(digests) == {"full"}:
        return digests["full"]
    h = hashlib.sha256()
    for idx in sorted(digests):
        h.update(idx.encode() + digests[idx].encode())
    return h.hexdigest()[:16]


def checksum_tree(tree: Any) -> Dict[str, str]:
    """{'path': sha256-16} per leaf — a stable state fingerprint."""
    out: Dict[str, str] = {}
    for path, leaf in tree_flatten_with_path(tree):
        out[path_str(path)] = _fingerprint_from_digests(
            {idx: _piece_digest(p) for idx, p in _leaf_pieces(leaf).items()})
    return out


def _split64(hexdigest16: str):
    v = int(hexdigest16, 16)
    return (v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF


def _shard_digest_rows(piece_digests) -> np.ndarray:
    """One uint32 row per (leaf, piece): ``[leaf_id, index_hash_hi,
    index_hash_lo, data_hash_hi, data_hash_lo]`` (the JAX package's
    table)."""
    rows = []
    for li, digests in enumerate(piece_digests):
        for idx_str in sorted(digests):
            ih = _split64(hashlib.sha256(idx_str.encode()).hexdigest()[:16])
            dh = _split64(digests[idx_str])
            rows.append([li, ih[0], ih[1], dh[0], dh[1]])
    return np.asarray(rows, np.uint32).reshape(-1, 5)


def _gather_rows(rows: np.ndarray, group=None) -> np.ndarray:
    """[world, nrows, 5] of every rank's table (int64 on the wire: gloo and
    NCCL have no uint32)."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    local = torch.from_numpy(rows.astype(np.int64)).to(device)
    n = torch.tensor([local.shape[0]], device=device)
    counts = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(counts, n, group=group)
    if len({int(c) for c in counts}) != 1:
        raise RuntimeError(
            f"replica check: ranks hold different numbers of leaf pieces "
            f"({[int(c) for c in counts]}): the trees differ in structure")
    out = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(out, local, group=group)
    return torch.stack(out).cpu().numpy()


def assert_replicas_consistent(tree: Any, name: str = "state",
                               group=None) -> Dict[str, str]:
    """Every pair of ranks holding the same (leaf, shard index) must hold
    the same bytes; raise naming the leaves and rank pairs that differ.
    Without a process group (or in a world of 1): the checksums alone.
    Returns this rank's per-leaf checksums.  Collective over ``group``
    (default: the world; pass the data-parallel group to check the
    replicas of model-parallel shards)."""
    import torch.distributed as dist

    flat = tree_flatten_with_path(tree)
    piece_digests, local = [], {}
    for p, leaf in flat:
        digests = {idx: _piece_digest(x) for idx, x in _leaf_pieces(leaf).items()}
        piece_digests.append(digests)
        local[path_str(p)] = _fingerprint_from_digests(digests)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size(group) > 1:
        gathered = _gather_rows(_shard_digest_rows(piece_digests), group)
        seen: Dict[tuple, tuple] = {}
        diverged = []
        for rank in range(gathered.shape[0]):
            for li, ih0, ih1, dh0, dh1 in gathered[rank]:
                key = (int(li), int(ih0), int(ih1))
                dig = (int(dh0), int(dh1))
                prev = seen.setdefault(key, (rank, dig))
                if prev[1] != dig:
                    diverged.append((path_str(flat[int(li)][0]), prev[0], rank))
        if diverged:
            uniq = sorted({d[0] for d in diverged})
            pairs = sorted({(a, b) for _, a, b in diverged})
            raise RuntimeError(
                f"replica divergence in {name}: {len(uniq)} leaves hold "
                f"differing replicas across processes (leaves: {uniq[:5]}; "
                f"process pairs: {pairs[:5]})")
    log_dist(f"{name}: {len(local)} leaves replica-consistent", ranks=[0])
    return local


def assert_deterministic(fn: Callable, *args, what: str = "fn") -> Any:
    """Run ``fn`` twice with identical inputs; raise unless outputs are
    bitwise equal.  Returns the (first) output."""
    out1, out2 = fn(*args), fn(*args)
    c1, c2 = checksum_tree(out1), checksum_tree(out2)
    diff = sorted(k for k in c1 if c1[k] != c2.get(k))
    if diff:
        raise RuntimeError(
            f"{what} is nondeterministic: {len(diff)} output leaves changed "
            f"between identical calls (first: {diff[:5]})")
    return out1


def probe_device_count(timeout_s: float = 60.0):
    """(device_count | None, error | None) without risking a hang: the
    CUDA driver's initialisation can block on a wedged card, so the probe
    runs on a daemon thread (None count = the probe timed out; an
    exception is returned, not raised)."""
    import threading

    box = {}

    def probe():
        try:
            box["n"] = torch.cuda.device_count()
        except Exception as e:  # no driver / init raised
            box["err"] = e

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return None, None
    return box.get("n"), box.get("err")
