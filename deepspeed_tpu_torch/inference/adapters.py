"""Multi-tenant adapter serving: per-request LoRA over one shared base model
(counterpart of ``deepspeed_tpu/inference/adapters.py``).

Two serving paths share one engine and one KV pool:

- **batched delta** (the default): each admitted request's LoRA factors
  ride as per-slot operands of the decode, prefill and verify steps
  (``models.transformer.forward_paged(adapters=)``).  Factors are stored
  rank-padded to the smallest of ``rank_buckets`` that fits, and the
  per-slot stacks hold ``max_rank = max(rank_buckets)`` columns: zero
  columns add exactly zero, so one stack shape serves any tenant mix and
  adapter-less slots ride all-zero factors.  The executor allocates the
  device stacks once and writes a slot's rows in place at admission, so a
  captured decode graph never sees a new address.
- **fused view** (a hot tenant): :meth:`AdapterRegistry.fuse` folds one
  adapter into the base weights (``runtime.lora.apply_lora``) and the
  engine copies the result into its live weights through
  ``ServingEngine.update_params``, whose weight-epoch flip makes every
  cached K/V page of the previous weights unservable.

Isolation is structural: each tenant's prefix-cache chains run under a
salted root (:func:`adapter_salt`), so two tenants never share a page.
The registry is host state (numpy); device placement is the executor's.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..runtime.lora import DEFAULT_TARGETS, LoRAConfig, apply_lora

__all__ = ["Adapter", "AdapterRegistry", "UnknownAdapter", "adapter_salt",
           "DEFAULT_RANK_BUCKETS"]

# rank buckets: storage padding tiers.  The per-slot stacks' rank is
# max(buckets), one shape whichever bucket a tenant's adapter stores at
# (zero padding is exact).
DEFAULT_RANK_BUCKETS: Tuple[int, ...] = (8, 16)


def _numpy_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def adapter_salt(adapter_id: Optional[str]) -> int:
    """Process-independent prefix-namespace salt for an adapter id.

    MUST NOT use Python ``hash`` of the string (PYTHONHASHSEED randomizes
    str/bytes per process — fleet residency digests would never match
    across members).  Two crc32 passes (forward + reversed bytes) give a
    64-bit value; ``None`` (the base model) is salt 0 — the unsalted
    namespace — and a pathological double-crc of 0 maps to 1 so no named
    tenant can ever land in the base namespace.  A salt collision between
    two distinct tenant ids would merge their namespaces; at 64 bits this
    is the same (accepted) risk class as the chain hash itself.
    """
    if adapter_id is None:
        return 0
    raw = str(adapter_id).encode("utf-8")
    s = (zlib.crc32(raw) << 32) | zlib.crc32(raw[::-1])
    return s if s != 0 else 1


class UnknownAdapter(ValueError):
    """``Request.adapter_id`` names an adapter this engine has not
    registered — a client/routing error (typed so admission can shed it
    with a typed result instead of crashing the scheduler)."""


@dataclasses.dataclass
class Adapter:
    """One registered tenant adapter (host-resident, rank-padded).

    ``factors`` maps target name → ``{"A": [L, d_in, bucket] f32,
    "B": [L, bucket, d_out] f32}`` numpy arrays, zero-padded from the true
    rank up to ``bucket``.  ``scale`` uses the TRUE rank (alpha/rank) —
    padding never changes the math."""
    adapter_id: str
    rank: int
    bucket: int
    alpha: float
    scale: float
    salt: int
    factors: Dict[str, Dict[str, np.ndarray]]

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for ab in self.factors.values()
                   for a in ab.values())


class AdapterRegistry:
    """Host-side registry of tenant adapters for one serving engine.

    Built against the engine's base ``params["layers"]`` shapes so every
    registered adapter is shape-checked once, at registration, never in
    the scheduler hot path.  The registry also owns the layout of the
    per-slot factor stacks the executor traces — ``{"scale": [B] f32,
    "factors": {target: {"A": [L,B,d_in,R], "B": [L,B,R,d_out]}}}`` with
    ``R = max_rank`` — and the slot write/clear operations on them.
    """

    def __init__(self, base_layers: Dict[str, Any],
                 targets: Tuple[str, ...] = DEFAULT_TARGETS,
                 rank_buckets: Tuple[int, ...] = DEFAULT_RANK_BUCKETS):
        buckets = sorted({int(b) for b in rank_buckets})
        if not buckets or buckets[0] < 1:
            raise ValueError(f"rank_buckets={rank_buckets!r} must be "
                             "non-empty positive ints")
        self.rank_buckets: Tuple[int, ...] = tuple(buckets)
        self.max_rank = self.rank_buckets[-1]
        self.targets: Tuple[str, ...] = tuple(targets)
        if len(set(self.targets)) != len(self.targets) or not self.targets:
            raise ValueError(f"targets={targets!r} must be non-empty and "
                             "unique")
        self.shapes: Dict[str, Tuple[int, int, int]] = {}
        for k in self.targets:
            if k not in base_layers:
                raise ValueError(f"adapter target {k!r} not in model layers "
                                 f"({sorted(base_layers)})")
            w = base_layers[k]
            if getattr(w, "ndim", None) != 3:
                raise ValueError(f"adapter target {k!r} is not a stacked "
                                 "[L, d_in, d_out] weight")
            self.shapes[k] = tuple(int(s) for s in w.shape)
        self._adapters: Dict[str, Adapter] = {}
        # counters surfaced as serve/adapter_* gauges by the engine
        self.resolve_total = 0
        self.resolve_miss_total = 0

    # ------------------------------------------------------------ registry

    def __len__(self) -> int:
        return len(self._adapters)

    def __contains__(self, adapter_id: Optional[str]) -> bool:
        return adapter_id in self._adapters

    def loaded(self) -> List[str]:
        """Registered adapter ids, sorted — what a fleet member advertises
        alongside its prefix-residency digest (docs/FLEET.md)."""
        return sorted(self._adapters)

    def bucket_for(self, rank: int) -> int:
        for b in self.rank_buckets:
            if rank <= b:
                return b
        raise ValueError(
            f"LoRA rank={rank} exceeds the largest rank bucket "
            f"{self.rank_buckets[-1]} — the traced stacks cannot carry it")

    def register(self, adapter_id: str, lora: Dict[str, Any],
                 cfg: LoRAConfig, replace: bool = False) -> Adapter:
        """Shape-check, rank-pad and file one tenant adapter.

        ``lora`` is an ``init_lora_params``-shaped tree ``{target: {"A":
        [L, d_in, rank], "B": [L, rank, d_out]}}`` (numpy or tensor leaves).
        Targets must be a subset of the registry's — a target the traced
        programs don't carry an operand for could never be applied.
        Missing registry targets simply stay zero for this tenant.
        Re-registering requires ``replace=True`` (a silently swapped
        adapter under live traffic would corrupt in-flight streams — the
        engine drains the tenant first)."""
        aid = str(adapter_id)
        if not aid:
            raise ValueError("adapter_id must be a non-empty string")
        if aid in self._adapters and not replace:
            raise ValueError(f"adapter {aid!r} already registered "
                             "(pass replace=True after draining it)")
        cfg.validate()
        bucket = self.bucket_for(int(cfg.rank))
        factors: Dict[str, Dict[str, np.ndarray]] = {}
        for k, ab in lora.items():
            if k not in self.shapes:
                raise ValueError(
                    f"adapter {aid!r} targets {k!r}, which this engine's "
                    f"traced programs carry no operand for "
                    f"(registry targets: {list(self.targets)})")
            L, d_in, d_out = self.shapes[k]
            A, B = (_numpy_f32(ab[n]) for n in ("A", "B"))
            if A.shape != (L, d_in, int(cfg.rank)) \
                    or B.shape != (L, int(cfg.rank), d_out):
                raise ValueError(
                    f"adapter {aid!r} target {k!r} factor shapes "
                    f"A{A.shape}/B{B.shape} do not match layers "
                    f"[{L},{d_in},{d_out}] at rank {cfg.rank}")
            Ap = np.zeros((L, d_in, bucket), np.float32)
            Bp = np.zeros((L, bucket, d_out), np.float32)
            Ap[:, :, :int(cfg.rank)] = A
            Bp[:, :int(cfg.rank), :] = B
            factors[k] = {"A": Ap, "B": Bp}
        ad = Adapter(adapter_id=aid, rank=int(cfg.rank), bucket=bucket,
                     alpha=float(cfg.alpha), scale=float(cfg.scaling),
                     salt=adapter_salt(aid), factors=factors)
        self._adapters[aid] = ad
        return ad

    def resolve(self, adapter_id: Optional[str]) -> Optional[Adapter]:
        """Admission-time lookup: ``None`` (base model) resolves to
        ``None``; an unregistered id raises :class:`UnknownAdapter`."""
        if adapter_id is None:
            return None
        self.resolve_total += 1
        ad = self._adapters.get(str(adapter_id))
        if ad is None:
            self.resolve_miss_total += 1
            raise UnknownAdapter(
                f"adapter {adapter_id!r} is not registered on this engine "
                f"(loaded: {self.loaded()})")
        return ad

    def salt(self, adapter_id: Optional[str]) -> int:
        return adapter_salt(adapter_id)

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self._adapters.values())

    # --------------------------------------------------------- fused view

    def fuse(self, base_params: Dict[str, Any], adapter_id: str,
             shard=None) -> Dict[str, Any]:
        """Fused param view for a hot tenant: ``base + A @ B * scale`` on
        the targeted layers — rank padding is exact under the product, so
        fusing the padded factors equals fusing the originals.  The output
        tree has IDENTICAL treedef/avals to ``base_params`` (``apply_lora``
        only rewrites targeted layer leaves in place), which is exactly
        what ``ServingEngine.update_params`` requires (it copies the view
        into the live tensors).  ``shard(name, delta)`` cuts each whole delta
        to a rank's model-axis shard when ``base_params`` holds shards."""
        ad = self.resolve(adapter_id)
        return apply_lora(base_params, ad.factors, ad.scale, shard=shard)

    # ------------------------------------------------- per-slot stacks

    def make_slot_stacks(self, b_slots: int) -> Dict[str, Any]:
        """All-zero host stacks for ``b_slots`` decode slots — the traced
        adapter operand pytree at rest.  Zero factors ⇒ zero delta, so a
        freshly built stack serves adapter-less traffic bit-exactly."""
        B, R = int(b_slots), self.max_rank
        factors = {}
        for k, (L, d_in, d_out) in self.shapes.items():
            factors[k] = {"A": np.zeros((L, B, d_in, R), np.float32),
                          "B": np.zeros((L, B, R, d_out), np.float32)}
        return {"scale": np.zeros((B,), np.float32), "factors": factors}

    def write_slot(self, stacks: Dict[str, Any], slot: int,
                   adapter: Optional[Adapter]) -> None:
        """Install ``adapter``'s factors into slot ``slot`` of the host
        stacks (``None`` clears the slot back to the base model)."""
        s = int(slot)
        stacks["scale"][s] = 0.0
        for k, ab in stacks["factors"].items():
            ab["A"][:, s, :, :] = 0.0
            ab["B"][:, s, :, :] = 0.0
        if adapter is None:
            return
        stacks["scale"][s] = adapter.scale
        for k, ab in adapter.factors.items():
            st = stacks["factors"][k]
            st["A"][:, s, :, :adapter.bucket] = ab["A"]
            st["B"][:, s, :adapter.bucket, :] = ab["B"]

    def clear_slot(self, stacks: Dict[str, Any], slot: int) -> None:
        self.write_slot(stacks, slot, None)
