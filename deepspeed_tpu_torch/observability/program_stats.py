"""Per-program device-time accounting: FLOPs, invocation counts, MFU
(counterpart of ``deepspeed_tpu/observability/program_stats.py``).

A serving engine's steady state is an inventory of fixed-shape programs
(the decode step, one prefill per bucket, COW, the tier movers, draft and
verify under speculation), each invoked at its own cadence, so accounting
is per program and live.  :class:`ProgramCatalog` is that ledger:

- **Cost at first sight**: the JAX package reads XLA's lowered cost
  analysis, which runs nothing.  PyTorch has no compiled program to ask,
  so the port counts one eager run of the program under the flops
  profiler's ``CostCounter`` (``torch.utils.flop_counter`` plus a
  byte-counting dispatch mode plus each hand-written kernel's own cost,
  ``ops/kernels/common.py`` ``cost_sinks``), and that run is the
  program's first real invocation: no extra run is ever made.  A program
  that runs as a CUDA graph is counted on one of its capture's eager
  warm-up runs (``inference/execution.py`` ``capture_graph``), never
  during the capture itself.  A counted run pays the counter's host work
  (every operation dispatched through Python), so an engine counts costs
  only when something reads them (``count_costs``: the serving engine
  with a monitor or synced sampling, the training engine with a monitor);
  otherwise its programs are counted by invocations only, their cost 0.
- **Invocation counts**: one dict increment per program call, so ``flops *
  invocations`` is a live executed-FLOPs ledger per program and engine.
- **Sampled synced wall time** (``sample_every=N``, default 0 = off):
  every Nth invocation is timed through ``torch.cuda.synchronize`` — a
  real device-time sample.  Off by default because a sync point breaks
  the asynchronous launch queue; with samples, ``device_seconds_total``
  per program and whole-engine MFU estimates become available
  (:meth:`ProgramCatalog.mfu`).

Surfaces: ``ServingEngine.program_stats()`` / ``health()["program_stats"]``,
the ``serve/program_flops{program=...}`` / ``serve/device_seconds_total``
gauges, and the training engine's ``train/tflops_est`` / ``train/mfu_est``.

A counting failure registers zeros and moves on: accounting never gates
the program it counts (a program that itself fails still raises).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.logging import logger

__all__ = ["ProgramCatalog", "account", "finish_sample",
           "peak_flops_per_sec", "PEAK_TFLOPS_ENV"]

PEAK_TFLOPS_ENV = "DS_TPU_PEAK_TFLOPS"


def peak_flops_per_sec() -> Optional[float]:
    """The device's peak flops/s for MFU denominators, or ``None`` when
    unknown.  There is no baked-in spec-sheet table: the operator states
    the roof they trust through ``DS_TPU_PEAK_TFLOPS``."""
    raw = os.environ.get(PEAK_TFLOPS_ENV, "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        logger.warning("ignoring malformed $%s=%r (want TFLOP/s as a "
                       "number)", PEAK_TFLOPS_ENV, raw)
        return None
    return v * 1e12 if v > 0 else None


class _Stat:
    __slots__ = ("flops", "bytes", "invocations", "synced_samples",
                 "synced_seconds", "registered")

    def __init__(self):
        self.flops = 0.0          # per invocation, from the counted run
        self.bytes = 0.0
        self.invocations = 0
        self.synced_samples = 0
        self.synced_seconds = 0.0
        self.registered = False


class ProgramCatalog:
    """Ledger of per-program cost and usage for one engine's inventory.

    Call pattern at a program's call site (see ``MeshExecutor.prefill``)::

        out, t0 = account(catalog, "prefill_64", run, (args...))
        if t0 is not None:                     # a sampled invocation
            finish_sample(catalog, "prefill_64", out, t0)
    """

    def __init__(self, sample_every: int = 0, count_costs: bool = True):
        if int(sample_every) < 0:
            raise ValueError(f"sample_every={sample_every} must be >= 0 "
                             "(0 disables synced sampling)")
        self.sample_every = int(sample_every)
        # whether a program's first run is counted (register_call)
        self.count_costs = bool(count_costs)
        self._stats: Dict[str, _Stat] = {}
        self._lock = threading.Lock()

    # ---------------------------------------------------------- registration

    def known(self, name: str) -> bool:
        st = self._stats.get(name)
        return st is not None and st.registered

    def register(self, name: str, flops: float = 0.0,
                 bytes: float = 0.0) -> None:
        """Record a program's per-invocation cost directly (the training
        engine registers its step from the counted step's cost)."""
        with self._lock:
            st = self._stats.setdefault(name, _Stat())
            st.flops = float(flops)
            st.bytes = float(bytes)
            st.registered = True

    def register_call(self, name: str, fn: Callable, *args: Any) -> Any:
        """Run ``fn(*args)`` once under the flops profiler's counter and
        register what it counted; returns ``fn``'s output.  An exception
        of ``fn`` propagates (nothing is registered); a failure of the
        counting itself registers zeros, so the attempt is not repeated."""
        from ..profiling.flops_profiler.profiler import CostCounter

        counter = CostCounter()
        with counter:
            out = fn(*args)
        flops = by = 0.0
        try:
            cost = counter.cost()
            flops, by = float(cost["flops"]), float(cost["bytes accessed"])
        except Exception as e:   # accounting never gates the program
            logger.warning("program_stats: counting %r failed (%s: %s); "
                           "registering zero cost", name, type(e).__name__, e)
        self.register(name, flops=flops, bytes=by)
        return out

    # ------------------------------------------------------------ accounting

    def invoke(self, name: str, n: int = 1) -> Optional[float]:
        """Count one dispatch of ``name`` (``n`` program invocations).
        Returns a ``perf_counter`` start stamp when THIS dispatch should be
        synced-sampled (every ``sample_every``-th), else ``None`` — the
        common N=0 path is one increment under the lock, no clock read."""
        with self._lock:
            st = self._stats.setdefault(name, _Stat())
            st.invocations += n
            if self.sample_every and st.invocations % self.sample_every == 0:
                return time.perf_counter()
        return None

    def record_sync(self, name: str, dur_s: float) -> None:
        with self._lock:
            st = self._stats.setdefault(name, _Stat())
            st.synced_samples += 1
            st.synced_seconds += float(dur_s)

    def flops_of(self, name: str) -> float:
        """Registered per-invocation FLOPs of one program (0.0 when the
        counting failed or the program is unknown)."""
        with self._lock:
            st = self._stats.get(name)
            return st.flops if st is not None else 0.0

    # -------------------------------------------------------------- reading

    def table(self) -> Dict[str, Dict[str, Any]]:
        """Per-program snapshot: per-invocation cost, usage counts, the
        executed-FLOPs ledger, and — when synced samples exist — the mean
        sampled wall time, estimated total device seconds
        (``invocations * mean``) and the achieved flops/s it implies."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            items = [(k, (v.flops, v.bytes, v.invocations, v.synced_samples,
                          v.synced_seconds)) for k, v in self._stats.items()]
        for name, (flops, by, inv, ns, secs) in sorted(items):
            row: Dict[str, Any] = {
                "flops": flops,
                "bytes": by,
                "invocations": inv,
                "flops_total": flops * inv,
                "synced_samples": ns,
            }
            if ns:
                mean = secs / ns
                row["sampled_mean_s"] = mean
                row["device_seconds_est"] = mean * inv
                row["achieved_flops_per_s"] = (flops / mean if mean > 0
                                               else 0.0)
            else:
                row["device_seconds_est"] = 0.0
            out[name] = row
        return out

    def gauge_rows(self) -> List[Tuple[str, float, float]]:
        """Per-program ``(name, flops_total, device_seconds_est)`` for the
        per-tick gauge writer (a flat list under one lock hold)."""
        with self._lock:
            return [(name,
                     st.flops * st.invocations,
                     (st.synced_seconds / st.synced_samples
                      * st.invocations) if st.synced_samples else 0.0)
                    for name, st in self._stats.items()]

    def totals(self) -> Dict[str, float]:
        """Whole-engine rollup of the executed-FLOPs ledger and the
        device-seconds estimate (0.0 until synced samples exist)."""
        flops_total = device_s = 0.0
        sampled = True
        with self._lock:
            for st in self._stats.values():
                flops_total += st.flops * st.invocations
                if st.synced_samples:
                    device_s += (st.synced_seconds / st.synced_samples
                                 * st.invocations)
                elif st.invocations:
                    sampled = False
        return {"flops_total": flops_total,
                "device_seconds_est": device_s,
                "fully_sampled": sampled}

    def mfu(self, peak_flops_per_s: Optional[float] = None
            ) -> Optional[float]:
        """Whole-engine MFU estimate: executed FLOPs over estimated device
        seconds, against ``peak_flops_per_s`` (default: the operator's
        ``DS_TPU_PEAK_TFLOPS``).  ``None`` until every invoked program has
        synced samples AND a peak is known."""
        if peak_flops_per_s is None:
            peak_flops_per_s = peak_flops_per_sec()
        if not peak_flops_per_s:
            return None
        t = self.totals()
        if not t["fully_sampled"] or t["device_seconds_est"] <= 0:
            return None
        return (t["flops_total"] / t["device_seconds_est"]
                / peak_flops_per_s)


# -------------------------------------------------- call-site helpers
#
# The one count-on-every-call + register-on-first-sight protocol every
# program call site follows, None-safe so callers without a catalog pay a
# single comparison.

def account(catalog: Optional[ProgramCatalog], name: str, prog: Callable,
            args: tuple = (), n: int = 1) -> Tuple[Any, Optional[float]]:
    """Run ``prog(*args)`` and count the dispatch; returns ``(output, t0)``
    with ``t0`` a ``perf_counter`` stamp taken before the run when this
    dispatch was picked for synced sampling, else ``None``.  On the
    program's first sight the run itself is counted (``register_call``,
    when the catalog counts costs); that run is not sampled, since the
    counter's host work is in it."""
    if catalog is None:
        return prog(*args), None
    if catalog.count_costs and not catalog.known(name):
        out = catalog.register_call(name, prog, *args)
        catalog.invoke(name, n)
        return out, None
    t0 = catalog.invoke(name, n)
    return prog(*args), t0


def _devices(tree: Any) -> set:
    import torch

    stack, devices = [tree], set()
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor) and x.device.type == "cuda":
            devices.add(x.device)
    return devices


def finish_sample(catalog: ProgramCatalog, name: str, out: Any,
                  t0: float) -> None:
    """Close a sampled dispatch: wait for the device work behind ``out``
    (``torch.cuda.synchronize`` of its devices; nothing on the CPU, where
    the run already finished) and record the wall time.  A failed wait
    drops the sample."""
    try:
        import torch

        for d in _devices(out):
            torch.cuda.synchronize(d)
    except Exception:
        return
    catalog.record_sync(name, time.perf_counter() - t0)
