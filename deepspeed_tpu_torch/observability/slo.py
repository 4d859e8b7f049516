"""SLO layer: span duration histograms and declarative alert rules
(counterpart of ``deepspeed_tpu/observability/slo.py``, copied:
framework-free).

- :class:`LogBucketHistogram` — a bounded log-bucketed duration histogram.
  The tracer keeps one per span name, so quantiles survive the flight
  recorder's eviction; exported as real Prometheus histograms by
  :func:`~.export.prometheus_text`.
- :class:`SloRule` / :class:`SloEvaluator` — declarative objectives over
  gauges and span quantiles (``serve.tick p99 < 0.05``,
  ``serve/queue_depth < 64``), evaluated by the owning loop (the serving
  engine: every working tick).  Firing states land on ``/metrics`` as
  ``dstpu_alert{rule="..."} 1`` and in ``health()["alerts"]``.

Evaluation never gates the product: a rule whose metric is missing does
not fire, and evaluator errors degrade to "no verdict this round".
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["LogBucketHistogram", "SloRule", "SloEvaluator"]


class LogBucketHistogram:
    """Bounded log-bucketed histogram of positive durations (seconds).

    Buckets are geometric at ``subdiv`` per octave (default 4 ⇒ ratio
    2^¼ ≈ 1.19, so a reported quantile is within ~19% of the true value)
    spanning ``2**lo_exp`` .. ``2**hi_exp`` (defaults ~1µs .. 256s — the
    full range of a host span, from a disabled-check probe to a stuck
    drain), plus an underflow catch-all below and an overflow bucket
    above.  ~114 ints per span name: bounded memory regardless of traffic,
    and an ``observe`` is one bisect over a shared precomputed bound
    table — nothing measurable against the span's own clock reads.

    ``quantile(q)`` interpolates linearly inside the landing bucket, which
    keeps it monotone in ``q`` (bucket upper bounds are monotone and the
    within-bucket interpolation is monotone in rank).
    """

    __slots__ = ("_bounds", "counts", "count", "sum")

    _BOUND_CACHE: Dict[Tuple[int, int, int], Tuple[float, ...]] = {}

    def __init__(self, lo_exp: int = -20, hi_exp: int = 8, subdiv: int = 4):
        if hi_exp <= lo_exp:
            raise ValueError(f"hi_exp={hi_exp} must be > lo_exp={lo_exp}")
        if subdiv < 1:
            raise ValueError(f"subdiv={subdiv} must be >= 1")
        key = (int(lo_exp), int(hi_exp), int(subdiv))
        bounds = self._BOUND_CACHE.get(key)
        if bounds is None:
            n = (hi_exp - lo_exp) * subdiv
            bounds = tuple(2.0 ** (lo_exp + i / subdiv)
                           for i in range(n + 1))
            self._BOUND_CACHE[key] = bounds
        self._bounds = bounds      # finite upper bounds, ascending
        # counts[i] covers (bounds[i-1], bounds[i]]; counts[0] is the
        # underflow catch-all (-inf, bounds[0]]; the last is overflow
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self._bounds, v)] += 1
        self.count += 1
        self.sum += v

    def bounds(self) -> List[float]:
        """Upper bound of each bucket; the last is ``inf``."""
        return list(self._bounds) + [math.inf]

    def quantile(self, q: float) -> Optional[float]:
        """The ``q``-quantile (0..1) of observed durations, or ``None``
        when nothing was observed.  Monotone in ``q``; the overflow bucket
        reports its lower bound (the largest finite bound)."""
        if self.count == 0:
            return None
        q = min(max(float(q), 0.0), 1.0)
        rank = q * self.count
        seen = 0
        top = self._bounds[-1]
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i == len(self.counts) - 1:   # overflow: no finite upper
                    return top
                hi = self._bounds[i]
                lo = 0.0 if i == 0 else self._bounds[i - 1]
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return top   # pragma: no cover - rank <= count

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time copy for exporters: cumulative bucket counts per
        ``le`` bound (the Prometheus histogram contract), plus sum/count.
        Empty buckets are elided from the cumulative list (a conforming
        consumer only needs the populated bounds + the +Inf total) so one
        scrape does not pay ~114 lines per span name."""
        cum, acc = [], 0
        bounds = self.bounds()
        for i, c in enumerate(self.counts):
            if c:
                acc += c
                cum.append((bounds[i], acc))
        if not cum or cum[-1][0] != math.inf:
            cum.append((math.inf, acc))
        return {"buckets": cum, "count": self.count, "sum": self.sum}

    def __repr__(self):
        return (f"LogBucketHistogram(count={self.count}, "
                f"p50={self.quantile(0.5)}, p99={self.quantile(0.99)})")


# --------------------------------------------------------------------- rules

_OPS = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}

# the two supported shapes: "serve.tick p99 < 0.05" (span quantile) and
# "serve/queue_depth < 64" (gauge) — the metric token is whitespace-free
_RULE_RE = re.compile(
    r"^\s*(?P<metric>\S+)\s+(?:p(?P<q>\d+(?:\.\d+)?)\s+)?"
    r"(?P<op><=|>=|==|!=|<|>)\s*(?P<thr>[-+0-9.eE]+)\s*$")


@dataclasses.dataclass
class SloRule:
    """One declarative objective: ``metric OP threshold`` where the
    OBJECTIVE is the condition holding.  ``quantile`` set means ``metric``
    is a span name and the observed value is that quantile of its duration
    histogram; unset means ``metric`` is a monitor gauge name and the
    observed value is the gauge's latest sample.

    ``for_count``/``clear_count`` debounce the alert: the rule FIRES only
    after ``for_count`` consecutive violating evaluations and CLEARS only
    after ``clear_count`` consecutive satisfied ones — one noisy tick does
    not page anyone, and one lucky tick does not silence a real breach."""

    name: str
    metric: str
    op: str
    threshold: float
    quantile: Optional[float] = None     # None = gauge rule
    for_count: int = 1
    clear_count: int = 1

    def __post_init__(self):
        if any(c in self.name for c in ",{}\n"):
            # the firing state rides the flat monitor stream as
            # ``alert{rule=<name>}`` (export.py _split_labels): a comma or
            # brace in the name would break the label grammar and demote
            # the alert to an unrecognizable flat gauge — reject loudly
            # instead of silently losing the dstpu_alert family sample
            raise ValueError(f"rule name {self.name!r} must not contain "
                             "',', '{', '}' or newlines (it becomes the "
                             "dstpu_alert rule label)")
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {self.op!r} "
                             f"(one of {sorted(_OPS)})")
        if self.quantile is not None \
                and not 0.0 <= float(self.quantile) <= 1.0:
            raise ValueError(f"rule {self.name!r}: quantile="
                             f"{self.quantile} must be in [0, 1]")
        if self.for_count < 1 or self.clear_count < 1:
            raise ValueError(f"rule {self.name!r}: for_count/clear_count "
                             "must be >= 1")

    @classmethod
    def parse(cls, spec: str, name: Optional[str] = None,
              for_count: int = 1, clear_count: int = 1) -> "SloRule":
        """Build a rule from the compact spec the docs use:
        ``"serve.tick p99 < 0.05"`` (span quantile) or
        ``"serve/queue_depth < 64"`` (gauge)."""
        m = _RULE_RE.match(spec)
        if m is None:
            raise ValueError(
                f"unparseable SLO spec {spec!r} (want 'metric [pNN] OP "
                "threshold', e.g. 'serve.tick p99 < 0.05')")
        q = m.group("q")
        return cls(name=name or spec.strip(), metric=m.group("metric"),
                   op=m.group("op"), threshold=float(m.group("thr")),
                   quantile=float(q) / 100.0 if q is not None else None,
                   for_count=for_count, clear_count=clear_count)

    def ok(self, value: float) -> bool:
        return bool(_OPS[self.op](value, self.threshold))


class SloEvaluator:
    """Evaluates a rule set against a monitor (gauges) and tracer (span
    histograms), debouncing firing state per rule.  The owner drives
    :meth:`evaluate` at its own cadence (the serving engine: every working
    tick); reads (:meth:`firing`, :meth:`states`) are cheap snapshots."""

    def __init__(self, rules: List[SloRule]):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names in {names}")
        self.rules = list(rules)
        self._state: Dict[str, Dict[str, Any]] = {
            r.name: {"firing": False, "breaches": 0, "oks": 0,
                     "value": None} for r in self.rules}
        self.evaluations = 0
        self._warned_no_latest = False

    def _observe(self, rule: SloRule, monitor, tracer) -> Optional[float]:
        try:
            if rule.quantile is not None:
                if tracer is None:
                    return None
                return tracer.span_quantile(rule.metric, rule.quantile)
            if monitor is None:
                return None
            latest = getattr(monitor, "latest", None)
            return latest(rule.metric) if latest is not None else None
        except Exception:   # observation must never gate the loop
            return None

    def evaluate(self, monitor=None, tracer=None) -> Dict[str, bool]:
        """One evaluation round; returns rule name -> firing.  A rule whose
        metric has no data yet holds its current state (streaks frozen —
        absence of evidence neither fires nor clears)."""
        self.evaluations += 1
        if (not self._warned_no_latest and monitor is not None
                and getattr(monitor, "latest", None) is None
                and any(r.quantile is None for r in self.rules)):
            # gauge rules need a monitor with latest() (InMemoryMonitor);
            # csv/tensorboard/wandb backends have no read path — say so
            # ONCE instead of leaving the rules silently inert forever
            self._warned_no_latest = True
            from ..utils.logging import logger

            logger.warning(
                "SLO gauge rules %s can never fire: monitor %s has no "
                "latest() read path (use InMemoryMonitor, or span-"
                "quantile rules)",
                [r.name for r in self.rules if r.quantile is None],
                type(monitor).__name__)
        for rule in self.rules:
            st = self._state[rule.name]
            value = self._observe(rule, monitor, tracer)
            if value is None:
                continue
            st["value"] = float(value)
            if rule.ok(float(value)):
                st["oks"] += 1
                st["breaches"] = 0
                if st["firing"] and st["oks"] >= rule.clear_count:
                    st["firing"] = False
            else:
                st["breaches"] += 1
                st["oks"] = 0
                if not st["firing"] and st["breaches"] >= rule.for_count:
                    st["firing"] = True
        return {n: s["firing"] for n, s in self._state.items()}

    def firing(self) -> List[str]:
        """Names of currently-firing rules (stable rule order)."""
        return [r.name for r in self.rules
                if self._state[r.name]["firing"]]

    def states(self) -> Dict[str, Dict[str, Any]]:
        """Per-rule snapshot: last observed value, firing, streaks."""
        return {n: dict(s) for n, s in self._state.items()}

    def gauge_events(self, step: int) -> List[Tuple[str, float, int]]:
        """Monitor events carrying the firing states — named so the
        Prometheus exposition renders them as ``dstpu_alert{rule="..."}``
        (export.py owns the label rendering/escaping)."""
        return [(f"alert{{rule={r.name}}}",
                 1.0 if self._state[r.name]["firing"] else 0.0, step)
                for r in self.rules]
