"""Span duration histograms (counterpart of the ``LogBucketHistogram`` of
``deepspeed_tpu/observability/slo.py``, copied: framework-free).  The
tracer keeps one per span name, so quantiles survive the flight
recorder's eviction.  The SLO rules and their evaluator are not ported yet
(ROADMAP queue 1, item 12)."""
from __future__ import annotations

import bisect
import math
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["LogBucketHistogram"]


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
