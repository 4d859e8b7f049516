"""Serving supervisor: warm restarts with exact in-flight replay
(counterpart of ``deepspeed_tpu/inference/serving_supervisor.py``).

:class:`ServingSupervisor` owns an engine built by a caller-supplied factory
and drives the same ``run``/``submit``/``health``/``drain`` surface; when a
tick fails it

1. harvests every result that finished before the crash;
2. releases the dead engine's device half (its CUDA graphs and pools) and
   builds a replacement: a fresh KV pool and freshly captured graphs (a
   captured graph is bound to its pool's and buffers' addresses, so graphs
   are recaptured, never carried; ``restart_log`` records the captures);
   demoted host-tier pages, the weight epoch and the counters carry over;
3. replays in-flight requests by re-prefilling ``prompt + tokens generated
   so far`` with the remaining budget: greedy continuations are
   token-exact, and sampled ones too (counter-based lanes);
4. re-queues everything still waiting (shedding suspended during replay).

A fault mid-``drain()`` warm-restarts and finishes the replayed in-flight
requests; only never-served requests are handed back.  Slot-attributable
prefill failures (``SlotPrefillError``) with a live pool do not restart.
``ServeTimeout`` and ``KeyboardInterrupt`` are never treated as faults.
The restart budget is absolute (``max_restarts``); exhausting it raises
:class:`RestartBudgetExhausted`.  Every restart fires the
``serve.replay`` fault site per replayed request, and dumps the flight
recorder (``last_flight_dump``) when tracing is on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..observability.trace import dump_window_s, flight_dump, trace_span
from ..resilience.fault_injection import SITE_SERVE_REPLAY, maybe_fire
from ..utils.logging import log_dist, logger
from .serving import (Request, RequestResult, ServeTimeout, ServingEngine,
                      SlotPrefillError)

__all__ = ["RestartBudgetExhausted", "ServingSupervisor"]


class RestartBudgetExhausted(RuntimeError):
    """The supervisor spent ``max_restarts`` warm restarts without reaching
    a healthy engine — the fault is not transient.  ``diagnosis`` and
    ``restart_log`` describe the terminal state."""

    def __init__(self, diagnosis: str, restart_log: List[Dict]):
        super().__init__(diagnosis)
        self.diagnosis = diagnosis
        self.restart_log = restart_log


class ServingSupervisor:
    """Run a :class:`ServingEngine` under a warm-restart loop.

    ``engine_factory() -> ServingEngine`` builds a fresh engine (fresh KV
    pool) — use ``InferenceEngine.supervised_serving(...)`` to get a
    supervisor whose factory shares the inference engine's model/params.
    """

    def __init__(self, engine_factory: Callable[[], ServingEngine],
                 max_restarts: int = 5, monitor=None):
        self.engine_factory = engine_factory
        self.max_restarts = int(max_restarts)
        self.engine = engine_factory()
        self.monitor = monitor if monitor is not None else self.engine.monitor
        self.restarts = 0
        self.restart_log: List[Dict] = []
        # counters harvested from dead incarnations — a restart must not
        # zero the *_total numbers (health/bench/soak read them through
        # the supervisor)
        self._shed_base = 0
        self._deadline_base = 0
        self._probe_base = 0
        self._unfence_base = 0
        self._prefix_hits_base = 0
        self._prefix_misses_base = 0
        self._prefix_tokens_base = 0
        self._prefix_pages_base = 0
        self._prefix_evictions_base = 0
        self._cow_base = 0
        self._sampled_base = 0
        self._adapter_admissions_base = 0
        self._spec_ticks_base = 0
        self._spec_emitted_base = 0
        self._spec_drafted_base = 0
        self._demotions_base = 0
        self._promotions_base = 0
        self._weight_updates_base = 0
        self._kv_flushed_pages_base = 0
        self._kv_flushed_slabs_base = 0
        self._demoted_hwm_base = 0
        self._pages_hwm_base = 0
        self._quarantined_slots_lifetime = 0
        self._quarantined_pages_lifetime = 0
        # mid-drain fault recovery: waiting requests stashed for hand-back
        # (never re-served) + a flag that the replacement engine still owes
        # the replayed in-flight requests a run to completion
        self._drain_stash: List[Request] = []
        self._drain_finish_pending = False
        # rid -> original request (result stitching + drain hand-off)
        self._orig: Dict[Any, Request] = {}
        # rid -> tokens decoded in previous engine incarnations; replay
        # outputs are prefixed with these when results are stitched
        self._prefix: Dict[Any, List[int]] = {}
        # rid -> lifecycle events from previous incarnations (each replay
        # appends a ("replay", t, new_incarnation) marker); stitched in
        # front of the finishing incarnation's record exactly like tokens
        self._lifecycle: Dict[Any, List] = {}
        # rid -> number of in-flight replays (stamped on stitched results)
        self._replay_count: Dict[Any, int] = {}
        self._collected: Dict[Any, RequestResult] = {}
        self._order: List[Any] = []
        # flight-recorder dump captured at the most recent warm restart
        # (None until a restart happens, or when tracing is disabled) —
        # the post-mortem for "what was the engine doing when it died"
        self.last_flight_dump: Optional[str] = None

    # ----------------------------------------------------------- submission

    def submit(self, request: Request) -> Any:
        ids = np.asarray(request.input_ids, np.int32).reshape(-1)
        request = dataclasses.replace(request, input_ids=ids)
        rid = self.engine.submit(request)
        self._orig[rid] = request
        return rid

    # ------------------------------------------------------------- the loop

    def run(self, requests: Optional[List[Request]] = None,
            max_ticks: Optional[int] = None) -> List[RequestResult]:
        """Serve to completion under the restart loop; returns stitched
        results in completion order (completion order is per-incarnation —
        results harvested across a restart keep their original order)."""
        for req in requests or []:
            self.submit(req)
        if self._drain_stash:
            # a drain abandoned mid-recovery (its ServeTimeout propagated
            # before the hand-back) left never-served requests stashed;
            # run()'s contract is completion, so it serves them instead of
            # orphaning them with no terminal result
            stash, self._drain_stash = self._drain_stash, []
            for req in stash:
                self.engine.submit(req)
        budget = max_ticks       # spent across ALL continuations/restarts —
        resume = False           # a repeating fault cannot stretch the bound
        while True:
            eng = self.engine
            start_tick = eng._tick
            try:
                finished = eng.run([], max_ticks=budget, resume=resume)
            except KeyboardInterrupt:
                raise
            except ServeTimeout:
                raise            # a tick budget is a caller bound, not a fault
            except SlotPrefillError as e:
                budget = self._spend(budget, eng, start_tick)
                if eng.pool_alive():
                    # the engine already unwound the reservation, re-queued
                    # the request, and counted the failure toward slot
                    # quarantine — keep serving on the same pool.  resume:
                    # the continued run must NOT re-anchor arrival/deadline
                    # clocks mid-stream.
                    logger.warning("serve supervisor: continuing past %s", e)
                    resume = True
                    continue
                self._safe_restart(e)
                resume = False   # fresh engine: clocks re-anchor (documented)
                continue
            except Exception as e:
                budget = self._spend(budget, eng, start_tick)
                self._safe_restart(e)
                resume = False
                continue
            for res in finished:
                self._collect(res)
            # a successful run finished every queued replay, so a later
            # drain() has no mid-drain recovery left to resume
            self._drain_finish_pending = False
            order, self._order = self._order, []
            return [self._collected.pop(rid) for rid in order]

    @staticmethod
    def _spend(budget: Optional[int], eng: ServingEngine,
               start_tick: int) -> Optional[int]:
        if budget is None:
            return None
        budget -= eng._tick - start_tick
        if budget <= 0:
            raise ServeTimeout(
                "serve loop exceeded the caller's max_ticks budget across "
                "fault continuations")
        return budget

    def drain(self, max_ticks: Optional[int] = None) -> List[Request]:
        """Stop admission and finish in-flight work; returns the ORIGINAL
        request objects that were never served, for hand-off.

        A fault mid-drain warm-restarts and FINISHES the replayed in-flight
        requests on the replacement engine — drain's contract is "finish
        in-flight work", so partial progress is preserved and the stitched
        results (already-generated tokens + the replayed continuation) stay
        token-exact and claimable via :meth:`take_results`.  Only requests
        that were still WAITING at the fault are handed back unserved
        (``max_ticks`` bounds each recovery phase, like each drain
        attempt)."""
        resume = False
        while True:
            try:
                if self._drain_finish_pending:
                    # the mid-drain restart replayed in-flight work onto
                    # the replacement engine (waiting requests sit in the
                    # stash): run it to completion before closing admission.
                    # run() CLAIMS its finished results — collect them here
                    # or the stitched in-flight outputs are lost.
                    for res in self.engine.run([], max_ticks=max_ticks,
                                               resume=resume):
                        self._collect(res)
                    self._drain_finish_pending = False
                    resume = False
                unserved = self.engine.drain(max_ticks=max_ticks)
            except KeyboardInterrupt:
                raise
            except ServeTimeout:
                raise
            except SlotPrefillError as e:
                if self.engine.pool_alive():
                    # the engine unwound and re-queued it — keep going on
                    # the same pool (mirrors run(); resume keeps the
                    # continued clock un-re-anchored)
                    logger.warning("serve supervisor: continuing drain "
                                   "past %s", e)
                    resume = True
                    continue
                self._safe_restart(e, drain=True)
                resume = False
                continue
            except Exception as e:
                self._safe_restart(e, drain=True)
                resume = False
                continue
            for res in self.engine.take_results():
                self._collect(res)
            # hand back the ORIGINAL requests and release their tracking —
            # the hand-off target owns them now.  Stashed requests (waiting
            # at a mid-drain fault) follow the engine's unserved queue in
            # admission order.
            stash, self._drain_stash = self._drain_stash, []
            handed = [self._orig.pop(r.rid, r) for r in unserved]
            handed.extend(self._orig.pop(r.rid, r) for r in stash)
            for r in handed:
                self._prefix.pop(r.rid, None)
                self._replay_count.pop(r.rid, None)
                self._lifecycle.pop(r.rid, None)
            return handed

    def take_results(self) -> List[RequestResult]:
        """Claim stitched results collected so far (completion order)."""
        for res in self.engine.take_results():
            self._collect(res)
        order, self._order = self._order, []
        return [self._collected.pop(rid) for rid in order]

    def inflight_progress(self) -> Dict[Any, List[int]]:
        """rid -> every token generated so far (across incarnations) for
        each request this supervisor still owes a terminal result: tokens
        carried from dead incarnations (``_prefix``) plus the live slot's
        own tokens.  Queued in-flight-origin replays report their carried
        tokens alone.  This is the host-side stream state a fleet router
        journals (``inference/fleet.py``) so a REPLACEMENT engine can
        re-prefill ``prompt + journaled`` and resume decoding after the
        last durable token instead of re-decoding the whole stream."""
        out: Dict[Any, List[int]] = {rid: [int(t) for t in toks]
                                     for rid, toks in self._prefix.items()}
        for st in self.engine._slots:
            if st is not None:
                rid = st.request.rid
                out[rid] = out.get(rid, []) + [int(t) for t in st.tokens]
        return out

    def health(self) -> Dict[str, Any]:
        """Engine health snapshot plus supervisor restart counters.  The
        ``*_total`` counters are cumulative across restarts (a fresh engine
        starts at zero; the supervisor carries the dead incarnations'
        counts); ``quarantined_slots``/``quarantined_pages`` stay the
        CURRENT engine's capacity view, with ``*_lifetime`` variants
        accumulating across incarnations."""
        h = self.engine.health()
        h["shed_total"] += self._shed_base
        h["deadline_expired_total"] += self._deadline_base
        h["probes_total"] += self._probe_base
        h["unfenced_total"] += self._unfence_base
        h["prefix_hits_total"] += self._prefix_hits_base
        h["prefix_misses_total"] += self._prefix_misses_base
        h["prefix_shared_tokens_total"] += self._prefix_tokens_base
        h["prefix_pages_shared_total"] += self._prefix_pages_base
        h["prefix_evictions_total"] += self._prefix_evictions_base
        h["cow_copies_total"] += self._cow_base
        h["sampled_admissions_total"] += self._sampled_base
        h["adapter_admissions_total"] += self._adapter_admissions_base
        h["spec_verify_slot_ticks_total"] += self._spec_ticks_base
        h["spec_emitted_tokens_total"] += self._spec_emitted_base
        h["spec_drafted_tokens_total"] += self._spec_drafted_base
        if h["spec_verify_slot_ticks_total"]:
            h["spec_mean_accepted_len"] = round(
                h["spec_emitted_tokens_total"]
                / h["spec_verify_slot_ticks_total"], 4)
        h["demotions_total"] += self._demotions_base
        h["promotions_total"] += self._promotions_base
        h["weight_updates_total"] += self._weight_updates_base
        h["kv_flushed_pages_total"] += self._kv_flushed_pages_base
        h["kv_flushed_slabs_total"] += self._kv_flushed_slabs_base
        h["demoted_pages_hwm"] = max(h["demoted_pages_hwm"],
                                     self._demoted_hwm_base)
        h["pages_hwm"] = max(h["pages_hwm"], self._pages_hwm_base)
        h["quarantined_slots_lifetime"] = (self._quarantined_slots_lifetime
                                           + h["quarantined_slots"])
        h["quarantined_pages_lifetime"] = (self._quarantined_pages_lifetime
                                           + h["quarantined_pages"])
        h["restarts"] = self.restarts
        h["max_restarts"] = self.max_restarts
        h["last_restart_cause"] = (self.restart_log[-1]["cause"]
                                   if self.restart_log else None)
        return h

    # -------------------------------------------------------- warm restart

    def _collect(self, res: RequestResult) -> None:
        prefix = self._prefix.pop(res.rid, None)
        orig = self._orig.pop(res.rid, None)
        replays = self._replay_count.pop(res.rid, 0)
        lifecycle = self._lifecycle.pop(res.rid, None)
        if prefix:
            # a replayed request: its engine-side prompt was orig + prefix
            # and its output is the continuation — stitch the caller-facing
            # result back to the original request's frame.  decode_ticks
            # accumulates across incarnations: each of the `replays` dead
            # incarnations produced its first prefix token via prefill, the
            # rest via decode ticks — so a stitched result that kept
            # decoding keeps  decode_ticks == len(output_ids) - 1 - replays
            # (a replay terminated before its re-prefill contributes no new
            # prefill token and sits one above that line).
            res = dataclasses.replace(
                res,
                input_ids=orig.input_ids if orig is not None
                else res.input_ids[:len(res.input_ids) - len(prefix)],
                output_ids=np.concatenate(
                    [np.asarray(prefix, np.int32), res.output_ids]),
                decode_ticks=res.decode_ticks + len(prefix) - replays,
                replays=replays)
        elif replays:
            res = dataclasses.replace(res, replays=replays)
        if lifecycle:
            # dead incarnations' events (queued/admit/prefill/... plus the
            # replay markers) lead; the finishing incarnation's record
            # follows — one end-to-end lifecycle per request
            res = dataclasses.replace(res,
                                      lifecycle=lifecycle + res.lifecycle)
        self._collected[res.rid] = res
        self._order.append(res.rid)

    def _safe_restart(self, cause: BaseException, drain: bool = False) -> None:
        """Restart until one succeeds; the budget check inside ``_restart``
        bounds the loop (restart-path faults, e.g. an injected
        ``serve.replay`` raise, count a restart and are retried).
        ``drain=True`` stashes waiting requests for hand-back instead of
        re-queueing them (mid-``drain()`` recovery)."""
        while True:
            try:
                self._restart(cause, drain=drain)
                return
            except KeyboardInterrupt:
                raise
            except RestartBudgetExhausted:
                raise
            except Exception as e:
                logger.warning("serve supervisor: restart itself failed "
                               "(%s: %s); retrying", type(e).__name__, e)
                cause = e

    def _restart(self, cause: BaseException, drain: bool = False) -> None:
        # post-mortem FIRST, before any state is touched: the flight
        # recorder still holds the failed attempt's spans (the poisoned
        # tick's serve.tick/serve.decode carry the exception type) plus
        # whatever is still open.  Ships via monitor.write_report and stays
        # readable on last_flight_dump; None when tracing is disabled.
        # Guarded: a dump failure (e.g. a rid whose repr raises) must never
        # abort the warm restart it is documenting.
        try:
            self.last_flight_dump = flight_dump(
                f"serve.restart {type(cause).__name__}", monitor=self.monitor,
                last_s=dump_window_s())
        except Exception as e:
            self.last_flight_dump = None
            logger.warning("serve supervisor: flight dump failed (%s: %s)",
                           type(e).__name__, e)
        if self.restarts >= self.max_restarts:
            raise RestartBudgetExhausted(
                f"serving restart budget exhausted ({self.max_restarts}); "
                f"last cause: {type(cause).__name__}: {cause} — the fault "
                "is not transient (poisoned params, a fault rule with "
                "unlimited fires, or broken storage); inspect restart_log",
                self.restart_log)
        self.restarts += 1
        old = self.engine
        with trace_span("serve.restart", restart=self.restarts,
                        cause=type(cause).__name__):
            self._restart_body(cause, old, drain=drain)

    def _restart_body(self, cause: BaseException, old: ServingEngine,
                      drain: bool = False) -> None:
        # (1) harvest everything that finished before the crash
        for res in old.take_results():
            self._collect(res)
        # (2) snapshot host-side stream state.  In-flight slots replay in
        # admission order (they were ahead of the queue in FIFO order);
        # queued requests follow with arrival_time rebased to 0 — they had
        # ALREADY arrived, and the new engine would otherwise re-gate them
        # behind their full original offset; not-yet-due pending requests
        # keep their remaining offset.  Deadlines carry their REMAINING
        # budget (deadline_s is measured from arrival, and the rebased
        # arrival restarts on the new engine's clock — without the
        # deduction every restart would silently hand the request a fresh
        # full deadline window).
        inflight = sorted((st for st in old._slots if st is not None),
                          key=lambda st: st.admit_s)
        elapsed = time.monotonic() - old._t0
        waiting = [self._rebase(r, elapsed, old._t0) for r in old._queue]
        # pending requests whose arrival offset already elapsed (the crash
        # beat the _admit that would have promoted them) have ARRIVED just
        # like the queue — rebase them too so their epoch survives; only
        # genuinely future arrivals keep their remaining offset
        waiting.extend(
            self._rebase(r, elapsed, old._t0) if r.arrival_time <= elapsed
            else dataclasses.replace(r, arrival_time=r.arrival_time - elapsed)
            for r in old._pending)
        # (3) the replay fault site fires BEFORE any state is mutated, so a
        # raise here leaves the dead engine intact for the retried restart
        for st in inflight:
            maybe_fire(SITE_SERVE_REPLAY, rid=st.request.rid,
                       generated=len(st.tokens))
        # (4) fresh pool and graphs.  The dead engine's device half (its
        # graphs, its pools) is released first, so the replacement's pool
        # never sits beside it; its host state (queue, tokens, host tier)
        # stays readable.  The observed-service-time EMA rides along so
        # the first retry_after_s hints reflect reality.
        self._release(old)
        new = self.engine_factory()
        # incarnation stamp (docs/OBSERVABILITY.md "Distributed tracing"):
        # lifecycle events carry it, so a stitched record shows which
        # incarnation served each phase of a replayed stream
        new.engine_incarnation = old.engine_incarnation + 1
        reused = self._adopt_programs(new, old)
        # weight-epoch carry (docs/HYBRID.md): a factory whose captured
        # params predate live update_params() calls would replay under
        # RETIRED weights — re-publish the dead engine's live view at ITS
        # epoch (a fresh engine caches nothing, so this is a pure
        # zero-recompile swap).  Must land BEFORE the host-tier carry:
        # adopt_demoted refuses a cross-epoch donor.
        self._carry_weight_epoch(new, old)
        # demoted prefix pages live in HOST buffers — they survive the dead
        # pool (even a consumed one) and carry to the replacement when the
        # fleet shape matches, so promotions keep hitting after a restart
        tier_carried = new.adopt_host_tier(old) if reused else 0
        if old._ema_service_s is not None and new._ema_service_s is None:
            new._ema_service_s = old._ema_service_s
        # (5) replay.  Admission control is suspended: a request the old
        # engine already accepted must never be shed by its own recovery.
        saved_max_queue, new.max_queue = new.max_queue, None
        try:
            replayed = []
            for st in inflight:
                req = st.request
                replay = dataclasses.replace(
                    self._rebase(req, elapsed, old._t0),
                    input_ids=np.concatenate(
                        [req.input_ids, np.asarray(st.tokens, np.int32)]),
                    max_new_tokens=req.max_new_tokens - len(st.tokens))
                with trace_span("serve.replay", rid=req.rid,
                                generated=len(st.tokens)):
                    new.submit(replay)
                replayed.append((req.rid, list(st.tokens),
                                 list(st.lifecycle)))
            if drain:
                # mid-drain recovery: never-served waiting requests are
                # handed back, not re-served — stash them.  But a QUEUED
                # request that carries replay state is an in-flight-origin
                # replay from an EARLIER mid-drain restart (re-queued by a
                # prefill unwind, or still waiting for a slot): its prompt
                # embeds tokens generated before that restart, and drain's
                # contract says those are never thrown away — it goes back
                # on the replacement engine to finish.
                stashed = 0
                for req in waiting:
                    if req.rid in self._prefix:
                        new.submit(req)
                    else:
                        self._drain_stash.append(req)
                        stashed += 1
                self._drain_finish_pending = True
            else:
                stashed = 0
                for req in waiting:
                    new.submit(req)
        finally:
            new.max_queue = saved_max_queue
        # (6) commit: prefixes only once every submission landed, so a
        # failed restart never double-counts replay tokens
        replay_t = time.monotonic()
        for rid, tokens, lc in replayed:
            self._prefix[rid] = self._prefix.get(rid, []) + tokens
            self._replay_count[rid] = self._replay_count.get(rid, 0) + 1
            # lifecycle carry: the dead incarnation's events plus a replay
            # marker stamped with the REPLACEMENT's incarnation (the
            # engine-side events that follow carry the same number)
            self._lifecycle[rid] = (
                self._lifecycle.get(rid, []) + lc
                + [("replay", replay_t, new.engine_incarnation)])
        for req in waiting:
            # a waiting request's only event so far is its queued stamp —
            # carry it so the stitched record keeps the TRUE first-queued
            # time (re-submission on the replacement stamps another)
            lc = old._lifecycle_pending.get(req.rid)
            if lc:
                self._lifecycle[req.rid] = (self._lifecycle.get(req.rid, [])
                                            + list(lc))
        self._carry_counters(old)
        self.engine = new
        entry = {
            "restart": self.restarts,
            "cause": f"{type(cause).__name__}: {cause}",
            "replayed_inflight": len(replayed),
            # in drain mode never-served waiting requests are STASHED for
            # hand-back; queued in-flight-origin replays still re-queue
            "requeued": len(waiting) - stashed,
            "stashed": stashed,
            "mid_drain": drain,
            # HBM index entries lost with the dead pool; replay re-publishes
            # organically through the normal admission path.  Demoted
            # entries (host buffers) carried to the replacement instead.
            "prefix_entries_dropped": ((len(old._prefix)
                                        if old._prefix is not None else 0)
                                       - tier_carried),
            "host_tier_entries_carried": tier_carried,
            # nothing compiled is reused: the CUDA graphs are bound to the
            # dead pools' addresses, so the replacement recaptured its own
            "programs_reused": False,
            "shape_matched": reused,
            "graph_captures_after_restart": new.program_inventory()["captures"],
            "at_tick": old._tick,
        }
        self.restart_log.append(entry)
        if self.monitor is not None:
            self.monitor.write_events([
                ("serve/restarts", float(self.restarts), old._tick)])
        log_dist(
            f"serve supervisor: warm restart {self.restarts}/"
            f"{self.max_restarts} after {entry['cause']} — replayed "
            f"{len(replayed)} in-flight, re-queued {len(waiting) - stashed}, "
            f"stashed {stashed}, graphs recaptured "
            f"({entry['graph_captures_after_restart']})", ranks=[0])

    def _carry_counters(self, old: ServingEngine) -> None:
        """Fold a retiring incarnation's counters into the bases so the
        supervisor-level ``*_total`` numbers stay cumulative."""
        self._shed_base += old.shed_count
        self._deadline_base += old.deadline_count
        self._probe_base += old.probe_count
        self._unfence_base += old.unfence_count
        self._prefix_hits_base += old.prefix_hits
        self._prefix_misses_base += old.prefix_misses
        self._prefix_tokens_base += old.prefix_shared_tokens
        self._prefix_pages_base += old.prefix_pages_shared
        self._prefix_evictions_base += (old._prefix.evictions
                                        if old._prefix is not None else 0)
        self._cow_base += old.cow_copies
        self._sampled_base += old.sampled_admissions
        self._adapter_admissions_base += old.adapter_admissions
        if old._spec is not None:
            self._spec_ticks_base += old._spec.verify_slot_ticks
            self._spec_emitted_base += old._spec.emitted_tokens
            self._spec_drafted_base += old._spec.drafted_tokens
        self._demotions_base += old.demotions
        self._promotions_base += old.promotions
        self._weight_updates_base += old.weight_updates
        self._kv_flushed_pages_base += old.kv_flushed_pages
        self._kv_flushed_slabs_base += old.kv_flushed_slabs
        self._demoted_hwm_base = max(self._demoted_hwm_base,
                                     old._demoted_hwm)
        self._pages_hwm_base = max(self._pages_hwm_base, old._pages_hwm)
        self._quarantined_slots_lifetime += int(old._quarantined.sum())
        self._quarantined_pages_lifetime += len(old._quarantined_pages)

    # ----------------------------------------------------- rolling restart

    def recycle(self) -> bool:
        """Rolling-restart hand-off (``FleetRouter.rolling_restart``):
        replace a DRAINED/idle engine with a fresh one — fresh KV pool,
        adopted compiled programs, counters carried — WITHOUT spending the
        restart budget.  This is maintenance, not fault recovery: the
        budget exists to bound *fault* loops, and a planned recycle must
        not eat into it.  Refuses while work is queued or in flight (drain
        first — recycling would throw live KV state away); returns whether
        the compiled programs were reused."""
        old = self.engine
        if (old._active.any() or old._queue or old._pending
                or self._drain_finish_pending):
            raise RuntimeError(
                "recycle() needs a drained engine: "
                f"{int(old._active.sum())} slot(s) active, "
                f"{len(old._queue) + len(old._pending)} request(s) waiting "
                "— call drain() first")
        for res in old.take_results():
            self._collect(res)
        self._release(old)
        new = self.engine_factory()
        new.engine_incarnation = old.engine_incarnation + 1
        reused = self._adopt_programs(new, old)
        # live weights + epoch carry exactly as on a fault restart
        self._carry_weight_epoch(new, old)
        # planned maintenance keeps the warm host cache too: demoted pages
        # carry exactly as on a fault restart (docs/SERVING.md)
        tier_carried = new.adopt_host_tier(old) if reused else 0
        if old._ema_service_s is not None and new._ema_service_s is None:
            new._ema_service_s = old._ema_service_s
        self._carry_counters(old)
        self.engine = new
        log_dist(f"serve supervisor: engine recycled (graphs recaptured, "
                 f"{tier_carried} host-tier page(s) carried)", ranks=[0])
        return reused

    @staticmethod
    def _release(old: ServingEngine) -> None:
        """Free a retiring engine's device half (graphs and pools).  A
        device error that already broke the engine must not stop its
        replacement, so a failing release is logged and passed."""
        try:
            old.close()
        except Exception as e:   # the card may hold a sticky error
            logger.warning("serve supervisor: releasing the dead engine "
                           "failed (%s: %s)", type(e).__name__, e)

    @staticmethod
    def _carry_weight_epoch(new: ServingEngine, old: ServingEngine) -> None:
        """Replacement engines must serve the SAME weight epoch the dead
        one did (docs/HYBRID.md): a rollout-style factory already builds at
        the published params + epoch (no-op here); a plain factory whose
        closure captured pre-update params gets the dead engine's live view
        re-published at the dead engine's epoch — replay then decodes under
        the exact weights the interrupted stream started with.  Weights the
        dead engine owned (its own copy since its first swap) pass to the
        replacement as they are, not copied."""
        if old.weight_epoch > new.weight_epoch:
            new.update_params(old.params, epoch=old.weight_epoch,
                              adopt=old._exec.owns_params)
        if old.fused_adapter_id is not None:
            # the live tensors hold the fused view: keep its admission rule
            # and the base copies that fuse_adapter(None) restores
            new.fused_adapter_id = old.fused_adapter_id
            new._base_copy = old._base_copy

    @staticmethod
    def _rebase(req: Request, elapsed: float, t0: float) -> Request:
        """An already-arrived request re-anchored to the new engine's
        clock: arrival becomes 0, and a deadline keeps only its remaining
        budget (floored at an epsilon so an already-expired request still
        flows through the normal expiry path to a terminal result).  The
        ORIGINAL arrival is preserved as ``arrival_epoch_s`` so queued-age
        gauges, ``arrival_s``/``ttft_s`` stamps and retry hints keep
        referencing the true arrival rather than the replacement engine's
        reset clock (docs/SERVING.md)."""
        deadline = req.deadline_s
        if deadline is not None:
            deadline = max(1e-6, deadline
                           - max(0.0, elapsed - req.arrival_time))
        epoch = req.arrival_epoch_s
        if epoch is None:
            epoch = t0 + max(0.0, req.arrival_time)
        return dataclasses.replace(req, arrival_time=0.0,
                                   deadline_s=deadline,
                                   arrival_epoch_s=epoch)

    @staticmethod
    def _adopt_programs(new: ServingEngine, old: ServingEngine) -> bool:
        """Whether the replacement has the dead engine's shape (model, slots,
        page geometry, storage dtype, mesh): then the host tier carries and
        the prefill bucket records are adopted.  A CUDA graph is bound to
        the addresses of the pool and buffers it captured, so the port does
        not hand the dead engine's graphs on: the replacement captured its
        own at build (its decode step, plus the draft step and the verify
        block under speculation)."""
        if (new.model is old.model
                and new.b_slots == old.b_slots
                and new.page_size == old.page_size
                and new.num_pages == old.num_pages
                and new.max_model_len == old.max_model_len
                and new.kv_dtype == old.kv_dtype
                and new.mesh == old.mesh):
            new._exec.adopt_programs(old._exec)
            if new._spec is not None and new._spec.compatible(old._spec):
                new._spec.adopt_programs(old._spec)
            return True
        return False
