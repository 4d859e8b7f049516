"""Protocol history checker for the coordination-store protocols, on the
port's store (a copy of ``tools/store_check.py``, which imports the JAX
package; the verdicts are held equal to it in ``tests/test_torch_fleet_daemon.py``).

Two halves:

1. :class:`RecordingStore` -- a proxy over any ``CoordinationStore`` that
   logs every operation's invocation, arguments and result into a shared
   recorder.  The recorder's lock is held around the inner call, so the
   recorded completion order is itself a linearization of the history.
   ``handle(client)`` derives per-client views over one shared recorder.

2. :func:`check_history` -- replays a recorded history and checks the
   invariants every fleet and pod client assumes of the store: per-key CAS
   linearizability (a successful compare-and-swap or compare-and-delete
   whose ``expected`` differs from the replayed state), at most one
   coordinator per term, monotone generations, no journal resurrection (a
   ``fleet/requests/*`` create after its compare-delete without a
   ``clear_tombstone``), channel sequence numbers that advance, each
   channel item consumed once and each rid served once, and the replica
   adoption fence (an admitted ``pod/adopt/gen<g>/<victim>`` claim never
   carries a slab generation older than the victim's dead marker, one
   adopter per victim and round).

Wrap a fault proxy around the recording handle
(``FaultyStore(RecordingStore.handle(...))``) so rejected operations never
reach the recorder.

CLI::

    python -m tests._torch_store_check history.jsonl [--json]

exits 1 when any violation is found.
"""
from __future__ import annotations

import argparse
import json
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.elasticity.coordination import CoordinationStore

__all__ = ["RecordingStore", "HistoryVerdict", "check_history",
           "load_history", "main"]


def _snap(x: Any) -> Any:
    """JSON round-trip snapshot: store documents are JSON by contract,
    and callers mutate/reuse their dicts after the call returns — the
    history must keep the value AS WRITTEN."""
    if x is None:
        return None
    return json.loads(json.dumps(x))


class _Recorder:
    """Shared, ordered event log.  One recorder spans every client handle
    of one store — the lock both serializes the log and makes the
    recorded completion order a linearization of the history."""

    def __init__(self):
        self.lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []

    def add(self, **ev) -> None:
        ev["i"] = len(self.events)
        self.events.append(ev)


class RecordingStore(CoordinationStore):
    """Recording proxy over ``inner``: the full ``CoordinationStore``
    surface, each op logged to the shared recorder.  ``now()`` is not
    recorded (it is not a linearizable store operation — it is the
    injected clock)."""

    def __init__(self, inner: CoordinationStore, client: str = "client",
                 recorder: Optional[_Recorder] = None):
        self.inner = inner
        self.client = str(client)
        self.recorder = recorder if recorder is not None else _Recorder()

    def handle(self, client: str) -> "RecordingStore":
        """A per-client view sharing THIS store's recorder."""
        return RecordingStore(self.inner, client=client,
                              recorder=self.recorder)

    def _record(self, op: str, key: Optional[str], fn, **fields):
        with self.recorder.lock:
            err = None
            try:
                out = fn()
            except BaseException as e:
                err = e
            ev = {"client": self.client, "op": op, "key": key,
                  "t": self.inner.now(), **fields}
            if err is not None:
                ev["error"] = f"{type(err).__name__}: {err}"
                self.recorder.add(**ev)
                raise err
            if op == "get":
                ev["result"] = _snap(out)
            elif op in ("cas", "compare_delete"):
                ev["ok"] = bool(out)
            elif op == "list":
                ev["result"] = list(out)
            self.recorder.add(**ev)
            return out

    # ------------------------------------------------------- store surface

    def put(self, key: str, value: Dict) -> None:
        self._record("put", key, lambda: self.inner.put(key, value),
                     value=_snap(value))

    def get(self, key: str) -> Optional[Dict]:
        return self._record("get", key, lambda: self.inner.get(key))

    def compare_and_swap(self, key: str, expected: Optional[Dict],
                         new: Dict) -> bool:
        return self._record(
            "cas", key,
            lambda: self.inner.compare_and_swap(key, expected, new),
            expected=_snap(expected), new=_snap(new))

    def delete(self, key: str) -> bool:
        return self._record("delete", key, lambda: self.inner.delete(key))

    def compare_and_delete(self, key: str, expected: Dict) -> bool:
        return self._record(
            "compare_delete", key,
            lambda: self.inner.compare_and_delete(key, expected),
            expected=_snap(expected))

    def clear_tombstone(self, key: str) -> None:
        self._record("clear_tombstone", key,
                     lambda: self.inner.clear_tombstone(key))

    def list(self, prefix: str) -> List[str]:
        return self._record("list", None, lambda: self.inner.list(prefix),
                            prefix=prefix)

    def now(self) -> float:
        return self.inner.now()

    def __getattr__(self, name: str):
        # backend details (e.g. the file store's _path, corrupt_docs_total)
        # stay reachable through the proxy
        return getattr(self.inner, name)

    # -------------------------------------------------------------- history

    @property
    def events(self) -> List[Dict[str, Any]]:
        return self.recorder.events

    def save(self, path: str) -> int:
        """Write the history as JSONL (one op per line, recorded order).
        Returns the event count."""
        with open(path, "w") as f:
            for ev in self.recorder.events:
                f.write(json.dumps(ev) + "\n")
        return len(self.recorder.events)


# ------------------------------------------------------------------ checking

@dataclass
class HistoryVerdict:
    ok: bool
    violations: List[str] = field(default_factory=list)
    checked_events: int = 0
    counts: Dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"ok": self.ok, "violations": list(self.violations),
                "checked_events": self.checked_events,
                "counts": dict(self.counts)}


def _is_channel(key: str) -> bool:
    return key.startswith(("fleet/assign/", "fleet/results/",
                           "fleet/control/"))


def _summ(doc: Any) -> str:
    s = json.dumps(doc, sort_keys=True, default=str)
    return s if len(s) <= 120 else s[:117] + "..."


def check_history(events: List[Dict[str, Any]],
                  journal_prefix: str = "fleet/requests/",
                  results_prefix: str = "fleet/results/") -> HistoryVerdict:
    """Replay a recorded history (see module docstring for the invariant
    list) and return the verdict.  Failed/raised operations replay as
    no-ops — only what the store ADMITTED mutates the model."""
    violations: List[str] = []
    state: Dict[str, Any] = {}        # key -> replayed current document
    tombstoned: set = set()           # keys with a live GC tombstone
    leaders: Dict[Any, str] = {}      # (key, term) -> leader_id
    gens: Dict[str, int] = {}         # generation key -> last committed
    seqs: Dict[str, int] = {}         # channel key -> last appended seq
    consumed: Dict[Any, str] = {}     # (channel, seq) -> first consumer
    served: Dict[Any, int] = {}       # rid -> results-channel appends
    adopters: Dict[Any, str] = {}     # (gen, victim) -> first adopter
    counts = {"cas": 0, "consume": 0, "serve": 0, "adopt": 0}
    for ev in events:
        op = ev.get("op")
        key = ev.get("key")
        if ev.get("error") is not None:
            continue
        if op == "put":
            state[key] = ev.get("value")
            continue
        if op == "delete":
            # unconditional remove (delete-if-present; returns nothing)
            state.pop(key, None)
            continue
        if op == "clear_tombstone":
            tombstoned.discard(key)
            continue
        if op == "compare_delete":
            counts["cas"] += 1
            if not ev.get("ok"):
                continue
            cur = state.get(key)
            if cur != ev.get("expected"):
                violations.append(
                    f"stale compare-delete admitted on {key!r} (event "
                    f"{ev.get('i')}, client {ev.get('client')!r}): "
                    f"expected {_summ(ev.get('expected'))} but the "
                    f"linearized state was {_summ(cur)}")
            state.pop(key, None)
            tombstoned.add(key)
            continue
        if op != "cas":
            continue
        counts["cas"] += 1
        if not ev.get("ok"):
            continue
        exp, new = ev.get("expected"), ev.get("new")
        cur = state.get(key)
        if cur != exp:
            violations.append(
                f"stale CAS admitted on {key!r} (event {ev.get('i')}, "
                f"client {ev.get('client')!r}): expected "
                f"{_summ(exp)} but the linearized state was {_summ(cur)}")
        if exp is None and key.startswith(journal_prefix) \
                and key in tombstoned:
            violations.append(
                f"journal resurrection on {key!r} (event {ev.get('i')}, "
                f"client {ev.get('client')!r}): created after a "
                "compare-delete with no intervening clear_tombstone")
        state[key] = new
        if exp is None:
            tombstoned.discard(key)
        # ---- protocol-specific sub-checks on the admitted document
        if isinstance(new, dict) and "leader_id" in new and "term" in new:
            term = int(new["term"])
            first = leaders.setdefault((key, term), str(new["leader_id"]))
            if first != str(new["leader_id"]):
                violations.append(
                    f"two coordinators admitted in term {term} on "
                    f"{key!r}: {first!r} then {new['leader_id']!r} "
                    f"(event {ev.get('i')})")
        if isinstance(new, dict) and "generation" in new \
                and key.rsplit("/", 1)[-1] == "generation":
            g = int(new["generation"])
            last = gens.get(key)
            if last is not None and g <= last:
                violations.append(
                    f"generation went backwards on {key!r}: {last} -> {g} "
                    f"(event {ev.get('i')})")
            gens[key] = g
        if isinstance(new, dict) and _is_channel(key):
            exp_seq = int((exp or {}).get("seq") or 0)
            new_seq = int(new.get("seq") or 0)
            if new.get("consumer") is not None and not new.get("items"):
                # consume: the expected document's items were claimed
                counts["consume"] += 1
                for s, _payload in (exp or {}).get("items") or ():
                    who = consumed.get((key, int(s)))
                    if who is not None:
                        violations.append(
                            f"channel item ({key!r}, seq {int(s)}) "
                            f"consumed twice: by {who!r} then "
                            f"{ev.get('client')!r} (event {ev.get('i')})")
                    consumed[(key, int(s))] = str(ev.get("client"))
            else:
                # append: seq strictly increases per channel
                if new_seq <= max(exp_seq, seqs.get(key, 0)):
                    violations.append(
                        f"channel seq did not advance on {key!r}: "
                        f"{max(exp_seq, seqs.get(key, 0))} -> {new_seq} "
                        f"(event {ev.get('i')})")
                seqs[key] = max(new_seq, seqs.get(key, 0))
                if key.startswith(results_prefix):
                    for s, payload in new.get("items") or ():
                        if int(s) <= exp_seq:
                            continue   # carried over, not newly appended
                        rid = (payload or {}).get("rid")
                        served[rid] = served.get(rid, 0) + 1
                        counts["serve"] += 1
                        if served[rid] > 1:
                            violations.append(
                                f"duplicate serve: rid {rid!r} appended "
                                f"to a results channel {served[rid]} "
                                f"times (event {ev.get('i')} on {key!r})")
        # ---- replica-protocol rules (docs/POD.md "Live-state recovery"):
        # an admitted adoption claim pod/adopt/gen<g>/<victim> must carry a
        # slab generation >= the victim's dead-marker generation at this
        # point in the history (a pre-death incarnation's slab must never
        # be adopted), and each victim gets at most ONE adopter per round
        if isinstance(new, dict) and key.startswith("pod/adopt/"):
            counts["adopt"] += 1
            parts = key.split("/")
            genpart = parts[2] if len(parts) >= 4 else ""
            victim = str(new.get("victim") or parts[-1])
            marker = state.get(f"dead/{victim}") \
                or state.get(f"pod/dead/{victim}")
            if marker is not None and "slab_generation" in new \
                    and int(new["slab_generation"]) \
                    < int(marker.get("generation", 0)):
                violations.append(
                    f"adoption generation fence broken on {key!r} (event "
                    f"{ev.get('i')}, client {ev.get('client')!r}): slab "
                    f"generation {new['slab_generation']} predates the "
                    f"victim's dead-marker generation "
                    f"{marker.get('generation')}")
            first = adopters.setdefault((genpart, victim),
                                        str(new.get("adopter")))
            if first != str(new.get("adopter")):
                violations.append(
                    f"two adopters admitted for victim {victim!r} in "
                    f"round {genpart}: {first!r} then "
                    f"{new.get('adopter')!r} (event {ev.get('i')} on "
                    f"{key!r})")
    return HistoryVerdict(ok=not violations, violations=violations,
                          checked_events=len(events), counts=counts)


def load_history(path: str) -> List[Dict[str, Any]]:
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Check a recorded coordination-store op history "
                    "against the fleet protocol invariants")
    ap.add_argument("history", help="JSONL history (RecordingStore.save)")
    ap.add_argument("--json", action="store_true",
                    help="emit the verdict as JSON")
    args = ap.parse_args(argv)
    verdict = check_history(load_history(args.history))
    if args.json:
        print(json.dumps(verdict.to_dict(), indent=2))
    else:
        print(f"checked {verdict.checked_events} events "
              f"({verdict.counts.get('cas', 0)} CAS, "
              f"{verdict.counts.get('consume', 0)} consumes, "
              f"{verdict.counts.get('serve', 0)} serves): "
              f"{'OK' if verdict.ok else 'VIOLATIONS'}")
        for v in verdict.violations:
            print(f"  - {v}")
    return 0 if verdict.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
