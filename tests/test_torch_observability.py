"""The port's observability layer (``deepspeed_tpu_torch/observability``)
against the JAX package's, on the CPU.

- Exporters: the same span and counter records and monitor events give the
  same ``chrome_trace_events`` (the pid aside) and a byte-equal
  ``prometheus_text``; a live ``/metrics`` scrape passes the exposition
  grammar.
- SLO: the same specs parse to the same rules; the same gauge and span
  sequences give the same ``firing()`` / ``states()`` after every round.
- ``ProgramCatalog``: the same register / invoke / sync sequences give
  equal ``table()``, ``totals()`` and ``mfu()``.
- Paged serving (tiny, fp32, seeded numpy weights and requests): the same
  greedy stream gives the same program names and invocation counts, the
  same discrete ``serve/*`` gauges at every tick, the same alerts and the
  same ``health()`` keys as the JAX engine — plain, with the host tier and
  with speculative decoding.  The FLOP of a program differ by design (XLA
  counts elementwise work, the port's counter does not), so FLOP are held
  to the port's own counter.
- Trainer: ``train/tflops_est`` and ``train/mfu_est`` appear at the same
  steps as JAX's; with ``time.perf_counter`` replaced alike in both engine
  modules, each port value is its counted step FLOP over the wall EMA; the
  counted ``train_step`` equals the engine's own flops profiler at the
  same step, and lies within [0.90, 1.0] of JAX's lowered count with
  ``scan_layers`` off (JAX's analysis counts a scanned body once; XLA
  also counts elementwise work: 0.970 measured on ``tiny``).
- ``DeviceTraceCapture`` on ``torch.profiler``: annotations only inside the
  window, a written Chrome trace holding the window's spans, arming from the
  environment once per process.
- ``assemble_fleet_trace``: the same segment documents give the same
  assembled trace.

Tolerances: exact unless a line says otherwise (every compared quantity
is an integer count, a dict of floats computed by the same arithmetic, or
a rendered string).
"""
import dataclasses
import json
import math
import os
import re
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu.observability as JO
import deepspeed_tpu_torch as ds
import deepspeed_tpu_torch.observability as TO
from deepspeed_tpu.inference.serving import Request as JaxRequest
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.monitor import InMemoryMonitor as JaxMonitor
from deepspeed_tpu_torch.inference import Request
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.monitor import InMemoryMonitor
from deepspeed_tpu_torch.observability import device_profiler as dp
from deepspeed_tpu_torch.observability.flight_recorder import CounterEvent
from deepspeed_tpu_torch.observability.trace import Span

torch.set_num_threads(1)


# ------------------------------------------------------------- exporters

def _records(pkg):
    """The same spans and counters, built in ``pkg``'s record classes."""
    span_cls = pkg.trace.Span
    counter_cls = pkg.flight_recorder.CounterEvent
    out = []
    rng = np.random.default_rng(7)
    for i, name in enumerate(["serve.tick", "serve.decode", "serve.prefill",
                              "train.batch", "serve.tick", "serve.decode"]):
        sp = span_cls(name, 100.0 + i * 0.01, 11 + i % 2, f"worker-{i % 2}", i % 2,
                      None, {"tick": i, "rid": f"r{i}"} if i % 3 else None)
        sp.dur_s = float(rng.uniform(1e-4, 2e-2))
        if i == 4:
            sp.error = "InjectedFault"
        out.append(sp)
    out.append(counter_cls("serve.tokens", 100.05, 3.0, 11, None))
    open_span = span_cls("open.span", 101.0, 11, "worker-0", 0, None, None)
    out.append(open_span)   # still open: not rendered
    return out


def _strip_pid(events):
    return [{k: v for k, v in e.items() if k != "pid"} for e in events]


def test_chrome_trace_events_equal_jax():
    for name in (None, "engine0 (term=3)"):
        got = TO.chrome_trace_events(_records(TO), process_name=name)
        want = JO.chrome_trace_events(_records(JO), process_name=name)
        assert _strip_pid(got) == _strip_pid(want)
        assert {e["pid"] for e in got} == {os.getpid()}


def test_write_chrome_trace_round_trips(tmp_path):
    path = TO.write_chrome_trace(str(tmp_path / "t.json"), records=_records(TO),
                                 metadata={"run": "x"}, process_name="p")
    doc = json.loads(open(path).read())
    assert doc["otherData"] == {"run": "x"} and doc["displayTimeUnit"] == "ms"
    assert _strip_pid(doc["traceEvents"]) == _strip_pid(
        JO.chrome_trace_events(_records(JO), process_name="p"))


def _fed_tracer(pkg):
    # a small ring: its drops are counted
    tr = pkg.Tracer(enabled=True, recorder=pkg.FlightRecorder(capacity=4))
    for r in _records(pkg):
        if hasattr(r, "t0") and r.dur_s is not None:
            tr._record(r)
    return tr


EVENTS = [("serve/queue_depth", 3.0, 1), ("Train/Samples/train_loss", 0.25, 1),
          ("serve/program_flops{program=pre/fill_16}", 42.0, 1),
          ("alert{rule=serve.tick p99 < 0.05}", 1.0, 1),
          ('weird{label=has "quotes" and \\ backslash}', 7.0, 1),
          ("serve/queue_depth", 5.0, 2), ("9starts/with_digit", 1e-7, 2)]


def test_prometheus_text_byte_equal_to_jax():
    tm, jm = InMemoryMonitor(max_events=4), JaxMonitor(max_events=4)
    tm.write_events(EVENTS)
    jm.write_events(EVENTS)
    got = TO.prometheus_text(monitor=tm, tracer=_fed_tracer(TO))
    want = JO.prometheus_text(monitor=jm, tracer=_fed_tracer(JO))
    assert got == want
    assert "dstpu_monitor_dropped_events_total 3" in got
    # a duck-typed monitor without latest_map: the ring scan, the same text
    duck = types.SimpleNamespace(events=list(EVENTS))
    assert TO.prometheus_text(monitor=duck, tracer=TO.Tracer(enabled=True)) == \
        JO.prometheus_text(monitor=duck, tracer=JO.Tracer(enabled=True))


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>[^{}]*)\})? '
    r'(?P<value>[-+]?(?:[0-9.]+(?:[eE][-+]?[0-9]+)?|[Ii]nf|NaN))$')


def test_metrics_server_serves_the_exposition():
    """A live scrape over 127.0.0.1 on an ephemeral port: every sample line
    parses and every family carries HELP and TYPE."""
    mon = InMemoryMonitor()
    mon.write_events(EVENTS)
    srv = TO.start_metrics_server(port=0, monitor=mon, tracer=_fed_tracer(TO))
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=10).read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope", timeout=10)
    finally:
        srv.close()
    typed = {ln.split()[2] for ln in body.splitlines() if ln.startswith("# TYPE")}
    helped = {ln.split()[2] for ln in body.splitlines() if ln.startswith("# HELP")}
    for ln in body.splitlines():
        if ln and not ln.startswith("#"):
            m = _SAMPLE_RE.match(ln)
            assert m, ln
            base = re.sub(r"_(bucket|sum|count)$", "", m.group("name")) \
                if m.group("name").startswith("dstpu_span_duration") else m.group("name")
            assert base in typed and base in helped, ln
    assert 'dstpu_serve_program_flops{program="pre/fill_16"} 42' in body


def test_metrics_server_env_gating_and_port_fallback(monkeypatch):
    from deepspeed_tpu_torch.observability import export

    monkeypatch.setattr(export, "_METRICS_SERVER", None)
    monkeypatch.delenv(export.METRICS_PORT_ENV, raising=False)
    assert export.maybe_start_metrics_server() is None
    monkeypatch.setenv(export.METRICS_PORT_ENV, "nope")
    assert export.maybe_start_metrics_server() is None
    taken = TO.start_metrics_server(port=0)
    try:
        monkeypatch.setenv(export.METRICS_PORT_ENV, str(taken.port))
        monkeypatch.setenv(export.METRICS_HOST_ENV, "127.0.0.1")
        a, b = InMemoryMonitor(), InMemoryMonitor()
        srv = export.maybe_start_metrics_server(a)
        try:
            # the fixed port was taken: an ephemeral bind, advertised
            assert srv is not None and srv.port != taken.port
            assert export.maybe_start_metrics_server(b) is srv and srv.monitor is b
            assert export.get_metrics_server() is srv
        finally:
            srv.close()
    finally:
        taken.close()
        monkeypatch.setattr(export, "_METRICS_SERVER", None)


# ------------------------------------------------------------------- SLO

SPECS = ["serve.tick p99 < 0.05", "serve/queue_depth < 64", "serve/free_pages >= 2",
         "train.batch p50.5 <= 1e-3", "x/y != 3"]


def test_slo_rules_parse_alike():
    for spec in SPECS:
        got = TO.SloRule.parse(spec, for_count=2, clear_count=3)
        want = JO.SloRule.parse(spec, for_count=2, clear_count=3)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for bad, kw in (("nonsense", {}), ("a < 1", {"for_count": 0})):
        with pytest.raises(ValueError):
            TO.SloRule.parse(bad, **kw)
        with pytest.raises(ValueError):
            JO.SloRule.parse(bad, **kw)
    with pytest.raises(ValueError, match="rule label"):
        TO.SloRule(name="a,b", metric="m", op="<", threshold=1.0)
    with pytest.raises(ValueError, match="duplicate"):
        TO.SloEvaluator([TO.SloRule.parse("a < 1"), TO.SloRule.parse("a < 1")])


def test_slo_evaluator_sequences_equal_jax():
    """Gauge and span-quantile rules with debounce driven by the same
    metric sequence: the same firing() and states() after every round,
    including rounds where a metric has no data yet."""
    def rules(pkg):
        return [pkg.SloRule.parse("serve/queue_depth < 4", name="qd", for_count=2,
                                  clear_count=2),
                pkg.SloRule.parse("serve.tick p90 < 0.01", name="tick"),
                pkg.SloRule.parse("serve/free_pages >= 2", name="pages")]

    rng = np.random.default_rng(3)
    depth = [None, 1, 5, 6, 2, 7, 1, 1, 0, 9]
    ticks = rng.uniform(1e-3, 3e-2, len(depth))
    sides = []
    for pkg, mon in ((TO, InMemoryMonitor()), (JO, JaxMonitor())):
        ev, tr = pkg.SloEvaluator(rules(pkg)), pkg.Tracer(enabled=True)
        seq = []
        for i, (d, t) in enumerate(zip(depth, ticks)):
            if d is not None:
                mon.write_events([("serve/queue_depth", float(d), i)])
            if i >= 2:
                sp = pkg.trace.Span("serve.tick", float(i), 1, "t", 0, None, None)
                sp.dur_s = float(t)
                tr._record(sp)
            ev.evaluate(monitor=mon, tracer=tr)
            seq.append((ev.firing(), ev.states(), ev.gauge_events(i)))
        sides.append(seq)
    assert sides[0] == sides[1]
    assert any(f for f, _, _ in sides[0]) and sides[0][-1][1]["pages"]["value"] is None


# ------------------------------------------------------- program catalog

def _drive_catalog(pkg):
    cat = pkg.ProgramCatalog(sample_every=3)
    cat.register("decode", flops=1.5e9, bytes=3e6)
    cat.register("prefill_64", flops=7e9, bytes=1e7)
    stamps = []
    for i in range(7):
        stamps.append(cat.invoke("decode") is not None)
        if i % 3 == 2:
            cat.record_sync("decode", 0.002 + 1e-4 * i)
    stamps.append(cat.invoke("prefill_64", n=2) is not None)
    cat.invoke("draft_decode", n=4)   # invoked, never registered
    return cat, stamps


def test_program_catalog_equal_to_jax():
    (t, ts), (j, js) = _drive_catalog(TO), _drive_catalog(JO)
    assert ts == js and t.table() == j.table() and t.totals() == j.totals()
    assert t.mfu(1e12) == j.mfu(1e12) is None          # prefill unsampled
    t.record_sync("prefill_64", 0.01)
    j.record_sync("prefill_64", 0.01)
    t.record_sync("draft_decode", 0.001)
    j.record_sync("draft_decode", 0.001)
    assert t.mfu(1e12) == j.mfu(1e12) and t.mfu(1e12) > 0
    assert t.gauge_rows() == j.gauge_rows() and t.flops_of("nope") == 0.0
    with pytest.raises(ValueError):
        TO.ProgramCatalog(sample_every=-1)


def test_peak_flops_env(monkeypatch):
    from deepspeed_tpu_torch.observability.program_stats import peak_flops_per_sec

    monkeypatch.delenv("DS_TPU_PEAK_TFLOPS", raising=False)
    assert peak_flops_per_sec() is None
    for raw, want in (("989", 989e12), ("nope", None), ("-1", None)):
        monkeypatch.setenv("DS_TPU_PEAK_TFLOPS", raw)
        assert peak_flops_per_sec() == want


def test_register_call_counts_the_run_it_makes():
    """The cost of a program is its first run, counted: matmul FLOP exactly
    (2*M*K*N), an exception propagates with nothing registered, and
    ``account`` never runs a program twice."""
    from deepspeed_tpu_torch.observability.program_stats import account, finish_sample

    cat = TO.ProgramCatalog(sample_every=2)
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    runs = []

    def mm(x, y):
        runs.append(1)
        return x @ y

    out, t0 = account(cat, "mm", mm, (a, b))
    assert t0 is None and len(runs) == 1 and torch.equal(out, torch.full((4, 3), 8.0))
    row = cat.table()["mm"]
    assert row["flops"] == 2 * 4 * 8 * 3 and row["bytes"] > 0 and row["invocations"] == 1
    out, t0 = account(cat, "mm", mm, (a, b))
    assert t0 is not None and len(runs) == 2      # 2nd invocation: sampled
    finish_sample(cat, "mm", out, t0)
    assert cat.table()["mm"]["synced_samples"] == 1
    assert account(None, "mm", mm, (a, b))[1] is None and len(runs) == 3

    def boom():
        raise RuntimeError("kernel failed")

    with pytest.raises(RuntimeError, match="kernel failed"):
        account(cat, "boom", boom)
    assert not cat.known("boom")


# ------------------------------------------------------------ paged serving

SERVE = {"b_slots": 2, "page_size": 8, "max_model_len": 48}
DISCRETE = ("serve/queue_depth", "serve/active_slots", "serve/free_pages",
            "serve/prefix_hits_total", "serve/prefix_misses_total", "serve/shed_total",
            "serve/cow_copies_total", "serve/referenced_pages", "serve/pages_hwm",
            "serve/slot_occupancy")


@pytest.fixture(scope="module")
def engines():
    jmodel = JaxCausalLM("tiny", dtype=jnp.float32, attn_impl="xla")
    jparams = jmodel.init_fn(jax.random.PRNGKey(3))
    jeng = deepspeed_tpu.init_inference(model=jmodel, config={"dtype": "float32"},
                                        params=jparams)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    teng = ds.init_inference(CausalLM("tiny", dtype=torch.float32, attn_impl="xla"),
                             config={"dtype": "float32"}, params=tparams, device="cpu")
    return jeng, teng


def _prefix_stream(cls, n=9, seed=5, sys_len=19, tail=3, max_new=4):
    """Three shared system prompts (two full pages and a 3-token boundary
    page each, so later requests copy-on-write it) and random tails."""
    rng = np.random.default_rng(seed)
    systems = [rng.integers(1, 250, sys_len).astype(np.int32) for _ in range(3)]
    return [cls(rid=i, input_ids=np.concatenate(
        [systems[i % 3], rng.integers(1, 250, tail).astype(np.int32)]),
        max_new_tokens=max_new) for i in range(n)]


def _served(eng, cls, monitor, serve):
    m = TO if cls is Request else JO
    rules = [m.SloRule.parse("serve/queue_depth < 0", name="qd_floor"),
             m.SloRule.parse("serve/queue_depth < 1e9", name="qd_sane")]
    sv = eng.serving(**serve, monitor=monitor, slo_rules=rules)
    sv.run(_prefix_stream(cls))
    return sv


def _compare_serving(jeng, teng, serve=SERVE):
    tm, jm = InMemoryMonitor(max_events=100000), JaxMonitor(max_events=100000)
    tsv = _served(teng, Request, tm, serve)
    jsv = _served(jeng, JaxRequest, jm, serve)
    ts, js = tsv.program_stats(), jsv.program_stats()
    assert sorted(ts) == sorted(js)
    assert {k: v["invocations"] for k, v in ts.items()} == \
        {k: v["invocations"] for k, v in js.items()}
    for name in DISCRETE:
        assert tm.series(name) == jm.series(name), name
    for name in ("alert{rule=qd_floor}", "alert{rule=qd_sane}"):
        assert tm.series(name) == jm.series(name), name
    th, jh = tsv.health(), jsv.health()
    assert th["alerts"] == jh["alerts"] == ["qd_floor"]
    assert set(jh) <= set(th)
    assert th["program_stats"] == ts and th["metrics_port"] is None
    assert tsv.slo_states()["qd_floor"]["firing"] and not tsv.slo_states()["qd_sane"]["firing"]
    # every program's cost was counted once, on its first run (the CPU
    # decode runs eagerly, K4's plain version dispatched and counted); the
    # page copies move bytes and do no arithmetic
    assert all(v["bytes"] > 0 for v in ts.values()), ts
    assert all(v["flops"] > 0 for k, v in ts.items() if k == "decode"
               or k.startswith("prefill_")), ts
    assert all(v["flops"] == 0 for k, v in ts.items() if k == "cow"
               or k.startswith("tier_")), ts
    assert tm.latest("serve/program_flops{program=decode}") == ts["decode"]["flops_total"]
    for gauge in ("serve/kv_pool_bytes_total", "serve/kvq_enabled",
                  "serve/kvq_scale_bytes_total", "serve/kvq_page_bytes"):
        assert tm.latest(gauge) == jm.latest(gauge), gauge
    # the JAX engine runs on the 8 virtual devices of tests/conftest.py
    assert tm.latest("serve/mesh_devices") == 1.0
    assert len(tm.series("serve/ttft_s")) == len(jm.series("serve/ttft_s")) == 9
    return tsv, jsv, tm


def test_paged_serving_gauges_and_programs_equal_jax(engines):
    jeng, teng = engines
    tsv, jsv, tm = _compare_serving(jeng, teng)
    assert tsv.cow_copies == jsv.cow_copies > 0
    text = TO.prometheus_text(monitor=tm, tracer=TO.Tracer(enabled=True))
    assert 'dstpu_serve_program_flops{program="decode"}' in text
    assert 'dstpu_alert{rule="qd_floor"} 1' in text and "dstpu_serve_tokens_per_sec" in text


def test_paged_serving_with_host_tier_equal_jax(engines):
    jeng, teng = engines
    tsv, jsv, tm = _compare_serving(jeng, teng, {
        "b_slots": 1, "page_size": 8, "max_model_len": 40, "num_pages": 8,
        "host_tier_pages": 16})
    assert tsv.demotions == jsv.demotions > 0
    assert tm.series("serve/tier_demotions_total")
    assert tsv.program_stats()["tier_extract"]["invocations"] == 1 + tsv.demotions


def test_speculative_serving_programs_equal_jax(engines):
    from deepspeed_tpu.inference.speculative import SpeculativeConfig as JSpec
    from deepspeed_tpu.inference.speculative import layer_skip_draft as jskip
    from deepspeed_tpu_torch.inference.speculative import SpeculativeConfig, layer_skip_draft

    jeng, teng = engines
    jd = jskip(jeng._model, jeng.params, num_layers=1)
    td = layer_skip_draft(teng._model, teng.params, num_layers=1)
    tm, jm = InMemoryMonitor(), JaxMonitor()
    tsv = teng.serving(**SERVE, monitor=tm,
                       speculative=SpeculativeConfig(draft_model=td[0], draft_params=td[1],
                                                     k=2))
    jsv = jeng.serving(**SERVE, monitor=jm,
                       speculative=JSpec(draft_model=jd[0], draft_params=jd[1], k=2))
    tres = {r.rid: r.output_ids.tolist() for r in tsv.run(_prefix_stream(Request))}
    jres = {r.rid: np.asarray(r.output_ids).tolist()
            for r in jsv.run(_prefix_stream(JaxRequest))}
    assert tres == jres
    ts, js = tsv.program_stats(), jsv.program_stats()
    assert {k: v["invocations"] for k, v in ts.items()} == \
        {k: v["invocations"] for k, v in js.items()}
    assert ts["draft_decode"]["invocations"] == 2 * ts["verify"]["invocations"]
    for name in ("serve/spec_emitted_tokens_total", "serve/active_slots"):
        assert tm.series(name) == jm.series(name), name


def test_program_stats_sampling_and_watchdog_in_serving(engines):
    from deepspeed_tpu_torch.resilience import HangWatchdog

    _, teng = engines
    wd = HangWatchdog(timeout_s=120.0)
    sv = teng.serving(**SERVE, program_stats_sample_every=2, watchdog=wd)
    sv.run(_prefix_stream(Request))
    row = sv.program_stats()["decode"]
    # every 2nd invocation sampled (the 1st, the counted run, never is)
    assert row["synced_samples"] == row["invocations"] // 2 > 0
    assert row["device_seconds_est"] > 0 and row["achieved_flops_per_s"] > 0
    assert not wd.fired and wd._thread is not None
    wd.stop()


def test_plain_engine_counts_invocations_only(engines):
    """Without a monitor or sampling nothing reads a program's cost, so none
    is counted (a counted run pays the counter's host work on a request's
    time to first token): the JAX engine's names and invocation counts,
    every cost 0."""
    jeng, teng = engines
    tsv, jsv = teng.serving(**SERVE), jeng.serving(**SERVE)
    tsv.run(_prefix_stream(Request))
    jsv.run(_prefix_stream(JaxRequest))
    ts, js = tsv.program_stats(), jsv.program_stats()
    assert {k: v["invocations"] for k, v in ts.items()} == \
        {k: v["invocations"] for k, v in js.items()}
    assert all(v["flops"] == v["bytes"] == 0.0 for v in ts.values())
    assert not tsv._catalog.count_costs


def test_serving_health_reports_bound_metrics_port(engines, monkeypatch):
    from deepspeed_tpu_torch.observability import export

    _, teng = engines
    monkeypatch.setattr(export, "_METRICS_SERVER", None)
    monkeypatch.setenv(export.METRICS_PORT_ENV, "0")
    monkeypatch.setenv(export.METRICS_HOST_ENV, "127.0.0.1")
    mon = InMemoryMonitor()
    try:
        sv = teng.serving(**SERVE, monitor=mon)
        port = sv.health()["metrics_port"]
        assert port and port == export.get_metrics_server().port
        sv.run(_prefix_stream(Request, n=2))
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=10).read().decode()
        assert "dstpu_serve_tokens_per_sec" in body
        assert "dstpu_serve_kv_pool_bytes_total" in body
    finally:
        export.get_metrics_server().close()
        monkeypatch.setattr(export, "_METRICS_SERVER", None)


def test_update_params_writes_weight_gauges(engines):
    _, teng = engines
    mon = InMemoryMonitor()
    sv = teng.serving(**SERVE, monitor=mon)
    sv.update_params(teng.params)
    assert mon.latest("serve/weight_epoch") == 1.0
    assert mon.latest("serve/weight_updates_total") == 1.0
    assert mon.latest("serve/weight_refresh_s") >= 0.0


# ------------------------------------------------------------------ trainer

def _fake_time(stamps):
    it = iter(stamps)
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                    if not k.startswith("_")})
    fake.perf_counter = lambda: next(it)
    return fake


def _series(mon, name):
    return mon.series(name)


def test_trainer_gauges_match_jax(monkeypatch):
    """Both engines with a monitor and the same clock: the gauges appear at
    the same steps (from step 2, once an inter-step wall exists); the
    port's values are its counted step FLOP over the wall EMA."""
    import deepspeed_tpu.runtime.engine as jax_engine_mod
    import deepspeed_tpu_torch.runtime.engine as port_engine_mod

    monkeypatch.setenv("DS_TPU_PEAK_TFLOPS", "0.5")
    stamps = [10.0, 10.5, 11.25, 11.5, 12.75]
    monkeypatch.setattr(port_engine_mod, "time", _fake_time(stamps))
    monkeypatch.setattr(jax_engine_mod, "time", _fake_time(stamps))
    cfg = {"train_batch_size": 16, "optimizer": {"type": "adam", "params": {"lr": 1e-3}},
           "steps_per_print": 10 ** 9}
    jcfg = __import__("deepspeed_tpu.models.transformer", fromlist=["x"]).get_config(
        "tiny", dtype=jnp.float32, scan_layers=False)
    np_params = jax.tree_util.tree_map(
        np.asarray, __import__("deepspeed_tpu.models.transformer",
                               fromlist=["x"]).init_params(jcfg, jax.random.PRNGKey(0)))
    jeng, *_ = deepspeed_tpu.initialize(
        model=JaxCausalLM("tiny", dtype=jnp.float32, scan_layers=False), config=cfg,
        params=jax.tree_util.tree_map(jnp.asarray, np_params))
    teng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32), config=cfg,
                             device="cpu", params=params_from_jax(np_params, "cpu"))
    jeng.monitor, teng.monitor = JaxMonitor(), InMemoryMonitor()
    rs = np.random.RandomState(1)
    for _ in range(len(stamps)):
        batch = {"input_ids": rs.randint(0, 256, (16, 32)).astype(np.int32)}
        jeng.train_batch(batch=batch)
        teng.train_batch(batch=batch)
    tt, jt = _series(teng.monitor, "train/tflops_est"), _series(jeng.monitor,
                                                                "train/tflops_est")
    assert [s for s, _ in tt] == [s for s, _ in jt] == [2, 3, 4, 5]
    assert [s for s, _ in _series(teng.monitor, "train/mfu_est")] == [2, 3, 4, 5]
    flops = teng.program_catalog.flops_of("train_step")
    ema, want = None, []
    for a, b in zip(stamps, stamps[1:]):
        ema = (b - a) if ema is None else 0.8 * ema + 0.2 * (b - a)
        want.append(flops / ema / 1e12)
    assert [v for _, v in tt] == pytest.approx(want, rel=1e-12)
    assert [v for _, v in _series(teng.monitor, "train/mfu_est")] == \
        pytest.approx([w / 0.5 for w in want], rel=1e-12)
    jflops = jeng.program_catalog.flops_of("train_step")
    assert [v for _, v in jt] == pytest.approx([w * jflops / flops for w in want],
                                               rel=1e-12)
    assert teng.program_catalog.table()["train_step"]["invocations"] == len(stamps)
    # XLA counts the norms', softmax's and Adam's elementwise work too
    assert 0.90 <= flops / jflops <= 1.0, flops / jflops


def test_counted_step_equals_the_flops_profiler(tmp_path):
    """The step registered as ``train_step`` (counted at step 1 with a
    monitor) equals what the engine's flops profiler counts at its profile
    step on the same weights and batch; with both on the same step the
    profiler's count is reused, not counted twice."""
    cfg = {"train_batch_size": 4, "steps_per_print": 10 ** 9}
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (4, 64))}
    gen = torch.Generator().manual_seed(0)
    params = CausalLM("tiny", dtype=torch.float32).init_fn(gen)
    clone = lambda: {k: (v.clone() if torch.is_tensor(v) else   # noqa: E731
                         {kk: vv.clone() for kk, vv in v.items()}) for k, v in params.items()}
    a, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32), device="cpu",
                          config={**cfg, "flops_profiler": {
                              "enabled": True, "profile_step": 1,
                              "output_file": str(tmp_path / "p.txt")}}, params=clone())
    b, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32), device="cpu",
                          config=cfg, params=clone())
    b.monitor = InMemoryMonitor()
    a.train_batch(batch=batch)
    b.train_batch(batch=batch)
    assert a.program_catalog.flops_of("train_step") == 0.0      # no monitor
    assert b.program_catalog.flops_of("train_step") == a.flops_profiler.get_total_flops() > 0
    a.monitor = InMemoryMonitor()
    c, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32), device="cpu",
                          config={**cfg, "flops_profiler": {
                              "enabled": True, "profile_step": 1,
                              "output_file": str(tmp_path / "q.txt")}}, params=clone())
    c.monitor = InMemoryMonitor()
    c.train_batch(batch=batch)
    assert c.program_catalog.flops_of("train_step") == a.flops_profiler.get_total_flops()
    assert b.program_catalog.table()["train_step"]["bytes"] > 0


# ------------------------------------------------------ device-trace window

def test_device_capture_annotates_only_inside_the_window(tmp_path, monkeypatch):
    monkeypatch.setattr(dp, "_CAPTURE", None)
    TO.configure_tracer(enabled=False)
    with TO.trace_span("before.capture"):
        pass
    cap = dp.capture_device_trace(str(tmp_path / "tr"), n_units=2)
    assert cap is not None and cap.active and dp.device_capture_active()
    assert dp.capture_device_trace(str(tmp_path / "other")) is cap   # running wins
    with TO.trace_span("serve.decode"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert cap.annotations == 1
    TO.configure_tracer(enabled=True, capacity=64)
    try:
        with TO.trace_span("train.batch"):
            pass
    finally:
        TO.configure_tracer(enabled=False)
        TO.get_tracer().reset()
    assert cap.annotations == 2
    dp.device_trace_unit()
    assert cap.active
    dp.device_trace_unit()
    assert not cap.active and not dp.device_capture_active()
    with TO.trace_span("after.capture"):
        pass
    assert cap.annotations == 2
    doc = json.loads(open(cap.trace_path).read())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"serve.decode", "train.batch"} <= names
    assert not names & {"before.capture", "after.capture"}
    assert os.path.dirname(cap.trace_path) == str(tmp_path / "tr")
    monkeypatch.setattr(dp, "_CAPTURE", None)


def test_device_capture_env_arming_once_per_process(tmp_path, monkeypatch):
    monkeypatch.setattr(dp, "_CAPTURE", None)
    monkeypatch.setattr(dp, "_ENV_ARMED", False)
    monkeypatch.setenv(dp.DEVICE_TRACE_ENV, str(tmp_path / "env"))
    monkeypatch.setenv(dp.DEVICE_TRACE_UNITS_ENV, "1")
    cap = dp.maybe_capture_from_env()
    try:
        assert cap is not None and cap.active and cap.remaining == 1
        assert dp.maybe_capture_from_env() is None      # once per process
    finally:
        assert dp.stop_device_trace() == str(tmp_path / "env")
        monkeypatch.setattr(dp, "_CAPTURE", None)
    assert os.listdir(tmp_path / "env")
    monkeypatch.setattr(dp, "_ENV_ARMED", False)
    monkeypatch.delenv(dp.DEVICE_TRACE_ENV)
    assert dp.maybe_capture_from_env() is None
    with pytest.raises(ValueError):
        dp.capture_device_trace()
    with pytest.raises(ValueError):
        dp.DeviceTraceCapture(str(tmp_path), n_units=0)


def test_train_batch_counts_down_the_window(tmp_path, monkeypatch):
    """``train_batch`` is one unit of the window and runs under a
    ``train.batch`` span, annotated while the window is open."""
    monkeypatch.setattr(dp, "_CAPTURE", None)
    eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32), device="cpu",
                            config={"train_batch_size": 2, "steps_per_print": 10 ** 9})
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 32))}
    cap = dp.capture_device_trace(str(tmp_path), n_units=2)
    eng.train_batch(batch=batch)
    assert cap.active and cap.annotations == 2      # train.batch, train.step
    eng.train_batch(batch=batch)
    assert not cap.active
    doc = json.loads(open(cap.trace_path).read())
    batches = [e for e in doc["traceEvents"] if e.get("name") == "train.batch"]
    assert len(batches) == 2
    monkeypatch.setattr(dp, "_CAPTURE", None)


# -------------------------------------------------------- trace assembly

def _segments():
    rng = np.random.default_rng(11)
    segs = {}
    for k, owner in enumerate(["router0", "engine1", "engine0"]):
        spans = []
        for i in range(4):
            spans.append({"name": ["fleet.route", "serve.prefill", "serve.decode"][i % 3],
                          "t0": 50.0 + k + 0.01 * i, "dur": float(rng.uniform(0, 0.01)),
                          "tid": 100 + i % 2, "thread": f"t{i % 2}", "depth": 0,
                          "tags": {"trace_id": "abc" if i % 2 else "def", "rid": i},
                          "error": "InjectedFault" if i == 3 else None})
        segs[owner] = {"owner_id": owner, "spans": spans, "dropped": k,
                       "attrs": {"term": 3} if owner == "router0" else {},
                       "anchor": ({"epoch": 1.7e9 + k, "mono": 40.0}
                                  if owner != "engine0" else None)}
    return segs


def test_assemble_fleet_trace_equal_jax(tmp_path):
    from deepspeed_tpu.observability import trace_assembly as JA
    from deepspeed_tpu_torch.observability import trace_assembly as TA

    got = TA.assemble_fleet_trace(_segments(), out_path=str(tmp_path / "a.json"))
    want = JA.assemble_fleet_trace(_segments())
    got["otherData"].pop("assembler")
    want["otherData"].pop("assembler")
    assert got == want
    assert json.loads(open(tmp_path / "a.json").read())["traceEvents"] == got["traceEvents"]
    assert TA.events_for_trace(got, "abc") == JA.events_for_trace(want, "abc")
    assert TA.clock_offsets(_segments()) == JA.clock_offsets(_segments())
    sp = Span("serve.tick", 1.0, 3, "main", 0, None, {"slot_rids": {"0": "a"}, "o": object()})
    sp.dur_s = 0.5
    rec = TA.span_record(sp)
    assert rec["tags"]["slot_rids"] == {"0": "a"} and isinstance(rec["tags"]["o"], str)
    # the publisher and the loader work on a coordination store
    from deepspeed_tpu.elasticity.coordination import FileCoordinationStore as JStore
    from deepspeed_tpu_torch.elasticity.coordination import FileCoordinationStore
    from deepspeed_tpu_torch.observability.trace import Tracer

    tracer = Tracer(enabled=True)
    with tracer.span("fleet.route", rid=1):
        pass
    store = FileCoordinationStore(str(tmp_path / "coord"))
    assert TA.TraceSegmentPublisher(store, "x").publish(tracer, force=True) == 1
    assert TA.load_segments(store) == JA.load_segments(JStore(str(tmp_path / "coord")))
    assert TA.load_segments(store)["x"]["spans"][0]["tags"] == {"rid": 1}


def test_counter_event_renders_like_jax():
    from deepspeed_tpu.observability.flight_recorder import CounterEvent as JC

    got = TO.chrome_trace_events([CounterEvent("c", 1.5, 2.0, 7, None)])
    want = JO.chrome_trace_events([JC("c", 1.5, 2.0, 7, None)])
    assert _strip_pid(got) == _strip_pid(want) and math.isclose(got[0]["ts"], 1.5e6)
