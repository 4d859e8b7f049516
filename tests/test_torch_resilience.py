"""The port's hang watchdog and the training and checkpoint fault sites
(``deepspeed_tpu_torch/resilience``) against the JAX package's, on the CPU.

- ``HangWatchdog``: fires through ``on_hang`` with an all-thread stack
  report (and the flight recorder when tracing is on), stays quiet when the
  sections finish, and in a child process exits with ``RC_HANG`` (85)
  naming the hung section — the same report header as JAX's.
- The engine's watchdog (``resilience.watchdog``) catches a ``delay`` fault
  at ``train.step``, with the JAX engine's label.
- ``ckpt.save`` / ``ckpt.publish_latest`` / ``ckpt.load`` faults leave the
  same tag directories, the same ``latest`` and the same
  ``CheckpointIntegrityError`` as the JAX engine under the same rules
  (tiny CausalLM, fp32, seeded numpy batches).  The payload layouts
  differ (DCP against Orbax), so a tag is compared by its commit marker
  (``manifest.json`` present, ``.incomplete`` absent) and its verdict.

Everything is exact: the compared quantities are file names, tag strings,
exception types and report lines.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu.resilience as JR
import deepspeed_tpu_torch as ds
import deepspeed_tpu_torch.resilience as TR
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.parallel import mesh as mesh_mod
from deepspeed_tpu.resilience.watchdog import format_stack_report as jax_report
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.observability import configure_tracer, trace_span
from deepspeed_tpu_torch.resilience.watchdog import format_stack_report

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_injectors():
    TR.clear_injector()
    JR.clear_injector()
    yield
    TR.clear_injector()
    JR.clear_injector()


# ------------------------------------------------------------------ watchdog

def test_watchdog_fires_on_hang_with_stack_report():
    hangs = []
    wd = TR.HangWatchdog(timeout_s=0.2, on_hang=hangs.append, poll_s=0.02)
    try:
        with wd.armed("deliberate hang"):
            time.sleep(0.6)
    finally:
        wd.stop()
    assert wd.fired and len(hangs) == 1
    assert "deliberate hang" in hangs[0] and "hang-watchdog" in hangs[0]
    assert hangs[0].splitlines()[0] == \
        "HANG WATCHDOG: 'deliberate hang' exceeded 0.2s deadline"


def test_watchdog_quiet_when_sections_finish():
    wd = TR.HangWatchdog(timeout_s=5.0, on_hang=lambda r: None, poll_s=0.02)
    try:
        for i in range(3):
            with wd.armed(f"fast section {i}"):
                pass
    finally:
        wd.stop()
    assert not wd.fired


def test_format_stack_report_matches_jax_header():
    got, want = format_stack_report("label-x", 1.5), jax_report("label-x", 1.5)
    assert got.splitlines()[:2] == want.splitlines()[:2]
    assert "MainThread" in got and TR.RC_HANG == JR.watchdog.RC_HANG == 85


def test_watchdog_report_includes_flight_recorder_and_monitor():
    from deepspeed_tpu_torch.monitor import InMemoryMonitor

    tracer = configure_tracer(enabled=True, capacity=256)
    tracer.reset()
    hangs, mon = [], InMemoryMonitor()
    wd = TR.HangWatchdog(timeout_s=0.2, on_hang=hangs.append, poll_s=0.02, monitor=mon)
    try:
        with trace_span("warmup.step", step=41):
            pass
        with trace_span("poison.batch", step=42):
            with wd.armed("hung step 42"):
                with trace_span("poison.step"):
                    time.sleep(0.6)
    finally:
        wd.stop()
        configure_tracer(enabled=False)
        tracer.reset()
    (report,) = hangs
    assert "hung step 42" in report and "FLIGHT RECORDER DUMP" in report
    assert "warmup.step" in report and "poison.step" in report
    assert list(mon.reports) == [("watchdog/hang", report)]


def test_watchdog_exits_85_in_a_child():
    """The production path: no ``on_hang``, so the daemon thread exits the
    process with ``RC_HANG`` while the main thread is stuck; the report on
    stderr names the section."""
    code = textwrap.dedent("""
        import sys, time
        sys.path.insert(0, %r)
        from deepspeed_tpu_torch.resilience import HangWatchdog
        wd = HangWatchdog(timeout_s=0.5, poll_s=0.02)
        with wd.armed("child section 7"):
            time.sleep(30)
        sys.exit(0)
    """ % REPO)
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=60, env={**os.environ, "DS_ACCELERATOR": "cpu"})
    assert p.returncode == 85, p.stderr[-2000:]
    assert time.monotonic() - t0 < 25
    assert "HANG WATCHDOG: 'child section 7' exceeded 0.5s deadline" in p.stderr


def test_watchdog_config_block():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    cfg = DeepSpeedConfig({"train_batch_size": 2,
                           "resilience": {"watchdog": {"enabled": True, "timeout_s": 5}}})
    assert cfg.resilience.watchdog.enabled and cfg.resilience.watchdog.timeout_s == 5
    assert cfg.resilience.watchdog.exit_code == 85
    with pytest.raises(ValueError, match="timeout_s"):
        DeepSpeedConfig({"train_batch_size": 2,
                         "resilience": {"watchdog": {"enabled": True, "timeout_s": 0}}})


# ------------------------------------------------------------ engines, both

CFG = {"train_micro_batch_size_per_gpu": 8, "steps_per_print": 10 ** 9,
       "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}


def _batch(step):
    return {"input_ids": np.random.RandomState(step).randint(0, 256, (8, 16)
                                                             ).astype(np.int32)}


def _port(extra=None):
    eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32), device="cpu",
                            config={**CFG, **(extra or {})})
    return eng


def _jax(extra=None):
    mesh_mod.reset_mesh()
    mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout.from_world(1),
                                    devices=jax.devices()[:1])
    eng, *_ = deepspeed_tpu.initialize(model=JaxCausalLM("tiny", dtype=jnp.float32),
                                       mesh=mesh, config={**CFG, **(extra or {})})
    return eng


@pytest.fixture
def both():
    made = []

    def build(extra=None):
        pair = (("port", _port(extra), TR), ("jax", _jax(extra), JR))
        made.append(pair)
        return pair

    yield build
    mesh_mod.reset_mesh()


def test_engine_watchdog_catches_injected_step_hang(both):
    """A ``delay`` fault at ``train.step`` overruns the engine's watchdog;
    the report names the step as the JAX engine's does."""
    reports = {}
    for tag, eng, pkg in both({"resilience": {"watchdog": {"enabled": True,
                                                           "timeout_s": 600.0}}}):
        assert eng._watchdog is not None
        eng.train_batch(batch=_batch(0))
        hangs = []
        eng._watchdog.timeout_s, eng._watchdog.poll_s = 0.3, 0.02
        eng._watchdog.on_hang = hangs.append
        inj = pkg.install_injector(pkg.FaultInjector())
        inj.add(site=pkg.SITE_TRAIN_STEP, kind="delay", delay_s=0.9, at_call=1)
        try:
            eng.train_batch(batch=_batch(1))
        finally:
            eng._watchdog.stop()
            pkg.clear_injector()
        assert len(hangs) == 1, tag
        reports[tag] = hangs[0].splitlines()[0]
    assert reports["port"] == reports["jax"] == \
        "HANG WATCHDOG: 'train_batch step 2' exceeded 0.3s deadline"


def _layout(d):
    """Tag directories with their commit state, and the ``latest`` pointer."""
    out = {}
    for name in sorted(os.listdir(d)):
        p = os.path.join(d, name)
        if os.path.isdir(p):
            out[name] = (os.path.exists(os.path.join(p, "manifest.json")),
                         os.path.exists(os.path.join(p, ".incomplete")))
    latest = os.path.join(d, "latest")
    return out, (open(latest).read().strip() if os.path.exists(latest) else None)


def _run_faulted(eng, pkg, d, site, at_call=1, kind="raise", target=None):
    """Save at step 1, then under a fault at ``site`` train a step and save
    again; returns the raised exception type, or None."""
    eng.train_batch(batch=_batch(0))
    eng.save_checkpoint(d)
    inj = pkg.install_injector(pkg.FaultInjector())
    inj.add(site=site, kind=kind, at_call=at_call, target=target)
    eng.train_batch(batch=_batch(1))
    try:
        eng.save_checkpoint(d)
    except pkg.InjectedFault as e:
        return type(e).__name__
    finally:
        pkg.clear_injector()
    return None


@pytest.mark.parametrize("site", ["ckpt.save", "ckpt.publish_latest"])
def test_save_faults_leave_the_same_tags_and_latest(site, both, tmp_path):
    seen = {}
    for tag, eng, pkg in both():
        d = str(tmp_path / tag)
        err = _run_faulted(eng, pkg, d, site)
        layout = _layout(d)
        verdicts = {}
        for name in layout[0]:
            try:
                pkg.verify_checkpoint_dir(os.path.join(d, name))
                verdicts[name] = "ok"
            except pkg.CheckpointIntegrityError:
                verdicts[name] = "rejected"
        seen[tag] = (err, layout, verdicts)
        # recovery: a clean save commits and moves latest
        eng.save_checkpoint(d)
        assert _layout(d)[1] == "global_step2"
    assert seen["port"] == seen["jax"]
    err, (tags, latest), verdicts = seen["port"]
    assert err == "InjectedFault" and latest == "global_step1"
    if site == "ckpt.save":     # died before any write of the tag
        assert tags == {"global_step1": (True, False)}
    else:                       # committed, but latest never moved
        assert tags == {"global_step1": (True, False), "global_step2": (True, False)}
        assert verdicts == {"global_step1": "ok", "global_step2": "ok"}


def test_load_fault_corrupts_and_both_refuse(both, tmp_path):
    """A ``corrupt`` fault at ``ckpt.load`` flips bytes of the tag's
    client state before verification: both engines refuse the tag with
    ``CheckpointIntegrityError`` and leave the files to the fallback."""
    for tag, eng, pkg in both():
        d = str(tmp_path / tag)
        eng.train_batch(batch=_batch(0))
        eng.save_checkpoint(d)
        inj = pkg.install_injector(pkg.FaultInjector())
        inj.add(site=pkg.SITE_CKPT_LOAD, kind="corrupt", target="client_state.json",
                at_call=1)
        with pytest.raises(pkg.CheckpointIntegrityError):
            eng.load_checkpoint(d)
        assert [e["site"] for e in inj.log] == ["ckpt.load"], tag
        assert inj.log[0]["tag"] == "global_step1"
        pkg.clear_injector()
        assert _layout(d) == ({"global_step1": (True, False)}, "global_step1")


def test_async_commit_publish_fault_keeps_latest(tmp_path):
    """The background commit fires ``ckpt.publish_latest`` too: the fault
    surfaces at ``wait_for_checkpoint`` and ``latest`` stays put."""
    eng = _port({"checkpoint": {"async_save": True}})
    d = str(tmp_path)
    eng.train_batch(batch=_batch(0))
    eng.save_checkpoint(d)
    eng.wait_for_checkpoint()
    inj = TR.install_injector(TR.FaultInjector())
    inj.add(site=TR.SITE_LATEST_PUBLISH, kind="raise", at_call=1)
    eng.train_batch(batch=_batch(1))
    eng.save_checkpoint(d)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        eng.wait_for_checkpoint()
    assert _layout(d) == ({"global_step1": (True, False), "global_step2": (True, False)},
                          "global_step1")
    assert [e["site"] for e in inj.log] == ["ckpt.publish_latest"]


def test_wait_for_checkpoint_runs_inside_the_watchdog(tmp_path):
    eng = _port({"checkpoint": {"async_save": True},
                 "resilience": {"watchdog": {"enabled": True, "timeout_s": 60}}})
    labels = []
    armed = eng._watchdog.armed

    def spy(label, timeout_s=None):
        labels.append(label)
        return armed(label, timeout_s)

    eng._watchdog.armed = spy
    eng.train_batch(batch=_batch(0))
    eng.save_checkpoint(str(tmp_path))
    eng.wait_for_checkpoint()
    eng._watchdog.stop()
    assert labels == ["train_batch step 1", "async-checkpoint finalize"]
    assert _layout(str(tmp_path))[1] == "global_step1"


def test_train_step_site_fires_every_train_batch():
    eng = _port()
    inj = TR.install_injector(TR.FaultInjector())
    inj.add(site=TR.SITE_TRAIN_STEP, kind="raise", at_call=2)
    eng.train_batch(batch=_batch(0))
    with pytest.raises(TR.InjectedFault):
        eng.train_batch(batch=_batch(1))
    assert eng.global_steps == 1 and inj.log == [
        {"site": "train.step", "kind": "raise", "call": 2, "step": 2}]
