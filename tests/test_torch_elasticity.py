"""The port's elasticity (``deepspeed_tpu_torch/elasticity``) against the JAX
package's, and its own contracts.

Held against ``deepspeed_tpu`` on the same inputs: the elastic plans
(``valid_device_counts``, ``plan_elastic_batch``, ``pick_micro_batch``,
``compute_elastic_config``) over a grid of blocks and worlds, the config's
batch triads and its refusals (the same messages), ``ds_elastic``'s output
line for line, and the supervisor's backoff schedule for one seed.  A tiny
``CausalLM`` preempted at step 3 by a real SIGTERM (the ``train.step``
fault site's ``sigterm`` kind), saved, and resumed in a fresh engine
equals the port's uninterrupted run bit for bit and the JAX engine's
uninterrupted fp64 trajectory at 5e-6 (``tests/unit/test_golden_parity.py``'s
tolerance; the JAX engine keeps fp32 masters).

The port's own: quarantine of a corrupted newest tag and the fallback one
generation, the one retry of a transient load error, pruning, the progress
signal, and the supervisor's relaunch, interrupt, budget, exception,
breaker, terminal-code, stand-down, fault-site and flight-dump cases
(backoffs at 0, no wall-clock asserts).  Multi-process runs through the
launcher are in ``tests/test_torch_launcher.py``.
"""
import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.elasticity import elasticity as jel
from deepspeed_tpu.elasticity import supervisor as jsup
from deepspeed_tpu.elasticity.__main__ import main as jax_ds_elastic
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import mesh as mesh_mod
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config import ElasticityConfig as JaxElasticityConfig

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.elasticity import (RC_PREEMPTED, ElasticAgent, PreemptionGuard,
                                            Supervisor, SupervisorStandDown)
from deepspeed_tpu_torch.elasticity import elasticity as tel
from deepspeed_tpu_torch.elasticity.__main__ import main as port_ds_elastic
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.resilience import (FaultInjector, FaultRule, checkpoint_progress_fn,
                                            clear_injector, install_injector)
from deepspeed_tpu_torch.resilience.fault_injection import corrupt_file
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as PortConfig
from deepspeed_tpu_torch.runtime.config import ElasticityConfig as PortElasticityConfig
from deepspeed_tpu_torch.runtime.config_utils import config_from_dict
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path, tree_map

from ._torch_ranks import make_batches

torch.set_num_threads(1)

GOLDEN_TOL = dict(rtol=5e-6, atol=5e-6)
# the final weights against the JAX engine, whose masters are fp32: Adam
# divides each gradient by its own running magnitude, so an element whose
# gradient sits at the level of fp32 noise moves by a noise-dependent share
# of the step (tests/test_torch_training.py's rule): at most 0.1% of a
# leaf's elements may miss GOLDEN_TOL, every element within 1e-4
PARAM_TOL_EVERY = dict(rtol=5e-6, atol=1e-4)
PARAM_OFF_SHARE = 1e-3


def _outcome(fn, *args, **kw):
    """``("ok", value)`` or ``("raised", class name, message)``: both
    packages must agree on either."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:
        return ("raised", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# The plans
# ---------------------------------------------------------------------------

COUNT_CASES = [(24, [2, 4], 1, None), (24, [2, 4], 3, 6), (10, [3], 1, None),
               (4, [1], 1, 4), (2000, [2, 4, 6], 1, 10000), (36, [0, 4, 9], 2, 18)]


@pytest.mark.parametrize("case", COUNT_CASES, ids=str)
def test_valid_device_counts_match_jax(case):
    assert tel.valid_device_counts(*case) == jel.valid_device_counts(*case)


PLAN_CASES = [([2, 4, 6], 2000, 1, 10000, True), ([2, 4, 6], 2000, 1, 10000, False),
              ([1], 4, 1, 4, True), ([1, 2], 4, 1, 2, True), ([3, 5], 60, 2, 12, True),
              ([8], 512, 8, 64, True), ([2, 3], 17, 1, None, False), ([2], 16, 1, None, True),
              ([32], 16, 1, None, True), ([], 16, 1, None, True), ([0, 2], 8, 1, None, True),
              ([4], 16, 5, 7, True)]


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_elastic_batch_matches_jax(case):
    got = _outcome(tel.plan_elastic_batch, *case)
    assert got == _outcome(jel.plan_elastic_batch, *case)


PICK_CASES = [(24, [2, 4], 3, True), (24, [2, 4], 4, True), (24, [2, 4], 4, False),
              (24, [2, 4], 5, True), (8, [3], 2, True), (16, [2, 4], 2, False)]


@pytest.mark.parametrize("case", PICK_CASES, ids=str)
def test_pick_micro_batch_matches_jax(case):
    assert _outcome(tel.pick_micro_batch, *case) == _outcome(jel.pick_micro_batch, *case)


BLOCKS = {
    "default": {"enabled": True},
    "card": {"enabled": True, "max_train_batch_size": 4, "micro_batch_sizes": [1],
             "min_gpus": 1, "max_gpus": 4},
    "zero2": {"enabled": True, "max_train_batch_size": 4, "micro_batch_sizes": [1, 2],
              "min_gpus": 1, "max_gpus": 2},
    "wide": {"enabled": True, "max_train_batch_size": 512, "micro_batch_sizes": [2, 4],
             "max_gpus": 64},
    "smaller": {"enabled": True, "max_train_batch_size": 96, "micro_batch_sizes": [2, 3],
                "min_gpus": 2, "max_gpus": 12, "prefer_larger_batch": False},
    "v02": {"enabled": True, "max_train_batch_size": 256, "micro_batch_sizes": [2, 4],
            "min_gpus": 8, "max_gpus": 64, "version": 0.2, "num_gpus_per_node": 8,
            "model_parallel_size": 2},
    "v02-bad-node": {"enabled": True, "version": 0.2, "num_gpus_per_node": 6,
                     "model_parallel_size": 4},
    "bad-range": {"enabled": True, "min_gpus": 8, "max_gpus": 4},
    "disabled": {"enabled": False},
}
WORLDS = [0, 1, 2, 3, 4, 8]


def _plan(pkg, block, world):
    if pkg == "jax":
        return _outcome(jel.compute_elastic_config, JaxElasticityConfig(**block), world,
                        block.get("num_gpus_per_node", 1), block.get("model_parallel_size", 1))
    return _outcome(tel.compute_elastic_config, config_from_dict(PortElasticityConfig, block),
                    world, block.get("num_gpus_per_node", 1),
                    block.get("model_parallel_size", 1))


def _as_tuple(outcome):
    if outcome[0] == "ok":
        return ("ok", dataclasses.astuple(outcome[1]))
    return outcome


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(BLOCKS))
def test_compute_elastic_config_matches_jax(name, world):
    assert _as_tuple(_plan("port", BLOCKS[name], world)) == \
        _as_tuple(_plan("jax", BLOCKS[name], world))


def _triad(cls, cfg, world):
    def build():
        c = cls(cfg, dp_world_size=world)
        return (c.train_batch_size, c.train_micro_batch_size_per_gpu,
                c.gradient_accumulation_steps)
    got = _outcome(build)
    # the two packages' error classes share names, not identity
    return got if got[0] == "ok" else ("raised", got[2])


TRIAD_CONFIGS = {
    "plan": {"elasticity": BLOCKS["card"]},
    "wide": {"elasticity": BLOCKS["wide"]},
    "zero2": {"elasticity": BLOCKS["zero2"], "zero_optimization": {"stage": 2}},
    "conflict": {"elasticity": BLOCKS["wide"], "train_batch_size": 64},
    "conflict-two": {"elasticity": BLOCKS["card"], "train_micro_batch_size_per_gpu": 1,
                     "gradient_accumulation_steps": 4},
    "ignored": {"elasticity": {**BLOCKS["card"], "ignore_non_elastic_batch_info": True},
                "train_batch_size": 64},
    "off": {"elasticity": BLOCKS["disabled"], "train_batch_size": 8},
}


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(TRIAD_CONFIGS))
def test_config_triad_matches_jax(name, world):
    cfg = TRIAD_CONFIGS[name]
    assert _triad(PortConfig, cfg, world) == _triad(JaxConfig, cfg, world)


@pytest.mark.parametrize("snapshot", [
    {"max_train_batch_size": 4, "micro_batch_sizes": [1]},
    {"max_train_batch_size": 8},
    {"micro_batch_sizes": [1, 2]},
    {"version": 0.2},
], ids=["same", "batch", "micro", "version"])
def test_immutable_envelope_guard_matches_jax(snapshot, monkeypatch):
    monkeypatch.setenv("DEEPSPEED_ELASTICITY_CONFIG", json.dumps(snapshot))
    cfg = TRIAD_CONFIGS["plan"]
    got, want = _triad(PortConfig, cfg, 1), _triad(JaxConfig, cfg, 1)
    assert got == want
    assert (got[0] == "ok") == (snapshot == {"max_train_batch_size": 4,
                                             "micro_batch_sizes": [1]})


def test_elasticity_block_no_longer_refused():
    """The engine takes its triad from the plan at its data-parallel world."""
    eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32),
                            config={"elasticity": BLOCKS["card"]}, device="cpu")
    assert (eng.train_batch_size, eng.micro_batch_size, eng.gas) == (4, 1, 4)
    assert eng.config.elastic_plan.valid_device_counts == (1, 2, 4)


ELASTIC_CLI = [("wide", 0), ("wide", 8), ("wide", 3), ("card", 2), ("v02", 16),
               ("disabled", 0), ("bad-range", 0), ("missing", 0)]


@pytest.mark.parametrize("case", ELASTIC_CLI, ids=lambda c: f"{c[0]}-w{c[1]}")
def test_ds_elastic_output_matches_jax(case, tmp_path, capsys):
    name, world = case
    path = tmp_path / "ds_config.json"
    if name != "missing":
        path.write_text(json.dumps({"elasticity": BLOCKS[name]}))
    argv = ["-c", str(path), "-w", str(world)]
    rc_port = port_ds_elastic(argv)
    port_out = capsys.readouterr().out
    rc_jax = jax_ds_elastic(argv)
    jax_out = capsys.readouterr().out
    assert (rc_port, port_out) == (rc_jax, jax_out)
    assert port_out


# ---------------------------------------------------------------------------
# Preempted and resumed, against JAX's uninterrupted fp64 trajectory
# ---------------------------------------------------------------------------

STEPS, PREEMPT_AT = 6, 3
RESUME_CONFIG = {
    "elasticity": {"enabled": True, "max_train_batch_size": 4, "micro_batch_sizes": [2],
                   "min_gpus": 1, "max_gpus": 2},
    "optimizer": {"type": "adamw", "params": {"lr": 2e-3, "weight_decay": 0.01}},
    "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
}


@pytest.fixture(scope="module")
def golden():
    params_np = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jtf.get_config("tiny"), jax.random.PRNGKey(11)))
    batches = make_batches(STEPS, 4, seed=12)
    jax.config.update("jax_enable_x64", True)
    try:
        mesh_mod.reset_mesh()
        mesh = mesh_mod.initialize_mesh(mesh_mod.MeshLayout(dp=1), devices=jax.devices()[:1])
        model = JaxCausalLM(dataclasses.replace(jtf.get_config("tiny"), dtype=jnp.float64))
        eng, *_ = deepspeed_tpu.initialize(
            model=model, config=RESUME_CONFIG,
            params=jax.tree_util.tree_map(jnp.asarray, params_np), mesh=mesh)
        assert eng.config.gradient_accumulation_steps == 2
        losses = [float(eng.train_batch(batch={k: v.astype(np.int32) for k, v in b.items()}))
                  for b in batches]
        flat = jax.tree_util.tree_flatten_with_path(eng.get_params())[0]
        params = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
                  for path, x in flat}
    finally:
        jax.config.update("jax_enable_x64", False)
        mesh_mod.reset_mesh()
    return params_np, batches, losses, params


def _fp64_engine(params_np):
    params = tree_map(lambda x: x.double(), params_from_jax(params_np, device="cpu"))
    eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float64),
                            config=RESUME_CONFIG, device="cpu", params=params)
    return eng


def _agent_run(agent, batches, losses):
    def step_fn(engine, step):
        losses.append(float(engine.train_batch(batch=batches[step])))
    try:
        return agent.run(step_fn, STEPS)
    finally:
        agent.guard.uninstall()


def _masters(eng):
    return {p: x.detach().clone() for p, x in tree_flatten_with_path(eng.get_params(fp32=True))}


def test_preempted_run_resumes_bit_equal_and_matches_jax_fp64(golden, tmp_path):
    params_np, batches, jax_losses, jax_params = golden
    ref = _fp64_engine(params_np)
    ref_losses = [float(ref.train_batch(batch=b)) for b in batches]

    ckpt = str(tmp_path / "ckpt")
    first, losses = ElasticAgent(_fp64_engine(params_np), ckpt), []
    # a real SIGTERM at the entry of step 3: the agent finishes the step,
    # saves at its boundary and returns
    install_injector(FaultInjector([FaultRule(site="train.step", kind="sigterm",
                                              at_call=PREEMPT_AT)]))
    try:
        last = _agent_run(first, batches, losses)
    finally:
        clear_injector()
    assert last == PREEMPT_AT and first.guard.received == signal.SIGTERM
    assert ElasticAgent.exit_code(last, STEPS) == RC_PREEMPTED
    assert sorted(os.listdir(ckpt)) == ["global_step3", "latest"]

    second = ElasticAgent(_fp64_engine(params_np), ckpt)
    assert _agent_run(second, batches, losses) == STEPS
    assert second.resumed_step == PREEMPT_AT and second.resumed_tag == "global_step3"
    assert ElasticAgent.exit_code(STEPS, STEPS) == 0
    assert losses == ref_losses                              # bit for bit
    got, want = _masters(second.engine), _masters(ref)
    assert all(torch.equal(got[k], want[k]) for k in want)
    np.testing.assert_allclose(losses, jax_losses, **GOLDEN_TOL)
    for k, v in jax_params.items():
        np.testing.assert_allclose(got[k].numpy(), v, err_msg=k, **PARAM_TOL_EVERY)
        assert (~np.isclose(got[k].numpy(), v, **GOLDEN_TOL)).mean() <= PARAM_OFF_SHARE, k


# ---------------------------------------------------------------------------
# The agent's own contracts
# ---------------------------------------------------------------------------

def _tiny_engine(seed=0):
    cfg = {"train_micro_batch_size_per_gpu": 2, "seed": seed,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
           "steps_per_print": 10 ** 9}
    eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32), config=cfg,
                            device="cpu")
    return eng


def _saved_generations(ckpt, n, keep=3):
    agent = ElasticAgent(_tiny_engine(), ckpt, ckpt_every=1, keep=keep)
    batches = make_batches(n, 2, seed=3)
    try:
        agent.run(lambda e, s: e.train_batch(batch=batches[s]), n)
    finally:
        agent.guard.uninstall()
    return agent


def test_corrupt_newest_tag_is_quarantined_and_falls_back(tmp_path):
    ckpt = str(tmp_path)
    _saved_generations(ckpt, 3)
    state = os.path.join(ckpt, "global_step3", "state")
    corrupt_file(os.path.join(state, sorted(os.listdir(state))[0]))
    agent = ElasticAgent(_tiny_engine(seed=1), ckpt)
    try:
        assert agent.restore_if_present() == 2
    finally:
        agent.guard.uninstall()
    assert agent.resumed_tag == "global_step2"
    assert sorted(os.listdir(ckpt)) == ["global_step1", "global_step2",
                                        "global_step3.corrupt", "latest"]
    with open(os.path.join(ckpt, "latest")) as f:
        assert f.read() == "global_step2"


@pytest.mark.parametrize("failures", [1, 2])
def test_a_load_error_is_retried_once_before_quarantine(failures, tmp_path):
    ckpt = str(tmp_path)
    _saved_generations(ckpt, 2)
    agent = ElasticAgent(_tiny_engine(seed=1), ckpt)
    install_injector(FaultInjector([FaultRule(site="ckpt.load", kind="raise",
                                              max_fires=failures)]))
    try:
        step = agent.restore_if_present()
    finally:
        clear_injector()
        agent.guard.uninstall()
    # one blip is retried in place; two in a row quarantine the tag
    assert step == (2 if failures == 1 else 1)
    assert os.path.isdir(os.path.join(ckpt, "global_step2.corrupt")) == (failures == 2)


def test_prune_keeps_newest_committed_and_progress_counts_them(tmp_path):
    ckpt = str(tmp_path)
    progress = checkpoint_progress_fn(ckpt)
    assert progress() == -1
    _saved_generations(ckpt, 5, keep=2)
    assert sorted(os.listdir(ckpt)) == ["global_step4", "global_step5", "latest"]
    assert progress() == 5
    # a torn save (no manifest) is neither progress nor a prune candidate
    os.remove(os.path.join(ckpt, "global_step5", "manifest.json"))
    assert progress() == 4


def test_fresh_start_and_guard_latch(tmp_path):
    agent = ElasticAgent(_tiny_engine(), str(tmp_path / "none"))
    try:
        assert agent.restore_if_present() == 0 and agent.resumed_tag is None
        assert not agent.stop_agreed()     # no process group: the local flag
        signal.raise_signal(signal.SIGTERM)
        assert agent.guard.should_stop and agent.guard.received == signal.SIGTERM
        assert agent.stop_agreed()
    finally:
        agent.guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not agent.guard._handler
    guard = PreemptionGuard.install(signals=(signal.SIGUSR1,))
    try:
        signal.raise_signal(signal.SIGUSR1)
        assert guard.should_stop and guard.received == signal.SIGUSR1
    finally:
        guard.uninstall()


def test_stop_agreed_returns_the_reduced_flag(tmp_path, monkeypatch):
    """At a world above 1 the ranks stop on the all-reduced flag: a signal
    that lands on one rank while the all-reduce runs is latched there and
    agreed at the next boundary, never acted on alone (which would send
    that rank into the collective save while its peers train on)."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.elasticity import elastic_agent

    agent = ElasticAgent(_tiny_engine(), str(tmp_path))
    reduced = []

    def all_reduce(flag, op):   # the peers' flags are 0; the signal lands now
        agent.guard.should_stop = True
        reduced.append(int(flag.item()))

    monkeypatch.setattr(elastic_agent, "_group_world", lambda: 2)
    monkeypatch.setattr(dist, "get_backend", lambda: "cpu:gloo,cuda:nccl")
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    try:
        assert agent.stop_agreed() is False and agent.guard.should_stop
        assert agent.stop_agreed() is True
    finally:
        agent.guard.uninstall()
    assert reduced == [0, 1]


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_backoff_schedule_matches_jax(seed):
    kw = dict(backoff_s=1.5, backoff_mult=2.0, backoff_max_s=20.0, jitter=0.25, seed=seed)
    port = Supervisor(lambda r: 0, **kw)
    ref = jsup.Supervisor(lambda r: 0, **kw)
    got = [port.backoff_delay(n) for n in range(1, 9)]
    assert got == [ref.backoff_delay(n) for n in range(1, 9)]
    assert max(got) <= 20.0 * 1.25 and got[0] != 1.5   # capped, jittered


def _scripted(rcs):
    calls = []

    def attempt(restarts):
        calls.append(restarts)
        rc = rcs[len(calls) - 1]
        if isinstance(rc, BaseException):
            raise rc
        return rc
    return attempt, calls


@pytest.mark.parametrize("case", [
    # (exit codes of the rounds, max_restarts, returned, rounds run)
    ([RC_PREEMPTED, RC_PREEMPTED, 0], 5, 0, 3),        # relaunch until complete
    ([85, 0], 5, 0, 2),                                # the watchdog's RC_HANG relaunches
    ([RC_PREEMPTED, 130], 5, 130, 2),                  # an interrupt is terminal
    ([3, 3, 3], 2, 3, 3),                              # the budget runs out
    ([RuntimeError("discovery"), 0], 5, 0, 2),         # a raising round consumes a restart
], ids=["relaunch", "hang", "interrupt", "budget", "exception"])
def test_supervisor_rounds(case):
    rcs, budget, want_rc, want_rounds = case
    attempt, calls = _scripted(rcs)
    rounds = []
    sup = Supervisor(attempt, max_restarts=budget, backoff_s=0.0,
                     on_round=lambda r, rc: rounds.append(rc))
    assert sup.run() == want_rc
    assert len(calls) == want_rounds
    assert rounds == [1 if isinstance(rc, BaseException) else rc
                      for rc in rcs[:want_rounds]]


def test_supervisor_keyboard_interrupt_propagates():
    attempt, _ = _scripted([KeyboardInterrupt()])
    with pytest.raises(KeyboardInterrupt):
        Supervisor(attempt, backoff_s=0.0).run()


def test_supervisor_progress_refreshes_budget_and_breaker_trips():
    steps = iter([0, 10, 20, 20, 20, 20])
    attempt, calls = _scripted([1] * 6)
    sup = Supervisor(attempt, max_restarts=1, backoff_s=0.0,
                     progress_fn=lambda: next(steps), zero_progress_limit=2)
    # rounds 1-2 advanced the frontier, each refreshing the one restart;
    # round 3 made none and finds the budget spent
    assert sup.run() == 1
    assert calls == [0, 1, 1] and not sup.breaker_tripped
    steps = iter([0, 10, 20, 20, 20, 20])
    attempt, calls = _scripted([1] * 6)
    sup = Supervisor(attempt, max_restarts=5, backoff_s=0.0,
                     progress_fn=lambda: next(steps), zero_progress_limit=2)
    assert sup.run() == 1
    # with budget to spare, rounds 3-4 made none: the breaker trips at 2
    # consecutive barren rounds
    assert calls == [0, 1, 1, 2] and sup.breaker_tripped
    assert "circuit breaker" in sup.diagnosis and "stuck at step 20" in sup.diagnosis


def test_supervisor_terminal_codes_and_stand_down():
    attempt, calls = _scripted([86, 0])
    sup = Supervisor(attempt, backoff_s=0.0, terminal_rcs=(86,))
    assert sup.run() == 86 and len(calls) == 1 and "terminal exit code 86" in sup.diagnosis
    attempt, calls = _scripted([SupervisorStandDown("leader healthy", rc=0)])
    sup = Supervisor(attempt, backoff_s=0.0)
    assert sup.run() == 0 and sup.diagnosis == "stand-down: leader healthy"


def test_supervisor_attempt_site_and_flight_dump():
    from deepspeed_tpu_torch.observability.trace import configure_tracer, trace_span

    attempt, calls = _scripted([0, 0])
    install_injector(FaultInjector([FaultRule(site="supervisor.attempt", kind="raise",
                                              at_call=1)]))
    tracer = configure_tracer(enabled=True)
    try:
        with trace_span("train.batch", step=1):
            pass
        sup = Supervisor(attempt, backoff_s=0.0)
        assert sup.run() == 0
    finally:
        clear_injector()
        configure_tracer(enabled=False)
        tracer.reset()
    # the injected raise failed round 1 before its attempt ran
    assert calls == [1]
    assert sup.last_flight_dump is not None and "supervisor.round[1] rc=1" in sup.last_flight_dump
