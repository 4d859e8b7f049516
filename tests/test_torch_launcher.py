"""The port's launcher (``deepspeed_tpu_torch/launcher``) and ``env_report``.

Held against the JAX package on the same inputs: ``fetch_hostfile``, the
include/exclude filters and ``encode_world_info`` (the same strings),
``parse_slurm_nodelist`` and the SLURM allocation's hosts.  The JAX
package's metadata source is never reached: its ``_gce_metadata`` raises
in every test of this file, so no test can contact a host.

The port's own contracts, one process per GPU: the rank contract of each
host's ranks; the ssh, srun and mpirun commands (built, never run: no
test contacts a host); ``--simulate 2`` giving two gloo ranks with
``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE``; two "hosts" of this machine
through the per-node spawner; ``wait_all_or_fail`` killing a hung
survivor and waiting out ranks that exit ``RC_PREEMPTED``; ``nvidia-smi``
counting the GPUs; a spawner SIGTERM-ed during its rank's slow save,
which commits; a ZeRO-2 job at ``--simulate 2`` where only rank 1 gets SIGTERM,
both ranks saving the same step, resumed at ``--simulate 1`` (the global
batch kept, gradient accumulation absorbing the change) and, SIGTERM-ed
again, relaunched by the supervisor, every loss within 1e-5 of the
uninterrupted world-1 run in fp32; the pod and fleet options refused,
naming their ROADMAP items; ``env_report`` without a card, building
nothing.  The launched children run ``tests/_torch_elastic_child.py``.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu.launcher import pod as jax_pod
from deepspeed_tpu.launcher import runner as jax_runner

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.launcher import launch, multinode_runner, runner
from deepspeed_tpu_torch.launcher.multinode_runner import (MPIRunner, SlurmRunner, SSHRunner,
                                                           _rank_bootstrap_cmd)
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

from ._torch_ranks import make_batches

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# fp32 sums over two ranks against one process (tests/test_torch_zero.py's
# scale), compounded over 6 Adam steps
RESIZE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_metadata_server(monkeypatch):
    def refuse(key, timeout=1.0):
        raise AssertionError("a test reached the metadata server")

    monkeypatch.setattr(jax_pod, "_gce_metadata", refuse)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(DS_ACCELERATOR="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]))
    return env


def _launcher(*args, timeout=240):
    return subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher", *args],
                          cwd=str(ROOT), env=_child_env(), capture_output=True, text=True,
                          timeout=timeout)


def _spec(tmp_path, **spec) -> str:
    path = tmp_path / f"spec-{time.monotonic_ns()}.json"
    path.write_text(json.dumps({"out": str(tmp_path), **spec}))
    return str(path)


# ---------------------------------------------------------------------------
# Pools, filters and discovery against the JAX package
# ---------------------------------------------------------------------------

HOSTFILES = {
    "plain": "worker-0 slots=8\nworker-1 slots=8\n",
    "comments": "# pool\nw0 slots=4  # four cards\n\nw1\nw2 slots=2\n",
    "empty": "",
    "bad-token": "worker-0 slot=4\n",
    "bad-slots": "worker-0 slots=x\n",
    "duplicate": "h1 slots=2\nh1 slots=2\n",
}


@pytest.mark.parametrize("name", list(HOSTFILES))
def test_fetch_hostfile_matches_jax(name, tmp_path):
    path = tmp_path / "hostfile"
    path.write_text(HOSTFILES[name])

    def outcome(fn):
        try:
            return ("ok", list(fn(str(path)).items()))
        except ValueError as e:
            return ("raised", str(e))
    assert outcome(runner.fetch_hostfile) == outcome(jax_runner.fetch_hostfile)
    assert runner.fetch_hostfile(str(tmp_path / "none")) == OrderedDict()


POOL = OrderedDict([("w0", 4), ("w1", 4), ("w2", 4)])
FILTERS = [("", ""), ("w1", ""), ("w0@w2", ""), ("w0:0,2@w1:1-3", ""), ("", "w1"),
           ("", "w0:0@w2:1-2"), ("", "w0:0-3"), ("w0", "w0"), ("w9", ""), ("w0:4", ""),
           ("", "w1:7")]


@pytest.mark.parametrize("flt", FILTERS, ids=lambda f: f"i={f[0]}-e={f[1]}")
def test_resource_filters_and_world_info_match_jax(flt):
    def outcome(mod):
        try:
            active = mod.parse_resource_filter(POOL, *flt)
        except ValueError as e:
            return ("raised", str(e))
        return ("ok", list(active.items()), mod.encode_world_info(active))
    got = outcome(runner)
    assert got == outcome(jax_runner)
    if got[0] == "ok":
        assert runner.decode_world_info(got[2]) == OrderedDict(got[1])


@pytest.mark.parametrize("nodelist", [
    "n1", "a,b,c", "gpu-[1-3]", "gpu-[001-003,010]", "n[1,3-5],login1",
    "rack[1-2]-node", "h[08-11]"])
def test_parse_slurm_nodelist_matches_jax(nodelist):
    assert (multinode_runner.parse_slurm_nodelist(nodelist)
            == jax_pod.parse_slurm_nodelist(nodelist))


SLURM_ENVS = {
    "job-nodelist": {"SLURM_JOB_NODELIST": "gpu-[001-003]", "SLURM_NODEID": "1"},
    "nodelist": {"SLURM_NODELIST": "a,b[1-2]"},
    "both": {"SLURM_JOB_NODELIST": "x[1-2]", "SLURM_NODELIST": "y1"},
    "outside": {"TPU_WORKER_HOSTNAMES": "t0,t1"},
}


@pytest.mark.parametrize("name", list(SLURM_ENVS))
def test_slurm_allocation_hosts_match_jax(name):
    env = SLURM_ENVS[name]
    got = multinode_runner.slurm_pool(env, gpus_per_host=2)
    want = jax_pod.discover_pod(coord_port=29500, env=env, sources=("slurm",))
    if want is None:
        assert got is None
        return
    assert list(got) == want.worker_hostnames and set(got.values()) == {2}


def test_slurm_pool_counts_gpus(monkeypatch):
    env = {"SLURM_JOB_NODELIST": "g[1-2]", "SLURM_GPUS_ON_NODE": "8"}
    assert multinode_runner.slurm_pool(env) == OrderedDict([("g1", 8), ("g2", 8)])
    assert multinode_runner.slurm_pool(env, 2) == OrderedDict([("g1", 2), ("g2", 2)])
    for raw, want in (("h100:4", 4), ("4", 4), ("", None), ("gpu:x", None)):
        assert multinode_runner.slurm_gpus({"SLURM_GPUS_PER_NODE": raw}) == want
    # no published count: this host's (CUDA_VISIBLE_DEVICES counted)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5,6")
    assert multinode_runner.slurm_pool({"SLURM_NODELIST": "t[0-1]"}) == OrderedDict(
        [("t0", 3), ("t1", 3)])


def _fake_nvidia_smi(tmp_path, monkeypatch, script):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    tool = bin_dir / "nvidia-smi"
    tool.write_text("#!/bin/sh\n" + script)
    tool.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)


@pytest.mark.parametrize("script, want", [
    ("printf '0\\n1\\n2\\n'", 3), ("echo 0", 1), ("exit 9", 1), (None, 1)],
    ids=["three", "one", "failing", "absent"])
def test_local_gpu_count_asks_nvidia_smi_not_cuda(script, want, tmp_path, monkeypatch):
    """Without ``CUDA_VISIBLE_DEVICES`` the launcher counts GPUs through
    ``nvidia-smi`` in a process of its own, never through CUDA in its
    own; no tool, or a failing one, leaves one slot."""
    def no_cuda(*a, **k):
        raise AssertionError("the launcher reached CUDA")

    monkeypatch.setattr(torch.cuda, "device_count", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    if script is None:
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        _fake_nvidia_smi(tmp_path, monkeypatch, script)
    assert runner.local_gpu_count() == want


# ---------------------------------------------------------------------------
# Arguments and refusals
# ---------------------------------------------------------------------------

def test_parse_args_keeps_the_user_command():
    a = runner.parse_args(["--num_gpus", "2", "--elastic_restarts", "3", "train.py",
                           "--lr", "0.1", "--num_gpus", "9"])
    assert (a.num_gpus, a.elastic_restarts, a.user_script) == (2, 3, "train.py")
    assert a.user_args == ["--lr", "0.1", "--num_gpus", "9"]
    assert runner.parse_args(["--num_chips", "4", "t.py"]).num_gpus == 4


@pytest.mark.parametrize("flag", [
    ["--pod_coord_dir", "/x"], ["--pod_lease", "2.0"], ["--pod_miss_limit", "5"],
    ["--fleet", "2"], ["--fleet_coord_dir", "/x"], ["--fleet_lease", "1"],
    ["--fleet_miss_limit", "2"], ["--fleet_routers", "2"], ["--fleet_daemon"]],
    ids=lambda f: f[0])
def test_pod_and_fleet_options_are_refused_naming_their_item(flag, capsys):
    with pytest.raises(SystemExit) as e:
        runner.parse_args([*flag, "train.py"])
    assert e.value.code == 2
    item = 13 if flag[0].startswith("--pod") else 14
    assert f"{flag[0]}: " in capsys.readouterr().err
    with pytest.raises(SystemExit):
        runner.parse_args([*flag, "train.py"])
    assert f"(ROADMAP queue 1, item {item})" in capsys.readouterr().err


def test_scheduler_launcher_without_a_pool_refuses(tmp_path, monkeypatch):
    for key in ("SLURM_JOB_NODELIST", "SLURM_NODELIST"):
        monkeypatch.delenv(key, raising=False)
    for name, what in (("slurm", "no SLURM allocation"), ("openmpi", "no hostfile")):
        with pytest.raises(RuntimeError, match=what):
            runner.main(["-H", str(tmp_path / "none"), f"--launcher={name}", "t.py"])


def test_zero_progress_breaker_needs_a_checkpoint_dir(capsys):
    with pytest.raises(SystemExit):
        runner.parse_args(["--elastic_zero_progress", "2", "t.py"])
    assert "--elastic_ckpt_dir" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# One process per GPU: the rank contract and the runners' commands
# ---------------------------------------------------------------------------

def test_rank_envs_number_ranks_host_by_host():
    active = OrderedDict([("h0", [0, 1]), ("h1", [2]), ("h2", [0, 1, 2])])
    got = [launch.rank_envs(active, n) for n in range(3)]
    assert [[e["RANK"] for e in node] for node in got] == [["0", "1"], ["2"], ["3", "4", "5"]]
    assert [[e["LOCAL_RANK"] for e in node] for node in got] == [["0", "1"], ["0"],
                                                                 ["0", "1", "2"]]
    assert {e["WORLD_SIZE"] for node in got for e in node} == {"6"}
    assert [node[0]["LOCAL_WORLD_SIZE"] for node in got] == ["2", "1", "3"]


def _runner_args(launcher="ssh", extra=()):
    return runner.parse_args([f"--launcher={launcher}", *extra, "train.py"])


def _job(hosts, slots=2, pool=4):
    active = OrderedDict((h, list(range(slots))) for h in hosts)
    base = {"MASTER_ADDR": hosts[0], "MASTER_PORT": "29500",
            "WORLD_SIZE": str(slots * len(hosts)),
            "DS_TPU_WORLD_INFO": runner.encode_world_info(active)}
    return active, base, OrderedDict((h, pool) for h in hosts)


def test_ssh_runner_starts_the_spawner_once_a_host():
    active, base, pool = _job(["n1", "n2"], slots=2, pool=2)
    active["n2"] = [1]                                   # narrowed: one of two GPUs
    r = SSHRunner(_runner_args(extra=["--ssh_port", "2222"]), active, base, pool=pool)
    cmds = [r._ssh_cmd(h, ["python", "-u", "train.py"]) for h in r.hosts]
    for i, cmd in enumerate(cmds):
        assert cmd[:5] == ["ssh", "-o", "StrictHostKeyChecking=no", "-o", "BatchMode=yes"]
        assert cmd[5:7] == ["-p", "2222"] and cmd[7] == f"n{i + 1}"
        remote = cmd[8]
        assert "-m deepspeed_tpu_torch.launcher.launch" in remote
        assert f"--node_rank={i}" in remote and "--master_addr=n1" in remote
        assert remote.endswith("-- python -u train.py")
        assert "export MASTER_PORT=29500;" in remote
        assert ("CUDA_VISIBLE_DEVICES=1" in remote) == (i == 1)


def test_spawner_main_starts_its_hosts_ranks(monkeypatch):
    active = OrderedDict([("h0", [0, 1]), ("h1", [0, 1, 2])])
    started = []

    class Done:
        def poll(self):
            return 0

    def fake_popen(cmd, env, preexec_fn):
        assert preexec_fn is launch._die_with_parent
        started.append((cmd, {k: env[k] for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE",
                                                   "MASTER_ADDR", "MASTER_PORT")}))
        return Done()

    monkeypatch.setattr(launch.subprocess, "Popen", fake_popen)
    handler = signal.getsignal(signal.SIGTERM)
    rc = launch.main([f"--world_info={runner.encode_world_info(active)}", "--node_rank=1",
                      "--master_addr=h0", "--master_port=1234", "--", "python", "t.py"])
    assert rc == 0
    assert [e for _, e in started] == [
        {"RANK": str(2 + r), "LOCAL_RANK": str(r), "WORLD_SIZE": "5", "MASTER_ADDR": "h0",
         "MASTER_PORT": "1234"} for r in range(3)]
    assert all(cmd == ["python", "t.py"] for cmd, _ in started)
    assert signal.getsignal(signal.SIGTERM) is handler       # restored


@pytest.fixture
def scheduler_backends(monkeypatch):
    """Pretend srun/mpirun exist (this host has neither) and capture the
    command instead of running it."""
    captured = {}

    def fake_call(cmd, **kw):
        captured["cmd"] = cmd
        hf = (kw.get("env") or {}).get("SLURM_HOSTFILE")
        if hf:   # read now: the runner removes it after the launch
            captured["hostfile"] = open(hf).read().split()
        return 0

    monkeypatch.setattr(
        "deepspeed_tpu_torch.launcher.multinode_runner._SchedulerRunner.backend_exists",
        lambda self: True)
    monkeypatch.setattr(subprocess, "call", fake_call)
    return captured


def test_slurm_runner_starts_one_task_a_gpu(scheduler_backends):
    active, base, pool = _job(["n1", "n2"], slots=2, pool=2)
    SlurmRunner(_runner_args("slurm"), active, base, pool=pool).launch(["python", "t.py"])
    cmd = scheduler_backends["cmd"]
    assert cmd[:5] == ["srun", "--nodes", "2", "--ntasks", "4"]
    assert cmd[cmd.index("--distribution") + 1] == "arbitrary"
    assert scheduler_backends["hostfile"] == ["n1", "n1", "n2", "n2"]
    exp = cmd[cmd.index("--export") + 1]
    assert exp.startswith("ALL,") and "MASTER_ADDR=n1" in exp and "WORLD_SIZE=4" in exp
    assert "SLURM_PROCID" in cmd[-1] and "SLURM_LOCALID" in cmd[-1]
    assert cmd[-1].endswith("exec python t.py")


@pytest.mark.parametrize("flavor", ["openmpi", "mpich", "impi"])
def test_mpi_runner_dialects(flavor, scheduler_backends):
    active, base, pool = _job(["h1", "h2"], slots=2, pool=2)
    MPIRunner(_runner_args(flavor), active, base, pool=pool).launch(["python", "t.py"])
    cmd = scheduler_backends["cmd"]
    assert cmd[:3] == ["mpirun", "-np", "4"]
    if flavor == "openmpi":
        assert cmd[3:5] == ["--host", "h1:2,h2:2"] and "-x" in cmd
        assert "OMPI_COMM_WORLD_LOCAL_RANK" in cmd[-1]
    else:
        assert cmd[3:5] == ["-hosts", "h1:2,h2:2"] and "-genv" in cmd
        assert "PMI_RANK" in cmd[-1] and "MPI_LOCALRANKID" in cmd[-1]


def test_scheduler_runners_refuse_narrowed_hosts(scheduler_backends):
    active, base, pool = _job(["n1", "n2"], slots=2, pool=4)   # 2 of 4 GPUs
    for cls, name in ((SlurmRunner, "slurm"), (MPIRunner, "openmpi")):
        with pytest.raises(ValueError, match="CUDA_VISIBLE_DEVICES"):
            cls(_runner_args(name), active, base, pool=pool).launch(["python", "t.py"])


def test_scheduler_runner_needs_its_binary(monkeypatch):
    monkeypatch.setattr("shutil.which", lambda name: None)
    with pytest.raises(RuntimeError, match="srun.*not found"):
        SlurmRunner(_runner_args("slurm"), *_job(["n1"])[:2]).launch(["t"])


def test_rank_bootstrap_maps_rank_and_local_rank():
    probe = ["bash", "-c", "echo $RANK/$LOCAL_RANK"]

    def run(env, rank_vars=("A", "B"), local_vars=("L",)):
        return subprocess.run(["bash", "-c", _rank_bootstrap_cmd(probe, list(rank_vars),
                                                                 list(local_vars))],
                              env={"PATH": "/usr/bin:/bin", **env},
                              capture_output=True, text=True)
    assert run({"A": "7", "L": "1"}).stdout.strip() == "7/1"
    assert run({"B": "3", "L": "0"}).stdout.strip() == "3/0"      # the chain's fallback
    out = run({"L": "0"})                                          # no rank variable
    assert out.returncode != 0 and "A B" in out.stderr
    out = run({"A": "1"})                                          # no local rank
    assert out.returncode != 0 and "local rank" in out.stderr


def test_single_host_narrowing_maps_through_inherited_devices(monkeypatch, tmp_path):
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("localhost slots=4\n")
    seen = {}

    def fake_start(cmd, active, node_rank, env):
        seen.update(active=dict(active), cvd=env.get("CUDA_VISIBLE_DEVICES"))
        return []
    monkeypatch.setattr(launch, "start_local_ranks", fake_start)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    assert runner.main(["-H", str(hostfile), "-i", "localhost:1,3", "t.py"]) == 0
    assert seen == {"active": {"localhost": [1, 3]}, "cvd": "5,7"}
    assert runner.main(["-H", str(hostfile), "t.py"]) == 0       # whole host: untouched
    assert seen["cvd"] == "4,5,6,7"


# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------

def test_wait_all_or_fail_kills_hung_survivor():
    hang = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
    boom = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(3)"])
    failed = []
    rc = runner.wait_all_or_fail([hang, boom], poll_s=0.05,
                                 on_fail=lambda i, rc: failed.append((i, rc)))
    assert rc == 3 and failed == [(1, 3)]
    assert hang.poll() is not None          # terminated, not orphaned


def test_wait_all_or_fail_waits_out_preempted_peers(tmp_path):
    """A rank's ``RC_PREEMPTED`` is no failure: its peer, still saving,
    is waited for, not killed, and the wait returns ``RC_PREEMPTED``."""
    done = tmp_path / "saved"
    early = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(75)"])
    late = subprocess.Popen([sys.executable, "-c", "import pathlib, sys, time; "
                             f"time.sleep(1.0); pathlib.Path({str(done)!r}).touch(); "
                             "sys.exit(75)"])
    failed = []
    rc = runner.wait_all_or_fail([early, late], poll_s=0.05, kill_grace_s=0.1,
                                 on_fail=lambda i, rc: failed.append((i, rc)))
    assert rc == runner.RC_PREEMPTED and failed == [] and done.exists()
    assert late.returncode == 75


def test_spawner_sigterm_waits_for_the_ranks_save(tmp_path):
    """SIGTERM to the per-node spawner (a preemption notice to its host)
    reaches its rank, which saves at the step boundary in a save longer
    than the kill grace (1 s here) and exits 75: the spawner waits for it
    and returns 75, and the tag is committed."""
    from deepspeed_tpu_torch.resilience.integrity import LATEST_FILE, MANIFEST_FILE

    ckpt, ready = tmp_path / "ckpt", tmp_path / "ready"
    spec = _spec(tmp_path, mode="train", config=ELASTIC, steps=4, data_seed=DATA_SEED,
                 ckpt_dir=str(ckpt), pause={"after_step": 2, "ready": str(ready)},
                 save_delay_s=3.0)
    world_info = runner.encode_world_info(OrderedDict([("localhost", [0])]))
    code = ("import sys; from deepspeed_tpu_torch.launcher import launch, runner; "
            "runner.KILL_GRACE_S = 1.0; sys.exit(launch.main(sys.argv[1:]))")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, f"--world_info={world_info}", "--node_rank=0",
         "--master_addr=127.0.0.1", f"--master_port={_free_port()}", "--",
         sys.executable, "-u", "-m", "tests._torch_elastic_child", spec],
        cwd=str(ROOT), env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 180
        while not ready.exists() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ready.exists(), proc.stderr.read()[-4000:] if proc.poll() is not None else ""
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == runner.RC_PREEMPTED, err[-4000:]
    assert (ckpt / "global_step2" / MANIFEST_FILE).exists()
    assert (ckpt / LATEST_FILE).read_text().strip() == "global_step2"
    exits = [r for r in _records(tmp_path)[0] if r.get("event") == "exit"]
    assert [e["last"] for e in exits] == [2]


def test_launcher_propagates_a_failure(tmp_path):
    res = _launcher("-H", str(tmp_path / "none"), "--num_gpus", "1", "--no_python",
                    "bash", "-c", "exit 3")
    assert res.returncode == 3, res.stderr


def test_simulate_two_gloo_ranks(tmp_path):
    port = _free_port()
    res = _launcher("--simulate", "2", "--master_port", str(port), "--module",
                    "tests._torch_elastic_child", _spec(tmp_path, mode="env"))
    assert res.returncode == 0, res.stderr[-4000:]
    got = [json.loads((tmp_path / f"env{r}.json").read_text()) for r in range(2)]
    for r, rec in enumerate(got):
        assert rec["env"]["RANK"] == rec["env"]["LOCAL_RANK"] == str(r)
        assert rec["env"]["WORLD_SIZE"] == "2" and rec["world"] == 2
        assert rec["env"]["MASTER_ADDR"] == "127.0.0.1"
        assert rec["env"]["MASTER_PORT"] == str(port)
        assert rec["env"]["DS_ACCELERATOR"] == "cpu" and rec["env"]["CUDA_VISIBLE_DEVICES"] == ""
        assert rec["backend"] == "gloo" and rec["sum"] == 3.0


def test_two_local_hosts_through_the_spawner(tmp_path):
    """``--launcher local`` runs one per-node spawner a host on this machine:
    the hosts' ranks meet in one gloo group, numbered host by host."""
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("hostA slots=1\nhostB slots=1\n")
    res = _launcher("-H", str(hostfile), "--launcher", "local", "--master_port",
                    str(_free_port()), "--module", "tests._torch_elastic_child",
                    _spec(tmp_path, mode="env"))
    assert res.returncode == 0, res.stderr[-4000:]
    got = [json.loads((tmp_path / f"env{r}.json").read_text()) for r in range(2)]
    assert [(g["env"]["RANK"], g["env"]["LOCAL_RANK"], g["env"]["NODE_RANK"])
            for g in got] == [("0", "0", "0"), ("1", "0", "1")]
    assert all(g["sum"] == 3.0 and g["env"]["WORLD_SIZE"] == "2" for g in got)


ELASTIC = {"elasticity": {"enabled": True, "max_train_batch_size": 4,
                          "micro_batch_sizes": [1, 2], "min_gpus": 1, "max_gpus": 2},
           "zero_optimization": {"stage": 2},
           "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
           "gradient_clipping": 1.0, "steps_per_print": 10 ** 9, "seed": 3}
STEPS, DATA_SEED = 6, 5


def _records(tmp_path):
    out = {}
    for r in range(2):
        path = tmp_path / f"rank{r}.jsonl"
        if path.exists():
            out[r] = [json.loads(line) for line in path.read_text().splitlines()]
    return out


def test_preempt_one_rank_resize_and_relaunch(tmp_path):
    """ZeRO-2 at --simulate 2; SIGTERM reaches rank 1 only, after step 3:
    both ranks stop and save at step 3 and exit 75.  --simulate 1 resumes
    from that tag (micro 2 x gas 2 for the same global batch of 4), is
    SIGTERM-ed after step 4, and its supervisor relaunches it once to the
    end.  Every row has the same count of labelled tokens: the step's loss
    is the mean of its micro-batches' token means (JAX's engine too), which
    equals the token mean over the global batch only then."""
    ckpt = tmp_path / "ckpt"
    spec = _spec(tmp_path, mode="train", config=ELASTIC, steps=STEPS, data_seed=DATA_SEED,
                 ignore=False, ckpt_dir=str(ckpt),
                 signals=[{"rank": 1, "after_step": 3, "marker": str(tmp_path / "m1")},
                          {"rank": 0, "after_step": 4, "marker": str(tmp_path / "m2")}])
    res = _launcher("--simulate", "2", "--master_port", str(_free_port()),
                    "--module", "tests._torch_elastic_child", spec)
    assert res.returncode == 75, res.stderr[-4000:]
    first = _records(tmp_path)
    for r in range(2):
        steps = [rec for rec in first[r] if "step" in rec]
        assert [rec["step"] for rec in steps] == [1, 2, 3]
        assert {(rec["world"], rec["micro"], rec["gas"]) for rec in steps} == {(2, 2, 1)}
        assert first[r][-1]["event"] == "exit" and first[r][-1]["last"] == 3
    assert sorted(os.listdir(ckpt)) == ["global_step3", "latest"]

    res = _launcher("--simulate", "1", "--master_port", str(_free_port()),
                    "--elastic_restarts", "1", "--elastic_backoff", "0",
                    "--elastic_ckpt_dir", str(ckpt),
                    "--module", "tests._torch_elastic_child", spec)
    assert res.returncode == 0, res.stderr[-4000:]
    recs = _records(tmp_path)[0][len(first[0]):]
    exits = [rec for rec in recs if rec.get("event") == "exit"]
    assert [(e["resumed_tag"], e["last"]) for e in exits] == [("global_step3", 4),
                                                             ("global_step4", STEPS)]
    assert len({rec["pid"] for rec in recs}) == 2            # relaunched once
    later = [rec for rec in recs if "step" in rec]
    assert [rec["step"] for rec in later] == [4, 5, 6]
    assert {(rec["world"], rec["micro"], rec["gas"]) for rec in later} == {(1, 2, 2)}

    eng, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32), config=ELASTIC,
                            device="cpu")
    batches = make_batches(STEPS, eng.train_batch_size, seed=DATA_SEED, ignore=False)
    want = [float(eng.train_batch(batch=b)) for b in batches]
    got = [rec["loss"] for rec in first[0] if "step" in rec] + [rec["loss"] for rec in later]
    np.testing.assert_allclose(got, want, **RESIZE_TOL)
    final = torch.load(tmp_path / "final.pt")
    for path, x in tree_flatten_with_path(eng.get_params(fp32=True)):
        np.testing.assert_allclose(final[path].numpy(), x.detach().numpy(),
                                   err_msg=path, **RESIZE_TOL)


# ---------------------------------------------------------------------------
# env_report and ds_ssh
# ---------------------------------------------------------------------------

def test_env_report_runs_without_a_card_and_builds_nothing():
    from deepspeed_tpu_torch.ops.op_builder import BUILD_DIR

    before = sorted(BUILD_DIR.iterdir()) if BUILD_DIR.is_dir() else []
    res = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.env_report"],
                         cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    for name in ("flash_attention_fwd (K1)", "flash_attention_bwd (K2, K3)",
                 "decode_attention (K4)", "host.cpu_adam", "host.async_io", "nvcc",
                 "triton", "CUTLASS headers", "torch"):
        assert name in out, name
    if not torch.cuda.is_available():
        assert "no CUDA device: torch.cuda.is_available() is False" in out
    after = sorted(BUILD_DIR.iterdir()) if BUILD_DIR.is_dir() else []
    assert after == before


def test_ds_ssh_runs_locally_and_refuses_slot_filters(tmp_path, capsys):
    from deepspeed_tpu_torch.launcher import ds_ssh

    assert ds_ssh.main(["-H", str(tmp_path / "none"), "--", "true"]) == 0
    assert ds_ssh.main(["-H", str(tmp_path / "none"), "--", "false"]) == 1
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("localhost slots=2\n")
    with pytest.raises(SystemExit):
        ds_ssh.main(["-H", str(hostfile), "-i", "localhost:0", "--", "true"])
    assert "slot-granular" in capsys.readouterr().err
    assert ds_ssh.main(["-H", str(hostfile), "--", "true"]) == 0
