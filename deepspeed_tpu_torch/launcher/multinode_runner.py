"""Multi-host fan-out backends (counterpart of
``deepspeed_tpu/launcher/multinode_runner.py``; reference
``launcher/multinode_runner.py:51``, PDSH/OpenMPI/MPICH/IMPI/SLURM), one
process per GPU:

- :class:`SSHRunner`   — one ssh command a host, running the per-node
  spawner (``launch.py``), which starts the host's ranks;
- :class:`SlurmRunner` — one ``srun`` that starts every rank, one task a
  GPU; ``RANK``/``LOCAL_RANK`` from ``SLURM_PROCID``/``SLURM_LOCALID``
  inside the task (srun owns placement); without a hostfile the pool is
  the allocation's (:func:`slurm_pool`);
- :class:`MPIRunner`   — ``mpirun``, one slot a GPU; the rank variables of
  OpenMPI or of the Hydra launchers inside the task;
- :class:`LocalRunner` — every host is this machine (CI): one spawner a
  host as a local process.

All reach the one rank contract ``comm.init_distributed`` reads: ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``.
"""
from __future__ import annotations

import os
import re
import shlex
import subprocess
import sys
from collections import OrderedDict
from typing import Dict, List, Optional

from ..utils.logging import logger
from .runner import narrowed_hosts, wait_all_or_fail


class MultiNodeRunner:
    def __init__(self, args, active, base_env: Dict[str, str],
                 pool: Optional[Dict[str, int]] = None):
        self.args = args
        self.active = active              # host -> GPU indices
        self.hosts = list(active)
        self.base_env = base_env
        self.pool = pool or {}            # host -> total GPUs (before filters)

    def env_for(self, host: str) -> Dict[str, str]:
        """The exports of one host's spawner: the job's, plus
        ``CUDA_VISIBLE_DEVICES`` only where a filter narrowed this host
        (a hostfile's ``slots=N`` alone hides no GPU)."""
        env = dict(self.base_env)
        if host in narrowed_hosts(self.active, self.pool):
            env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, self.active[host]))
        return env

    def spawner_cmd(self, host: str, user_cmd: List[str],
                    master_addr: Optional[str] = None) -> List[str]:
        """The per-node spawner's command for ``host``."""
        return [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
                f"--world_info={self.base_env['DS_TPU_WORLD_INFO']}",
                f"--node_rank={self.hosts.index(host)}",
                f"--master_addr={master_addr or self.base_env['MASTER_ADDR']}",
                f"--master_port={self.base_env['MASTER_PORT']}", "--", *user_cmd]

    def launch(self, user_cmd: List[str]) -> int:
        raise NotImplementedError


def ssh_base_cmd(ssh_port=None, launcher_args=None) -> List[str]:
    """The one place the ssh flags live (SSHRunner and ds_ssh): no host-key
    prompts, fail fast instead of password prompts, optional port and extra
    user flags."""
    ssh = ["ssh", "-o", "StrictHostKeyChecking=no", "-o", "BatchMode=yes"]
    if ssh_port:
        ssh += ["-p", str(ssh_port)]
    if launcher_args:
        ssh += shlex.split(launcher_args)
    return ssh


class SSHRunner(MultiNodeRunner):
    """ssh-per-host fan-out of the per-node spawner; the first failure (or
    ^C) terminates the job."""

    def _ssh_cmd(self, host: str, user_cmd: List[str]) -> List[str]:
        exports = " ".join(f"export {k}={shlex.quote(v)};"
                           for k, v in self.env_for(host).items())
        remote = (f"{exports} cd {shlex.quote(os.getcwd())}; "
                  f"{shlex.join(self.spawner_cmd(host, user_cmd))}")
        ssh = ssh_base_cmd(self.args.ssh_port, self.args.launcher_args)
        return ssh + [host, remote]

    def launch(self, user_cmd: List[str]) -> int:
        procs: List[subprocess.Popen] = []
        for host in self.hosts:
            cmd = self._ssh_cmd(host, user_cmd)
            logger.info("launcher[%s/%d]: %s", host, len(self.hosts),
                        shlex.join(cmd[:6]) + " ...")
            procs.append(subprocess.Popen(cmd))
        rc = wait_all_or_fail(
            procs,
            on_fail=lambda i, rc: logger.error(
                "launcher: host %s failed first with rc=%d", self.hosts[i], rc))
        if rc == 130:
            logger.info("launcher: interrupted; all hosts terminated")
        return rc


def _rank_bootstrap_cmd(user_cmd: List[str], rank_vars: List[str],
                        local_rank_vars: List[str]) -> str:
    """One shell line that maps the scheduler's rank variables onto
    ``RANK`` and ``LOCAL_RANK``, then execs the user command: srun and
    mpirun start every task from one command, so a rank can only be read
    inside the task.  If NO variable of a chain is set the shell itself
    fails with a message naming them (bash ``:?``), better than exporting
    garbage and dying later in ``init_distributed``."""

    def chain(names: List[str], what: str) -> str:
        msg = f"no scheduler {what} variable set (tried {' '.join(names)})"
        return ("".join("${%s:-" % v for v in names[:-1])
                + "${%s:?%s}" % (names[-1], msg) + "}" * (len(names) - 1))

    return (f'export RANK="{chain(rank_vars, "rank")}"; '
            f'export LOCAL_RANK="{chain(local_rank_vars, "local rank")}"; '
            f"exec {shlex.join(user_cmd)}")


class _SchedulerRunner(MultiNodeRunner):
    """Shared guards for runners whose scheduler starts ALL tasks from one
    command (srun/mpirun): the backend binary must exist, and per-host env
    (a narrowed host's ``CUDA_VISIBLE_DEVICES``) cannot be expressed —
    refuse it loudly instead of silently running on every GPU (the ssh path
    honours it)."""

    backend_binary = ""

    def backend_exists(self) -> bool:
        import shutil

        return shutil.which(self.backend_binary) is not None

    def _preflight(self) -> None:
        if not self.backend_exists():
            raise RuntimeError(
                f"--launcher {self.args.launcher}: '{self.backend_binary}' "
                "not found on PATH (is this a "
                f"{self.args.launcher} environment?)")
        narrowed = narrowed_hosts(self.active, self.pool)
        if narrowed:
            raise ValueError(
                f"--launcher {self.args.launcher} launches uniformly and "
                "cannot export a per-host CUDA_VISIBLE_DEVICES; GPU filters "
                f"were given for {narrowed} — use --launcher ssh for them, "
                "or drop the :slot filter")

    def _tasks(self) -> List[str]:
        """One host name a rank, in rank order."""
        return [h for h in self.hosts for _ in self.active[h]]


def parse_slurm_nodelist(nodelist: str) -> List[str]:
    """Expand SLURM's compact nodelist grammar natively:
    ``gpu-[001-003,010],login1`` -> explicit host list.  Falls back to
    ``scontrol show hostnames`` for forms this parser doesn't cover (nested
    brackets etc.) so SLURM itself stays the authority of last resort."""
    hosts: List[str] = []
    # split on commas OUTSIDE brackets
    parts, depth, cur = [], 0, ""
    for ch in nodelist:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        parts.append(cur)
    for part in parts:
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"([^\[\]]+)\[([^\[\]]+)\](.*)", part)
        if m is None:
            if "[" in part or "]" in part:
                return _scontrol_hostnames(nodelist)
            hosts.append(part)
            continue
        prefix, body, suffix = m.groups()
        if "[" in suffix or "]" in suffix:
            return _scontrol_hostnames(nodelist)
        for piece in body.split(","):
            piece = piece.strip()
            if "-" in piece:
                lo, hi = piece.split("-", 1)
                width = len(lo) if lo.startswith("0") else 0
                for i in range(int(lo), int(hi) + 1):
                    hosts.append(f"{prefix}{i:0{width}d}{suffix}")
            else:
                hosts.append(f"{prefix}{piece}{suffix}")
    return hosts


def _scontrol_hostnames(nodelist: str) -> List[str]:
    out = subprocess.run(["scontrol", "show", "hostnames", nodelist],
                         capture_output=True, text=True, check=True)
    return [h for h in out.stdout.split() if h]


def slurm_gpus(env) -> Optional[int]:
    """GPUs a node from the allocation env: ``SLURM_GPUS_ON_NODE`` (a
    count) or ``SLURM_GPUS_PER_NODE`` (``4`` or ``type:4``)."""
    for key in ("SLURM_GPUS_ON_NODE", "SLURM_GPUS_PER_NODE"):
        raw = (env.get(key) or "").strip()
        m = re.fullmatch(r"(?:[\w-]+:)?(\d+)", raw)
        if m:
            return int(m.group(1))
    return None


def slurm_pool(env: Optional[Dict[str, str]] = None,
               gpus_per_host: Optional[int] = None) -> "Optional[OrderedDict[str, int]]":
    """The SLURM allocation as the launcher's ``host -> GPUs`` pool, or
    None outside one: its nodes (``SLURM_JOB_NODELIST``) with
    ``gpus_per_host`` (``--num_gpus``) each, else the count the allocation
    publishes, else this host's (an allocation's nodes are alike)."""
    env = os.environ if env is None else env
    nodelist = env.get("SLURM_JOB_NODELIST") or env.get("SLURM_NODELIST")
    if not nodelist:
        return None
    from .runner import local_gpu_count

    n = gpus_per_host or slurm_gpus(env) or local_gpu_count()
    return OrderedDict((h, n) for h in parse_slurm_nodelist(nodelist))


class SlurmRunner(_SchedulerRunner):
    """``srun``-backed launch (reference SlurmRunner,
    ``launcher/multinode_runner.py:307``): one task a GPU, exports carried by
    ``--export``, ranks from ``SLURM_PROCID``/``SLURM_LOCALID``."""

    backend_binary = "srun"

    def launch(self, user_cmd: List[str]) -> int:
        self._preflight()
        import tempfile

        tasks = self._tasks()
        # rank -> host placement must follow OUR host order (rank 0 binds
        # MASTER_ADDR = hosts[0]), but --nodelist places tasks in SLURM's
        # sorted node order.  SLURM_HOSTFILE + --distribution=arbitrary is
        # SLURM's contract for caller-ordered placement: task i runs on
        # line i of the file.
        hf = tempfile.NamedTemporaryFile("w", prefix="ds_tpu_slurm_hosts_",
                                         suffix=".txt", delete=False)
        hf.write("\n".join(tasks) + "\n")
        hf.close()
        srun = ["srun", "--nodes", str(len(self.hosts)), "--ntasks", str(len(tasks)),
                "--distribution", "arbitrary",
                "--export", ",".join(["ALL"] + [f"{k}={v}"
                                                for k, v in self.base_env.items()])]
        if getattr(self.args, "launcher_args", ""):
            srun += shlex.split(self.args.launcher_args)
        cmd = srun + ["bash", "-c", _rank_bootstrap_cmd(
            user_cmd, ["SLURM_PROCID"], ["SLURM_LOCALID"])]
        logger.info("launcher[slurm]: %s (SLURM_HOSTFILE=%s)",
                    shlex.join(cmd[:10]) + " ...", hf.name)
        env = dict(os.environ)
        env["SLURM_HOSTFILE"] = hf.name
        try:
            return subprocess.call(cmd, env=env)
        finally:
            try:
                os.unlink(hf.name)
            except OSError:
                pass


class MPIRunner(_SchedulerRunner):
    """``mpirun``-backed launch (reference OpenMPI/MPICH/IMPI runners,
    ``launcher/multinode_runner.py:107``): one slot a GPU.  OpenMPI
    (``--host h:n``, ``-x K=V``, ranks in ``OMPI_COMM_WORLD_RANK``/
    ``OMPI_COMM_WORLD_LOCAL_RANK``) or the Hydra launchers MPICH/Intel MPI
    (``-hosts h:n``, ``-genv K V``, ``PMI_RANK``/``MPI_LOCALRANKID``)."""

    backend_binary = "mpirun"

    def launch(self, user_cmd: List[str]) -> int:
        self._preflight()
        n = len(self._tasks())
        hosts = ",".join(f"{h}:{len(self.active[h])}" for h in self.hosts)
        flavor = getattr(self.args, "launcher", "openmpi")
        if flavor == "openmpi":
            cmd = ["mpirun", "-np", str(n), "--host", hosts]
            for k, v in self.base_env.items():
                cmd += ["-x", f"{k}={v}"]
            rank_vars = ["OMPI_COMM_WORLD_RANK", "PMI_RANK"]
            local_vars = ["OMPI_COMM_WORLD_LOCAL_RANK", "MPI_LOCALRANKID"]
        else:  # mpich / impi: Hydra process manager dialect
            cmd = ["mpirun", "-np", str(n), "-hosts", hosts]
            for k, v in self.base_env.items():
                cmd += ["-genv", k, v]
            rank_vars = ["PMI_RANK"]
            local_vars = ["MPI_LOCALRANKID"]
        if getattr(self.args, "launcher_args", ""):
            cmd += shlex.split(self.args.launcher_args)
        cmd += ["bash", "-c", _rank_bootstrap_cmd(user_cmd, rank_vars, local_vars)]
        logger.info("launcher[%s]: %s", flavor, shlex.join(cmd[:8]) + " ...")
        return subprocess.call(cmd)


class LocalRunner(MultiNodeRunner):
    """Every 'host' is this machine: one spawner a host as a local process
    (CI, laptops), the rendezvous on loopback whatever --master_addr said."""

    def launch(self, user_cmd: List[str]) -> int:
        procs = []
        for host in self.hosts:
            env = dict(os.environ)
            env.update(self.env_for(host))
            procs.append(subprocess.Popen(
                self.spawner_cmd(host, user_cmd, master_addr="127.0.0.1"), env=env))
        return wait_all_or_fail(procs)
