"""The port's launcher CLI (counterpart of ``deepspeed_tpu/launcher/runner.py``;
reference ``launcher/runner.py:382``).

The unit of launch is **one process per GPU**, as upstream DeepSpeed's
``launcher/launch.py`` does it (the JAX package launches one controller
per host).  A host's slots are GPU indices; every rank gets the contract
``comm.init_distributed`` reads: ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` (plus ``LOCAL_WORLD_SIZE`` and
``DS_TPU_WORLD_INFO``, the active hosts and slots).  Ranks are numbered
host by host in the pool's order.

Resource discovery, in order:
  1. ``--hostfile`` (lines of ``hostname slots=N``; N = GPUs);
  2. ``--launcher slurm`` without a hostfile: the SLURM allocation's nodes
     (``multinode_runner.slurm_pool``);
  3. this host alone, with ``--num_gpus`` slots or every GPU it has.

Fan-out:
  - one local host        -> its ranks start here (``launch.start_local_ranks``);
  - several hosts         -> one per-node spawner a host (``python -m
                             deepspeed_tpu_torch.launcher.launch``) by ssh, or
                             one task a GPU by srun/mpirun
                             (``multinode_runner.py``);
  - ``--simulate N``      -> N local ranks on the CPU over gloo
                             (``DS_ACCELERATOR=cpu``, no card visible).

``--include``/``--exclude`` use the reference's filter grammar
(``runner.py:249``): ``host1@host2`` selects hosts, ``host1:0,2@host2:0-3``
selects GPUs; a host whose slots a filter narrowed gets
``CUDA_VISIBLE_DEVICES`` set to them, and its ``LOCAL_RANK`` indexes those.

``--elastic_restarts N`` runs every round under the restart supervisor
(``elasticity/supervisor.py``).  A rank that exits ``RC_PREEMPTED`` saved
at a step boundary its peers agreed on: the round waits for them and
returns ``RC_PREEMPTED``, which the supervisor relaunches.  The launcher
never touches CUDA: it counts GPUs through ``nvidia-smi``, in a process of
its own.
"""
from __future__ import annotations

import argparse
import base64
import json
import os
import shlex
import subprocess
import sys
import tempfile
import time
from collections import OrderedDict
from typing import List, Optional

from ..utils.logging import logger

# torch.distributed's default rendezvous port (upstream DeepSpeed's too)
DEFAULT_MASTER_PORT = 29500
# a rank's exit after the elastic agent saved at the agreed stop step
# (``elasticity.elastic_agent.RC_PREEMPTED``, EX_TEMPFAIL)
RC_PREEMPTED = 75
# seconds a survivor of a failed rank gets between SIGTERM and SIGKILL
KILL_GRACE_S = 15.0
SCHEDULERS = ("slurm", "openmpi", "impi", "mpich")
# options of the JAX launcher whose subsystem the port has not yet
POD_FLAGS = ("--pod_coord_dir", "--pod_lease", "--pod_miss_limit")
FLEET_FLAGS = ("--fleet", "--fleet_coord_dir", "--fleet_lease", "--fleet_miss_limit",
               "--fleet_routers", "--fleet_daemon")


def parse_args(args=None):
    p = argparse.ArgumentParser(
        prog="deepspeed_tpu_torch",
        description="deepspeed_tpu_torch launcher: one process per GPU",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-H", "--hostfile", default="/job/hostfile",
                   help="hostfile: lines of 'hostname slots=N' (N GPUs)")
    p.add_argument("-i", "--include", default="",
                   help="hosts/GPUs to include, e.g. 'h1@h2' or 'h1:0,1@h2:0-3'")
    p.add_argument("-e", "--exclude", default="",
                   help="hosts/GPUs to exclude (mutually exclusive with -i per host)")
    p.add_argument("--num_nodes", type=int, default=-1,
                   help="cap the number of hosts used (first N of the pool)")
    p.add_argument("--num_gpus", "--num_chips", dest="num_gpus", type=int,
                   default=-1, help="GPUs (ranks) per host: the first N")
    p.add_argument("--master_addr", default="",
                   help="rendezvous address; default = first host in the pool")
    p.add_argument("--master_port", type=int, default=DEFAULT_MASTER_PORT,
                   help="rendezvous port")
    p.add_argument("--launcher", default="ssh", choices=["ssh", "local"] + list(SCHEDULERS),
                   help="multinode backend: ssh fan-out, local subprocesses, "
                        "'slurm' = srun (the allocation's nodes without a "
                        "hostfile), 'openmpi'/'impi'/'mpich' = mpirun")
    p.add_argument("--launcher_args", default="",
                   help="extra args spliced into the selected backend's "
                        "command: ssh flags for ssh (e.g. '-p 2222'), "
                        "srun flags for slurm, mpirun flags for openmpi/mpich/impi")
    p.add_argument("--ssh_port", type=int, default=None)
    p.add_argument("--module", action="store_true",
                   help="run user_script as 'python -m <module>'")
    p.add_argument("--no_python", action="store_true",
                   help="exec user_script directly (no python interpreter)")
    p.add_argument("--simulate", type=int, default=0, metavar="N",
                   help="run N local ranks on the CPU over gloo (debug "
                        "data-parallel code without cards)")
    p.add_argument("--save_pid", action="store_true",
                   help="write the launcher's pid to $TMPDIR/ds_tpu_torch_launcher.pid")
    p.add_argument("--elastic_restarts", type=int, default=0, metavar="N",
                   help="elastic supervisor: relaunch the job up to N times "
                        "on failure/preemption, discovering the resources "
                        "again each round (0 = off); training scripts should "
                        "use elasticity.ElasticAgent so restarts resume from "
                        "the last committed checkpoint")
    p.add_argument("--elastic_backoff", type=float, default=3.0,
                   help="base seconds between elastic relaunches (grows "
                        "exponentially with consecutive failures, jittered)")
    p.add_argument("--elastic_backoff_max", type=float, default=60.0,
                   help="cap on the exponential relaunch backoff")
    p.add_argument("--elastic_zero_progress", type=int, default=0, metavar="K",
                   help="circuit breaker: stop relaunching after K "
                        "consecutive failed rounds with no checkpoint "
                        "progress (0 = off; needs --elastic_ckpt_dir)")
    p.add_argument("--elastic_ckpt_dir", default="",
                   help="checkpoint dir the training script writes; lets "
                        "the supervisor track committed-step progress so "
                        "productive restarts refresh the restart budget")
    for flag in POD_FLAGS:
        p.add_argument(flag, default=None, help="not ported yet: the pod "
                       "coordination store (ROADMAP queue 1, item 13)")
    for flag in FLEET_FLAGS:
        p.add_argument(flag, default=None, help="not ported yet: the serving "
                       "fleet (ROADMAP queue 1, item 14)",
                       **({"action": "store_const", "const": True}
                          if flag == "--fleet_daemon" else {}))
    p.add_argument("--force_multi", action="store_true",
                   help="use the multinode path even for a single local host")
    p.add_argument("user_script", help="training script (or module with --module)")
    p.add_argument("user_args", nargs=argparse.REMAINDER)
    parsed = p.parse_args(args)
    given = [f for f in POD_FLAGS if getattr(parsed, f[2:]) is not None]
    if given:
        p.error(f"{', '.join(given)}: the pod coordination store (heartbeat "
                "leases, dead-host exclusion, pod generations) is not ported "
                "yet (ROADMAP queue 1, item 13)")
    given = [f for f in FLEET_FLAGS if getattr(parsed, f[2:]) is not None]
    if given:
        p.error(f"{', '.join(given)}: the serving fleet is not ported yet "
                "(ROADMAP queue 1, item 14)")
    if parsed.elastic_zero_progress > 0 and not parsed.elastic_ckpt_dir:
        # without a progress source the breaker never arms: the job would
        # crash-loop through the whole restart budget undiagnosed
        p.error("--elastic_zero_progress needs --elastic_ckpt_dir (the "
                "breaker tracks committed checkpoint steps)")
    return parsed


def fetch_hostfile(path: str) -> "OrderedDict[str, int]":
    """Parse ``hostname slots=N`` lines; missing file -> empty pool."""
    if not os.path.isfile(path):
        return OrderedDict()
    pool: "OrderedDict[str, int]" = OrderedDict()
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            host = parts[0]
            slots = 1
            for tok in parts[1:]:
                if tok.startswith("slots="):
                    try:
                        slots = int(tok.split("=", 1)[1])
                    except ValueError:
                        raise ValueError(f"{path}:{ln}: bad slots in {line!r}")
                else:
                    raise ValueError(
                        f"{path}:{ln}: unrecognized token {tok!r} "
                        f"(expected 'slots=N')")
            if host in pool:
                raise ValueError(f"{path}:{ln}: duplicate host {host!r}")
            pool[host] = slots
    return pool


def _expand_slots(spec: str, nslots: int) -> List[int]:
    """'0,2' | '0-3' | '1,3-5' -> sorted slot indices, validated."""
    out = set()
    for piece in spec.split(","):
        piece = piece.strip()
        if not piece:
            continue
        if "-" in piece:
            lo, hi = piece.split("-", 1)
            out.update(range(int(lo), int(hi) + 1))
        else:
            out.add(int(piece))
    bad = [s for s in out if s < 0 or s >= nslots]
    if bad:
        raise ValueError(f"slot(s) {sorted(bad)} out of range [0,{nslots})")
    return sorted(out)


def parse_resource_filter(pool: "OrderedDict[str, int]", include: str = "",
                          exclude: str = "") -> "OrderedDict[str, List[int]]":
    """Apply the '@'-separated host[:slots] filter grammar to the pool.

    Returns host -> selected GPU indices.  A host may appear in include or
    exclude, not both; a slot-less exclude drops the whole host.
    """
    full: "OrderedDict[str, List[int]]" = OrderedDict(
        (h, list(range(n))) for h, n in pool.items())
    if include and exclude:
        inc_hosts = {t.split(":")[0] for t in include.split("@") if t}
        exc_hosts = {t.split(":")[0] for t in exclude.split("@") if t}
        both = inc_hosts & exc_hosts
        if both:
            raise ValueError(f"host(s) {sorted(both)} in both -i and -e")

    def _parse(filter_str):
        sel: "OrderedDict[str, Optional[List[int]]]" = OrderedDict()
        for term in filter_str.split("@"):
            term = term.strip()
            if not term:
                continue
            if ":" in term:
                host, slots = term.split(":", 1)
                host = host.strip()
                if host not in full:
                    raise ValueError(f"filter host {host!r} not in resource pool")
                sel[host] = _expand_slots(slots, pool[host])
            else:
                if term not in full:
                    raise ValueError(f"filter host {term!r} not in resource pool")
                sel[term] = None  # whole host
        return sel

    if include:
        inc = _parse(include)
        out: "OrderedDict[str, List[int]]" = OrderedDict()
        for h, slots in inc.items():
            out[h] = slots if slots is not None else full[h]
        return out
    if exclude:
        exc = _parse(exclude)
        out = OrderedDict()
        for h, slots in full.items():
            if h in exc:
                dropped = exc[h]
                if dropped is None:
                    continue  # whole host excluded
                keep = [s for s in slots if s not in dropped]
                if keep:
                    out[h] = keep
            else:
                out[h] = slots
        return out
    return full


def encode_world_info(active: "OrderedDict[str, List[int]]") -> str:
    return base64.urlsafe_b64encode(json.dumps(active).encode()).decode()


def decode_world_info(blob: str) -> "OrderedDict[str, List[int]]":
    return OrderedDict(json.loads(base64.urlsafe_b64decode(blob.encode())))


def narrowed_hosts(active, pool) -> List[str]:
    """Hosts whose GPU selection a filter or ``--num_gpus`` narrowed below
    the pool's slots: they run under ``CUDA_VISIBLE_DEVICES``."""
    return [h for h in active
            if pool.get(h) is not None and active[h] != list(range(pool[h]))]


def visible_devices(slots: List[int], env) -> str:
    """``CUDA_VISIBLE_DEVICES`` for a host's selected GPU indices, taken
    through an inherited ``CUDA_VISIBLE_DEVICES`` when there is one."""
    inherited = env.get("CUDA_VISIBLE_DEVICES")
    base = [d.strip() for d in inherited.split(",") if d.strip()] if inherited else None
    return ",".join(base[i] if base else str(i) for i in slots)


def local_gpu_count() -> int:
    """GPUs of this host, without loading the CUDA driver into this process:
    the entries of ``CUDA_VISIBLE_DEVICES`` when it is set, else the GPUs
    ``nvidia-smi`` lists; at least one slot (no ``nvidia-smi``: one), as the
    JAX launcher's single-host fallback."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return max(1, len([d for d in visible.split(",") if d.strip()]))
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return 1
    return max(1, len(out.stdout.split()))


def _build_user_cmd(args) -> List[str]:
    if args.no_python:
        cmd = [args.user_script]
    elif args.module:
        cmd = [sys.executable, "-u", "-m", args.user_script]
    else:
        cmd = [sys.executable, "-u", args.user_script]
    return cmd + list(args.user_args)


def wait_all_or_fail(procs, poll_s: float = 0.2, on_fail=None,
                     kill_grace_s: Optional[float] = None) -> int:
    """Wait on a set of processes; on the FIRST failed exit, terminate the
    survivors and return that exit code (a sequential ``wait`` loop would
    hang on an earlier-indexed process blocked in rendezvous while a later
    one has already died).  ``RC_PREEMPTED`` is no failure: that rank saved
    at a stop step its peers agreed on and stop at too, so they are waited
    for, however long their save takes, and the call returns
    ``RC_PREEMPTED`` once all have exited.  KeyboardInterrupt terminates
    everything and returns 130.  ``on_fail(idx, rc)`` is called for the
    root-cause process only — never for the SIGTERM-ed survivors.  Reaping
    escalates SIGTERM -> SIGKILL after ``kill_grace_s`` (``KILL_GRACE_S``):
    a survivor blocked inside a native collective (its peer just died)
    never runs the Python signal handler, so a plain ``wait()`` would hang
    the launcher forever."""
    grace = KILL_GRACE_S if kill_grace_s is None else kill_grace_s

    def _reap_all():
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + grace
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    try:
        while True:
            rcs = [p.poll() for p in procs]
            failed = [(i, rc) for i, rc in enumerate(rcs)
                      if rc not in (None, 0, RC_PREEMPTED)]
            if failed:
                _reap_all()
                idx, rc = failed[0]
                if on_fail is not None:
                    on_fail(idx, rc)
                return rc
            if all(rc is not None for rc in rcs):
                return RC_PREEMPTED if RC_PREEMPTED in rcs else 0
            time.sleep(poll_s)
    except KeyboardInterrupt:
        _reap_all()
        return 130


def _run_local(args, active, pool, simulate: bool = False) -> int:
    """This host's ranks, started here: the single-host path and
    ``--simulate`` (the CPU accelerator, no card)."""
    from .launch import start_local_ranks

    env = dict(os.environ)
    env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(args.master_port),
                "DS_TPU_WORLD_INFO": encode_world_info(active)})
    if simulate:
        env.update({"DS_ACCELERATOR": "cpu", "CUDA_VISIBLE_DEVICES": ""})
    elif narrowed_hosts(active, pool):
        env["CUDA_VISIBLE_DEVICES"] = visible_devices(active[list(active)[0]], env)
    cmd = _build_user_cmd(args)
    logger.info("launcher: %d local rank(s): %s", sum(map(len, active.values())),
                shlex.join(cmd))
    procs = start_local_ranks(cmd, active, node_rank=0, env=env)
    return wait_all_or_fail(
        procs, on_fail=lambda i, rc: logger.error(
            "launcher: local rank %d failed first with rc=%d", i, rc))


def main(args=None) -> int:
    args = parse_args(args)
    if args.save_pid:
        with open(os.path.join(tempfile.gettempdir(), "ds_tpu_torch_launcher.pid"),
                  "w") as f:
            f.write(str(os.getpid()))
    if args.elastic_restarts > 0:
        from ..elasticity.supervisor import Supervisor
        from ..resilience import checkpoint_progress_fn

        progress_fn = (checkpoint_progress_fn(args.elastic_ckpt_dir)
                       if args.elastic_ckpt_dir else None)
        # every attempt re-runs _dispatch, i.e. reads the hostfile and
        # discovers the pool again: a resized job relaunches at its new size
        return Supervisor(lambda _round: _dispatch(args),
                          max_restarts=args.elastic_restarts,
                          backoff_s=args.elastic_backoff,
                          backoff_max_s=args.elastic_backoff_max,
                          progress_fn=progress_fn,
                          zero_progress_limit=args.elastic_zero_progress).run()
    return _dispatch(args)


def _dispatch(args) -> int:
    """One discovery + launch round (the unit the elastic supervisor
    retries)."""
    if args.simulate > 0:
        active = OrderedDict([("localhost", list(range(args.simulate)))])
        return _run_local(args, active, {"localhost": args.simulate}, simulate=True)

    pool = fetch_hostfile(args.hostfile)
    gpus = args.num_gpus if args.num_gpus > 0 else None
    if not pool and args.launcher in SCHEDULERS:
        # the SLURM allocation's nodes; a hostfile, when present, wins so
        # operators can narrow the allocation
        from .multinode_runner import slurm_pool

        pool = slurm_pool(gpus_per_host=gpus) if args.launcher == "slurm" else None
        if not pool:
            raise RuntimeError(
                f"--launcher {args.launcher}: no hostfile at {args.hostfile!r}"
                + (" and no SLURM allocation (SLURM_JOB_NODELIST)"
                   if args.launcher == "slurm" else "")
                + " — an explicit multi-host launcher must not silently "
                "degrade to a single local process")
    if not pool:
        if args.include or args.exclude or args.num_nodes > 0:
            raise ValueError(
                "host filters given but no hostfile found at "
                f"{args.hostfile!r} (single-host fallback has no pool)")
        pool = OrderedDict([("localhost", gpus or local_gpu_count())])
    active = parse_resource_filter(pool, args.include, args.exclude)
    if args.num_nodes > 0:
        active = OrderedDict(list(active.items())[:args.num_nodes])
    if gpus:
        active = OrderedDict((h, s[:gpus]) for h, s in active.items())
    if not active:
        raise ValueError("resource filters selected zero hosts")

    hosts = list(active)
    multi = len(hosts) > 1 or args.force_multi
    if not multi and hosts[0] in ("localhost", "127.0.0.1"):
        return _run_local(args, active, pool)

    from .multinode_runner import LocalRunner, MPIRunner, SlurmRunner, SSHRunner

    # rendezvous = first ACTIVE host (filters may have excluded the pool's
    # first, and every rank must reach, and rank 0 bind, this address)
    master = args.master_addr or hosts[0]
    base_env = {"MASTER_ADDR": master, "MASTER_PORT": str(args.master_port),
                "WORLD_SIZE": str(sum(map(len, active.values()))),
                "DS_TPU_WORLD_INFO": encode_world_info(active)}
    if args.launcher == "slurm":
        runner = SlurmRunner(args, active, base_env, pool=pool)
    elif args.launcher in ("openmpi", "impi", "mpich"):
        runner = MPIRunner(args, active, base_env, pool=pool)
    elif args.launcher == "ssh":
        runner = SSHRunner(args, active, base_env, pool=pool)
    else:
        runner = LocalRunner(args, active, base_env, pool=pool)
    return runner.launch(_build_user_cmd(args))


if __name__ == "__main__":
    sys.exit(main())
