"""The per-node spawner (reference ``deepspeed/launcher/launch.py``): starts
this host's ranks, one process per GPU, and reaps them with
``wait_all_or_fail``.  The launcher runs it on every host of a multi-host
job (one ssh command a host); on a single host the launcher calls
``start_local_ranks`` itself.

    python -m deepspeed_tpu_torch.launcher.launch --world_info B64 \\
        --node_rank I --master_addr A --master_port P -- CMD ...

Rank ``r`` of host ``I`` is ``RANK = (GPUs of hosts before I) + r``; its
``LOCAL_RANK`` is ``r``, an index into the host's visible GPUs (the
launcher sets ``CUDA_VISIBLE_DEVICES`` where a filter narrowed them).

In pod mode (``DS_TPU_POD_COORD_DIR`` in its environment) every rank also
gets ``DS_TPU_POD_HOST``, this host's name in the launcher's pool.

SIGTERM to the spawner (a preemption notice to the host) is passed on to
the ranks, and the spawner waits for them however long their save takes:
they stop at the step they agree on, save and exit ``RC_PREEMPTED``.  The
ranks die with the spawner (``PR_SET_PDEATHSIG``): when the launcher ends
a spawner whose host outlived a failed peer, SIGKILL after its grace,
ranks blocked in a collective go too.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
from typing import Dict, List, Optional

from .runner import decode_world_info, reap_grace_s, wait_all_or_fail


def rank_envs(active, node_rank: int) -> List[Dict[str, str]]:
    """The rank contract of every local rank of host ``node_rank`` of
    ``active`` (host -> GPU indices): ``RANK``, ``LOCAL_RANK``,
    ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``NODE_RANK``."""
    hosts = list(active)
    world = sum(len(s) for s in active.values())
    offset = sum(len(active[h]) for h in hosts[:node_rank])
    local = len(active[hosts[node_rank]])
    return [{"RANK": str(offset + r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world),
             "LOCAL_WORLD_SIZE": str(local), "NODE_RANK": str(node_rank)}
            for r in range(local)]


def _die_with_parent() -> None:
    """In a child before its exec: SIGKILL it when its parent exits."""
    import ctypes

    PR_SET_PDEATHSIG = 1
    ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)


def start_local_ranks(cmd: List[str], active, node_rank: int,
                      env: Optional[Dict[str, str]] = None,
                      die_with_parent: bool = False) -> List[subprocess.Popen]:
    """Start host ``node_rank``'s ranks of ``active`` running ``cmd``, each
    with ``env`` (default: this process's) plus its rank contract."""
    base = dict(os.environ if env is None else env)
    extra = {"preexec_fn": _die_with_parent} if die_with_parent else {}
    return [subprocess.Popen(cmd, env={**base, **rank_env}, **extra)
            for rank_env in rank_envs(active, node_rank)]


def forward_sigterm(procs):
    """SIGTERM to this process reaches ``procs`` (which may be filled after
    the call) and no longer ends the wait for them; returns the handler it
    replaced."""

    def _forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    return signal.signal(signal.SIGTERM, _forward)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="deepspeed_tpu_torch.launcher.launch",
                                 description="start this host's ranks")
    ap.add_argument("--world_info", required=True,
                    help="base64 JSON of host -> GPU indices (the launcher's)")
    ap.add_argument("--node_rank", type=int, required=True)
    ap.add_argument("--master_addr", required=True)
    ap.add_argument("--master_port", type=int, required=True)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given")
    active = decode_world_info(args.world_info)
    if not 0 <= args.node_rank < len(active):
        ap.error(f"--node_rank {args.node_rank} outside the {len(active)} hosts")
    env = dict(os.environ)
    env.update({"MASTER_ADDR": args.master_addr, "MASTER_PORT": str(args.master_port),
                "DS_TPU_WORLD_INFO": args.world_info})
    if env.get("DS_TPU_POD_COORD_DIR"):   # pod mode: the ranks' host id
        env["DS_TPU_POD_HOST"] = list(active)[args.node_rank]

    procs: List[subprocess.Popen] = []
    previous = forward_sigterm(procs)
    try:
        procs.extend(start_local_ranks(cmd, active, args.node_rank, env,
                                       die_with_parent=True))
        return wait_all_or_fail(procs, kill_grace_s=reap_grace_s(env))
    finally:
        signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    sys.exit(main())
