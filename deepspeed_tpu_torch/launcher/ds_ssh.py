"""Run a command on every host of a hostfile (counterpart of
``deepspeed_tpu/launcher/ds_ssh.py``; reference ``bin/ds_ssh``).

    python -m deepspeed_tpu_torch.launcher.ds_ssh [-H hostfile] [-i/-e filters] -- CMD...

The launcher's ssh fan-out without the training contract, once per HOST —
for chores across a cluster ("pkill python", "ls ~/ckpts").
"""
from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys

from .multinode_runner import ssh_base_cmd
from .runner import fetch_hostfile, parse_resource_filter


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("ds_ssh")
    ap.add_argument("-H", "--hostfile", default="/job/hostfile")
    ap.add_argument("-i", "--include", default="")
    ap.add_argument("-e", "--exclude", default="")
    ap.add_argument("--ssh_port", type=int, default=22)
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="command to run on every host (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        ap.error("no command given")

    pool = fetch_hostfile(args.hostfile)
    if not pool:
        if args.include or args.exclude:
            # filters with no pool would be silently IGNORED — a typo'd -H
            # path must not turn an exclude-protected fleet command into an
            # unfiltered local one
            ap.error(f"hostfile {args.hostfile!r} not found/empty but "
                     "include/exclude filters were given")
        print("ds_ssh: no hostfile; running locally", file=sys.stderr)
        try:
            return subprocess.call(cmd)
        except FileNotFoundError:
            print(f"ds_ssh: {cmd[0]}: command not found", file=sys.stderr)
            return 127
    active = parse_resource_filter(pool, args.include, args.exclude)
    narrowed = [h for h, slots in active.items() if len(slots) != pool[h]]
    if narrowed:
        ap.error(f"slot-granular filters ({narrowed}) have no meaning here — "
                 "ds_ssh runs once per HOST; filter whole hosts "
                 "(e.g. -e hostname)")
    procs = []
    hosts = list(active)
    try:
        for host in hosts:
            if host in ("localhost", "127.0.0.1"):
                procs.append(subprocess.Popen(cmd))
            else:
                # one quoted remote command, run from the SAME cwd as the
                # local invocation; && (not ;) so a host missing that
                # directory fails loudly instead of running the chore
                # (possibly destructive, possibly relative-path) from $HOME
                remote = f"cd {shlex.quote(os.getcwd())} && {shlex.join(cmd)}"
                procs.append(subprocess.Popen(
                    ssh_base_cmd(args.ssh_port) + [host, remote]))
    except FileNotFoundError as e:
        for p in procs:
            p.terminate()
        print(f"ds_ssh: {e}", file=sys.stderr)
        return 127
    # fleet-chore semantics: run to completion EVERYWHERE and report
    # per-host exit codes (the launcher's fail-fast wait would SIGTERM the
    # other hosts on the first benign nonzero, e.g. `pkill` matching nothing)
    worst = 0
    try:
        for host, p in zip(hosts, procs):
            rc = p.wait()
            if rc != 0:
                print(f"ds_ssh: {host}: rc={rc}", file=sys.stderr)
                worst = worst or rc
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        print("ds_ssh: interrupted; local ssh processes terminated "
              "(remote commands already started may keep running)",
              file=sys.stderr)
        return 130
    return worst


if __name__ == "__main__":
    sys.exit(main())
