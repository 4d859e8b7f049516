"""Fleet member daemon entry point (counterpart of the JAX package's
``tools/fleet_member.py``, which imports JAX).

Runs ONE :class:`~.fleet.FleetMember` in this process, coupled to its
router by nothing but the coordination store: it drains the assignment and
control channels, pumps its engine, publishes results, progress and its
lease, and exits on a ``shutdown`` verb (or engine death).  SIGKILLing this
process is a fleet event like any other: the lease lapses, the router fails
the in-flight work over from the journal, and results published before the
kill stay claimable.

Started by ``python -m deepspeed_tpu_torch.launcher --fleet N --fleet_daemon``
(which exports the ``DS_TPU_FLEET_*`` contract read here as flag defaults)
or by hand::

    python -m deepspeed_tpu_torch.inference.fleet_member \\
        --engine_id engine0 --coord_dir /mnt/shared/fleet [--device cpu]

It serves the deterministic ``tiny`` ``CausalLM`` in fp32 (the torch
generator seeded with 0), as the JAX entry point serves its tiny model: a
deployment wires its own model and params the same way, through
:func:`warm_up` and :func:`serve_member`.  It runs on the card unless
``--device cpu`` (or ``DS_ACCELERATOR=cpu``) says otherwise.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Optional


def _env(name, default=None):
    v = os.environ.get(name)
    return v if v not in (None, "") else default


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.inference.fleet_member",
        description="one fleet member daemon, coupled to its router through "
                    "the coordination store")
    p.add_argument("--engine_id", default=_env("DS_TPU_FLEET_ENGINE_ID"),
                   help="this member's engine id (fleet-unique); env "
                        "fallback DS_TPU_FLEET_ENGINE_ID")
    p.add_argument("--coord_dir", default=_env("DS_TPU_FLEET_COORD_DIR"),
                   help="coordination store root shared with the router; "
                        "env fallback DS_TPU_FLEET_COORD_DIR")
    p.add_argument("--lease_s", type=float,
                   default=float(_env("DS_TPU_FLEET_LEASE", 5.0)),
                   help="member lease period (env DS_TPU_FLEET_LEASE)")
    p.add_argument("--b_slots", type=int, default=2)
    p.add_argument("--page_size", type=int, default=8)
    p.add_argument("--max_model_len", type=int, default=64)
    p.add_argument("--max_restarts", type=int, default=5,
                   help="warm-restart budget before the member writes its "
                        "dead marker and exits")
    p.add_argument("--max_ticks", type=int, default=None,
                   help="optional daemon round budget")
    p.add_argument("--idle_sleep_s", type=float, default=0.01,
                   help="sleep between idle rounds (0 = spin)")
    p.add_argument("--ready_file", default=None,
                   help="write this path once the daemon is serving (the "
                        "launcher's startup handshake)")
    p.add_argument("--device", default=None,
                   help="cuda (default, unless DS_ACCELERATOR=cpu) or cpu")
    args = p.parse_args(argv)
    if not args.engine_id:
        p.error("--engine_id (or DS_TPU_FLEET_ENGINE_ID) is required")
    if not args.coord_dir:
        p.error("--coord_dir (or DS_TPU_FLEET_COORD_DIR) is required")
    return args


def warm_up(engine) -> None:
    """Serve one greedy and one sampled request on ``engine`` (a
    ``ServingEngine``) before the member's first beat: the first prefill
    and decode ticks (on the card: the first prefill and the first replay
    of the captured decode graph, K4 inside) otherwise stall the daemon
    loop inside its first assignment, and a sub-second lease lapses on a
    healthy member."""
    import numpy as np

    from .sampling import SamplingParams
    from .serving import Request

    ids = np.arange(1, 7, dtype=np.int32)
    engine.run([
        Request(rid="__warm_g__", input_ids=ids, max_new_tokens=2),
        Request(rid="__warm_s__", input_ids=ids, max_new_tokens=2,
                sampling=SamplingParams(temperature=1.0, top_k=8, top_p=0.9,
                                        seed=0))])


def serve_member(engine_id: str, supervisor, coord_dir: str, lease_s: float = 5.0,
                 idle_sleep_s: float = 0.01, max_ticks: Optional[int] = None,
                 ready_file: Optional[str] = None,
                 on_round: Optional[Callable[[int], None]] = None):
    """Run a warmed ``supervisor`` as fleet member ``engine_id`` on the file
    store at ``coord_dir`` until a ``shutdown`` verb, engine death or
    ``max_ticks`` rounds: advertise at once, write ``ready_file``, then
    loop the daemon (``on_round(rounds)`` after each round).  Returns
    ``(member, daemon, rounds)``.  ``DS_TPU_STORE_FAULTS``, when set, puts
    this member's fault program between the daemon and the store."""
    from ..elasticity import FileCoordinationStore, maybe_faulty
    from .fleet import FleetMember
    from .fleet_daemon import FleetMemberDaemon

    store = maybe_faulty(FileCoordinationStore(coord_dir), client=engine_id)
    member = FleetMember(engine_id, supervisor, store, lease_s=lease_s)
    member.beat(force=True)   # advertise at once: the router may be up
    daemon = FleetMemberDaemon(member, store, idle_sleep_s=idle_sleep_s)
    if ready_file:
        tmp = f"{ready_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(engine_id)
        os.replace(tmp, ready_file)
    rounds = 0
    while not daemon.shutdown:
        pending = daemon.poll_once()
        rounds += 1
        if on_round is not None:
            on_round(rounds)
        if max_ticks is not None and rounds >= max_ticks:
            break
        if pending == 0 and daemon.idle_sleep_s > 0:
            time.sleep(daemon.idle_sleep_s)
    return member, daemon, rounds


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    import deepspeed_tpu_torch
    from ..accelerator.real_accelerator import resolve_device
    from ..models import CausalLM

    device = resolve_device(args.device)
    model = CausalLM("tiny", dtype=torch.float32)
    params = model.init_fn(torch.Generator(device=device).manual_seed(0),
                           device=device, dtype=torch.float32)
    engine = deepspeed_tpu_torch.init_inference(model, config={"dtype": "float32"},
                                                params=params, device=device)
    sup = engine.supervised_serving(
        max_restarts=args.max_restarts, b_slots=args.b_slots,
        page_size=args.page_size, max_model_len=args.max_model_len)
    warm_up(sup.engine)
    member, daemon, rounds = serve_member(
        args.engine_id, sup, args.coord_dir, lease_s=args.lease_s,
        idle_sleep_s=args.idle_sleep_s, max_ticks=args.max_ticks,
        ready_file=args.ready_file)
    print(f"fleet_member[{args.engine_id}]: exit after {rounds} round(s), "
          f"alive={member.alive}", flush=True)
    return 0 if member.alive or daemon.shutdown else 1


if __name__ == "__main__":
    sys.exit(main())
