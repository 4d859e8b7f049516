"""Collective micro-benchmarks (counterpart of
``deepspeed_tpu/comm/benchmark.py``; reference
``benchmarks/communication/run_all.py``).

Times each collective of the ``comm`` facade over the whole world and
reports latency, algorithm bandwidth and bus bandwidth.  ``size`` is the
op's whole tensor, as nccl-tests counts it: the tensor every rank
reduces (all-reduce), the input each rank reduce-scatters (1/n comes
out), the output of an all-gather (each rank brings 1/n), the tensor
each rank exchanges or sends (all-to-all, broadcast, ppermute).  algbw =
size / time, busbw = algbw times the ring factor below.  (The JAX
package counts n times the block each device holds for every op, which
for the two reductions is n times the reduced tensor.)

  all_reduce      busbw = algbw * 2(n-1)/n
  all_gather      busbw = algbw *  (n-1)/n
  reduce_scatter  busbw = algbw *  (n-1)/n
  all_to_all      busbw = algbw *  (n-1)/n
  broadcast       busbw = algbw *  (n-1)/n
  ppermute        busbw = algbw

Run one process per device::

    torchrun --nproc-per-node N -m deepspeed_tpu_torch.comm.benchmark \\
        [--op all] [--minsize 15] [--maxsize 27]

(sizes are powers of two in bytes); rank 0 prints the table.
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict

import torch

BUSBW_FACTOR: Dict[str, Callable[[int], float]] = {
    "all_reduce": lambda n: 2 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "broadcast": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
}


def _programs(axis):
    from . import comm

    return {
        "all_reduce": lambda x: comm.all_reduce(x, comm.SUM, axis),
        "all_gather": lambda x: comm.all_gather(x, axis),
        "reduce_scatter": lambda x: comm.reduce_scatter(x, axis),
        "all_to_all": lambda x: comm.all_to_all(x, axis),
        "broadcast": lambda x: comm.broadcast(x, 0, axis),
        "ppermute": lambda x: comm.send_recv_next(x, axis),
    }


def run_op(op: str, global_bytes: int, trials: int = 20, warmups: int = 3,
           dtype=torch.float32, device=None):
    """Time one collective on a tensor of ``global_bytes`` over the world;
    returns a result dict (the same on every rank: the slowest rank's
    time)."""
    from ..accelerator import get_accelerator, resolve_device
    from ..parallel.mesh import MESH_AXES
    from . import comm

    axis = MESH_AXES   # every rank
    n = comm.get_axis_size(axis)
    device = resolve_device(device)
    elem = torch.empty((), dtype=dtype).element_size()
    # a multiple of n elements, so the n-way splits are exact
    count = -(-max(global_bytes // elem, n) // n) * n
    fn = _programs(axis)[op]
    # an all-gather's input is 1/n of its output; every other op's input
    # is the whole tensor
    x = torch.ones(count // n if op == "all_gather" else count, dtype=dtype,
                   device=device)
    accel = get_accelerator()
    for _ in range(warmups):
        fn(x)
    comm.barrier()
    accel.synchronize()
    start, end = accel.event(), accel.event()
    start.record()
    for _ in range(trials):
        fn(x)
    end.record()
    end.synchronize()
    dt = start.elapsed_time(end) / 1e3 / trials
    dt = float(comm.all_reduce(torch.tensor([dt], dtype=torch.float64, device=device),
                               comm.MAX, axis))
    payload = count * elem
    algbw = payload / dt
    return {"op": op, "size_bytes": payload, "n_devices": n,
            "latency_us": dt * 1e6, "algbw_gbps": algbw / 1e9,
            "busbw_gbps": algbw * BUSBW_FACTOR[op](n) / 1e9}


def run_sweep(ops=None, min_pow: int = 15, max_pow: int = 27, trials: int = 20,
              print_table: bool = True, device=None):
    from . import comm

    ops = ops or list(BUSBW_FACTOR)
    rows = []
    for op in ops:
        for p in range(min_pow, max_pow + 1, 3):
            rows.append(run_op(op, 1 << p, trials=trials, device=device))
    if print_table and comm.get_rank() == 0:
        hdr = (f"{'op':<16}{'size':>12}{'lat(us)':>12}{'algbw GB/s':>12}"
               f"{'busbw GB/s':>12}")
        print(hdr)
        print("-" * len(hdr))
        for r in rows:
            print(f"{r['op']:<16}{r['size_bytes']:>12}{r['latency_us']:>12.1f}"
                  f"{r['algbw_gbps']:>12.2f}{r['busbw_gbps']:>12.2f}")
    return rows


def main(argv=None):
    from . import comm

    ap = argparse.ArgumentParser(prog="deepspeed_tpu_torch.comm.benchmark")
    ap.add_argument("--op", default="all", choices=["all"] + list(BUSBW_FACTOR))
    ap.add_argument("--minsize", type=int, default=15, help="log2 min bytes")
    ap.add_argument("--maxsize", type=int, default=27, help="log2 max bytes")
    ap.add_argument("--trials", type=int, default=20)
    args = ap.parse_args(argv)
    comm.init_distributed()
    ops = list(BUSBW_FACTOR) if args.op == "all" else [args.op]
    run_sweep(ops, args.minsize, args.maxsize, args.trials)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
