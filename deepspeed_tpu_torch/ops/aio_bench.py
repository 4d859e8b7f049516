"""NVMe/filesystem bandwidth bench for the native aio engine (counterpart
of ``deepspeed_tpu/ops/aio_bench.py``; reference ``csrc/aio/py_test``).

    python -m deepspeed_tpu_torch.ops.aio_bench --path DIR/aio.bin \\
        --size-mb 256 --threads 1 4 8 [--direct] [--dd]

Prints one JSON line per configuration:
    {"op": "read", "engine": "ds_aio", "threads": 4, "gbps": 2.31, ...}
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import time

import numpy as np

from .op_builder.host import AsyncIOBuilder, host_op


def bench_engine(path: str, size_mb: int, threads: int, direct: bool,
                 repeats: int = 3):
    lib = host_op(AsyncIOBuilder)
    nbytes = size_mb * (1 << 20)
    from ..runtime.swap_tensor import aligned_empty

    buf = aligned_empty((nbytes,), np.uint8)
    buf[:] = np.random.default_rng(0).integers(0, 255, nbytes, np.uint8)
    fd = int(lib.ds_aio_open(path.encode(), 1, int(direct)))
    if fd < 0:
        raise OSError(-fd, f"open {path}")
    got_direct = bool(lib.ds_aio_is_direct(fd))
    out = []
    try:
        for op in ("write", "read"):
            fn = lib.ds_aio_pwrite if op == "write" else lib.ds_aio_pread
            best = 0.0
            for _ in range(repeats):
                t0 = time.perf_counter()
                rc = fn(fd, buf.ctypes.data_as(ctypes.c_void_p), nbytes, 0, threads)
                if rc != 0:
                    raise OSError(-rc, f"aio {op}")
                if op == "write":
                    os.fsync(fd)
                best = max(best, nbytes / (time.perf_counter() - t0) / 1e9)
            out.append({"op": op, "engine": "ds_aio", "threads": threads,
                        "direct": got_direct, "size_mb": size_mb, "gbps": best})
    finally:
        lib.ds_aio_close(fd)
    return out


def bench_dd(path: str, size_mb: int):
    """Raw ``dd`` on the same volume, the reference comparison point."""
    out = []
    for op, cmd in (
            ("write", ["dd", "if=/dev/zero", f"of={path}", "bs=1M",
                       f"count={size_mb}", "conv=fdatasync"]),
            ("read", ["dd", f"if={path}", "of=/dev/null", "bs=1M",
                      f"count={size_mb}"])):
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, capture_output=True)
        dt = time.perf_counter() - t0
        out.append({"op": op, "engine": "dd", "size_mb": size_mb,
                    "gbps": size_mb * (1 << 20) / dt / 1e9})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", required=True)
    ap.add_argument("--size-mb", type=int, default=256)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--direct", action="store_true",
                    help="request O_DIRECT (buffered where the filesystem refuses)")
    ap.add_argument("--dd", action="store_true", help="also run the raw dd baseline")
    args = ap.parse_args(argv)
    results = []
    for t in args.threads:
        results += bench_engine(args.path, args.size_mb, t, args.direct)
    if args.dd:
        results += bench_dd(args.path + ".dd", args.size_mb)
        try:
            os.unlink(args.path + ".dd")
        except OSError:
            pass
    try:
        os.unlink(args.path)
    except OSError:
        pass
    for r in results:
        print(json.dumps(r))
    return results


if __name__ == "__main__":
    main()
