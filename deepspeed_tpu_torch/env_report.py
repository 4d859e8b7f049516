"""``ds_report`` for the port (counterpart of ``deepspeed_tpu/env_report.py``;
reference ``deepspeed/env_report.py``): the software stack, the devices
and each op builder's status, so a bug report carries the environment.

    python -m deepspeed_tpu_torch.env_report [--hide_operator_status]

It reports torch, CUDA, nvcc, Triton and CUTLASS's headers, NCCL and the
devices, each kernel source (K1-K4, ``ops/op_builder/builder.py``) and host
op (``ops/op_builder/host.py``) with whether a library for its current
content hash is built.  It builds no op (naming the CPU Adam library runs
the host compiler's one-line ``-march=native`` probe), and runs without a
card (and says so).
"""
from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
from typing import List, Tuple

GREEN_OK = "\033[92m[OKAY]\033[0m"
RED_NO = "\033[93m[NO]\033[0m"
CUTLASS_INCLUDE = "/usr/local/cutlass/include"
# which TPU kernels each CUDA source carries
KERNELS = {"flash_attention_fwd": "K1", "flash_attention_bwd": "K2, K3",
           "decode_attention": "K4"}


def _ver(mod: str) -> str:
    try:
        m = importlib.import_module(mod)
        return getattr(m, "__version__", "unknown")
    except Exception:
        return "not installed"


def op_status() -> List[Tuple[str, str, bool, bool, str]]:
    """(name, source, compatible, built, library) of every op builder; the
    library named is the one for the current content hash (nothing is
    built here)."""
    from .ops.kernels import decode_attention, flash_attention
    from .ops.op_builder import ALL_HOST_OPS, find_nvcc
    from .ops.op_builder.host import compiler

    try:
        find_nvcc()
        nvcc = True
    except RuntimeError:
        nvcc = False
    rows = []
    for b in flash_attention.builders() + decode_attention.builders():
        lib = b.library_path()
        rows.append((f"{b.name} ({KERNELS[b.name]})", b.source.name, nvcc,
                     lib.is_file(), lib.name))
    for name, cls in ALL_HOST_OPS.items():
        b = cls()
        lib = b.library_path()
        rows.append((f"host.{name}", ", ".join(b.SOURCES), compiler() is not None,
                     lib.is_file(), lib.name))
    return rows


def toolchain_report() -> List[str]:
    import torch

    from .ops.op_builder import find_nvcc

    lines = [f"torch ................ {torch.__version__} (CUDA {torch.version.cuda})"]
    try:
        nvcc = find_nvcc()
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        lines.append(f"nvcc ................. {nvcc}: {out[-1] if out else '?'}")
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        lines.append(f"nvcc ................. not found ({e})".splitlines()[0])
    lines.append(f"triton ............... {_ver('triton')}")
    cutlass = os.environ.get("CUTLASS_INCLUDE", CUTLASS_INCLUDE)
    found = os.path.isfile(os.path.join(cutlass, "cutlass", "cutlass.h"))
    lines.append(f"CUTLASS headers ...... {cutlass} "
                 f"({'found' if found else 'not found'})")
    lines.append(f"numpy ................ {_ver('numpy')}")
    lines.append(f"python ............... {sys.version.split()[0]}")
    return lines


def devices_report() -> List[str]:
    """NCCL and the CUDA devices, or the note that there is no card."""
    import torch

    if not torch.cuda.is_available():
        return ["no CUDA device: torch.cuda.is_available() is False "
                "(this report ran without a card)"]
    try:
        v = torch.cuda.nccl.version()   # (major, minor, patch[, suffix]); an int before
        nccl = ".".join(map(str, v)) if isinstance(v, tuple) else str(v)
    except (AttributeError, RuntimeError) as e:
        nccl = f"unavailable ({e})"
    lines = [f"NCCL ................. {nccl}",
             f"devices .............. {torch.cuda.device_count()}"]
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        lines.append(f"  [{i}] {p.name}, sm_{p.major}{p.minor}, "
                     f"{p.total_memory / 2 ** 30:.1f} GiB, {p.multi_processor_count} SMs")
    return lines


def main(args=None) -> int:
    ap = argparse.ArgumentParser(prog="ds_report")
    ap.add_argument("--hide_operator_status", action="store_true")
    opts = ap.parse_args(args)

    import deepspeed_tpu_torch

    print("-" * 66)
    print("deepspeed_tpu_torch op report (CUDA kernels and host ops)")
    print("-" * 66)
    if not opts.hide_operator_status:
        print(f"{'op name':<34}{'compatible':<14}{'built':<9}library")
        print("-" * 66)
        for name, source, compat, built, lib in op_status():
            print(f"{name:<34}{GREEN_OK if compat else RED_NO:<23}"
                  f"{GREEN_OK if built else RED_NO:<18}{lib} <- {source}")
    print("-" * 66)
    print("General environment:")
    print(f"deepspeed_tpu_torch .. {deepspeed_tpu_torch.__version__} "
          f"({deepspeed_tpu_torch.__path__[0]})")
    for line in toolchain_report():
        print(line)
    print("-" * 66)
    print("Device inventory:")
    for line in devices_report():
        print(line)
    print("-" * 66)
    return 0


if __name__ == "__main__":
    sys.exit(main())
