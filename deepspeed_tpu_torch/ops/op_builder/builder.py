"""Kernel builder: compiles ``ops/csrc/*.cu`` with ``nvcc`` at first use and
loads the shared library with ``ctypes`` (plain C entry points, no PyTorch
headers, so a build takes seconds rather than minutes).

Each source builds into ``ops/csrc/build/<name>_<hash>.so``, where the hash
covers the source text, the headers beside it and the compiler flags: an
edited source rebuilds, an unchanged one loads the library already there.
A failed build raises with nvcc's standard error.  Nothing is downloaded and
no prebuilt binary ships with the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda "
            "and $PATH): the port's CUDA kernels build on the machine with "
            "the card")
    return found


class KernelBuilder:
    """One ``.cu`` source -> one shared library, built once per content hash.

    ``build()`` compiles (or finds the cached library) and returns its path;
    ``load()`` builds if needed and returns the ``ctypes.CDLL``.  ``log``
    holds nvcc's output of the last compile (``-Xptxas=-v``: registers,
    shared memory and spills per kernel); ``build_seconds`` its wall time.
    """

    def __init__(self, name: str, source: str):
        self.name = name
        self.source = CSRC_DIR / source
        self.flags = NVCC_FLAGS
        self.log = ""
        self.build_seconds = 0.0
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def _digest(self) -> str:
        h = hashlib.sha256()
        h.update(self.source.read_bytes())
        for hdr in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(hdr.name.encode())
            h.update(hdr.read_bytes())
        h.update(" ".join(self.flags).encode())
        return h.hexdigest()[:16]

    def library_path(self) -> Path:
        return BUILD_DIR / f"{self.name}_{self._digest()}.so"

    def _command(self, out: Path) -> List[str]:
        return [find_nvcc(), *self.flags, "-I", str(CSRC_DIR), "-o", str(out),
                str(self.source)]

    def build(self) -> Path:
        """Compile unless the library for this content hash exists; the
        output is renamed into place, so a concurrent builder sees all or
        nothing."""
        target = self.library_path()
        if target.is_file():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        res = subprocess.run(self._command(tmp), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.log = res.stdout
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed to build {self.source.name} "
                f"(exit {res.returncode}):\n{res.stdout}")
        os.replace(tmp, target)
        return target

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(str(self.build()))
            return self._lib

