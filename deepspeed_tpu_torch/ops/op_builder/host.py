"""Host C++ builds: the CPU Adam and the aio engine (counterparts of the JAX
package's ``CPUAdamBuilder`` and ``AsyncIOBuilder``, reference
``op_builder/cpu_adam.py`` and ``op_builder/async_io.py``).

``g++ -O3 -shared -fPIC -std=c++17`` of ``ops/csrc/<source>.cpp`` plus the
op's flags (``-fopenmp``, and ``-march=native`` where a probe compiles it;
``-pthread``), at first use, into ``ops/csrc/build/<name>_<hash>.so``
beside the CUDA builds: the hash covers the source and the flags, so an
edited source rebuilds.  The libraries export a C ABI and are bound with
``ctypes``.  A failed build raises with the compiler's standard error;
nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Type

from .builder import BUILD_DIR, CSRC_DIR


class HostBuildError(RuntimeError):
    pass


def compiler() -> Optional[str]:
    return shutil.which("g++")


_MARCH_OK: Optional[bool] = None
_NATIVE_ARCH: Optional[str] = None


def native_arch() -> str:
    """What ``-march=native`` resolves to here (e.g. ``sapphirerapids``): it
    joins the library's hash, so a library built for another CPU is never
    loaded."""
    global _NATIVE_ARCH
    if _NATIVE_ARCH is None:
        _NATIVE_ARCH = ""
        cxx = compiler()
        if cxx is not None:
            res = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                                 capture_output=True, text=True)
            for line in res.stdout.splitlines():
                if line.strip().startswith("-march="):
                    _NATIVE_ARCH = line.split()[-1]
                    break
    return _NATIVE_ARCH


def march_native_ok() -> bool:
    """Whether ``-march=native`` compiles here (probed once a process)."""
    global _MARCH_OK
    if _MARCH_OK is None:
        cxx = compiler()
        if cxx is None:
            _MARCH_OK = False
            return False
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = BUILD_DIR / f"_probe_{os.getpid()}.cpp"
        src.write_text("int main(){return 0;}\n")
        try:
            _MARCH_OK = subprocess.run(
                [cxx, "-march=native", str(src), "-o", f"{src}.out"],
                capture_output=True).returncode == 0
        finally:
            for p in (src, BUILD_DIR / f"{src.name}.out"):
                try:
                    os.unlink(p)
                except OSError:
                    pass
    return _MARCH_OK


class HostOpBuilder:
    NAME = "base"
    SOURCES: List[str] = []

    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.log = ""

    def extra_flags(self) -> List[str]:
        return []

    def is_compatible(self) -> bool:
        return compiler() is not None

    def _sources(self):
        return [CSRC_DIR / s for s in self.SOURCES]

    def library_path(self):
        h = hashlib.sha256()
        for p in self._sources():
            h.update(p.read_bytes())
        h.update(" ".join(self.extra_flags()).encode())
        return BUILD_DIR / f"{self.NAME}_{h.hexdigest()[:16]}.so"

    def is_built(self) -> bool:
        return self.library_path().is_file()

    def build(self):
        target = self.library_path()
        if target.is_file():
            return target
        cxx = compiler()
        if cxx is None:
            raise HostBuildError(f"{self.NAME}: no C++ compiler (g++) on PATH")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a per-process name, renamed into place: concurrent first builds
        # (test workers, ranks) never see a half-written library
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", *self.extra_flags(),
               *map(str, self._sources()), "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        self.log = res.stdout + res.stderr
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise HostBuildError(f"{self.NAME} build failed (exit {res.returncode}):\n"
                                 f"{res.stderr[-4000:]}")
        os.replace(tmp, target)
        return target

    def bind(self, lib: ctypes.CDLL) -> None:
        """Subclasses declare argtypes/restype here."""

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self.bind(lib)
                self._lib = lib
            return self._lib


_F = ctypes.POINTER(ctypes.c_float)
_U16 = ctypes.POINTER(ctypes.c_uint16)


class CPUAdamBuilder(HostOpBuilder):
    """``ops/csrc/cpu_adam.cpp``: the fused OpenMP+SIMD Adam/AdamW step."""

    NAME = "cpu_adam"
    SOURCES = ["cpu_adam.cpp"]

    def extra_flags(self):
        return ["-fopenmp"] + (["-march=native"] if march_native_ok() else [])

    def library_path(self):
        path = super().library_path()
        if not march_native_ok():
            return path
        arch = hashlib.sha256(native_arch().encode()).hexdigest()[:6]
        return path.with_name(f"{path.stem}_{arch}.so")

    def bind(self, lib):
        lib.cpu_adam_step.argtypes = [
            _F, _F, _F, _F, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _U16]
        lib.cpu_adam_step.restype = None
        lib.cpu_adagrad_step.argtypes = [
            _F, _F, _F, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, _U16]
        lib.cpu_adagrad_step.restype = None
        lib.cpu_l2_norm.argtypes = [_F, ctypes.c_int64]
        lib.cpu_l2_norm.restype = ctypes.c_double
        lib.cpu_adam_num_threads.argtypes = []
        lib.cpu_adam_num_threads.restype = ctypes.c_int


class AsyncIOBuilder(HostOpBuilder):
    """``ops/csrc/aio.cpp``: the thread-pool pread/pwrite engine."""

    NAME = "async_io"
    SOURCES = ["aio.cpp"]

    def extra_flags(self):
        return ["-pthread"]

    def bind(self, lib):
        lib.ds_aio_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.ds_aio_open.restype = ctypes.c_int64
        lib.ds_aio_is_direct.argtypes = [ctypes.c_int64]
        lib.ds_aio_is_direct.restype = ctypes.c_int
        lib.ds_aio_close.argtypes = [ctypes.c_int64]
        lib.ds_aio_close.restype = ctypes.c_int
        lib.ds_aio_wait.argtypes = [ctypes.c_int64]
        lib.ds_aio_wait.restype = ctypes.c_int
        for name in ("ds_aio_submit_pwrite", "ds_aio_submit_pread"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int]
            fn.restype = ctypes.c_int64
        for name in ("ds_aio_pwrite", "ds_aio_pread"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int]
            fn.restype = ctypes.c_int


_SHARED: Dict[str, HostOpBuilder] = {}


def host_op(builder: Type[HostOpBuilder]) -> ctypes.CDLL:
    """The loaded library of ``builder`` (one instance a process)."""
    if builder.NAME not in _SHARED:
        _SHARED[builder.NAME] = builder()
    return _SHARED[builder.NAME].load()


ALL_HOST_OPS: Dict[str, Type[HostOpBuilder]] = {
    CPUAdamBuilder.NAME: CPUAdamBuilder, AsyncIOBuilder.NAME: AsyncIOBuilder}
