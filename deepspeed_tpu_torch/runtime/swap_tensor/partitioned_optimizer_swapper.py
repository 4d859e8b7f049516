"""Optimizer state on NVMe or in host RAM, stepped by the host Adam
(counterpart of ``deepspeed_tpu/runtime/swap_tensor/
partitioned_optimizer_swapper.py``; reference
``runtime/swap_tensor/partitioned_optimizer_swapper.py`` and
``optimizer_utils.py:OptimizerStateSwapper``).

The device computes the gradients; the fp32 masters and Adam moments live
in per-leaf files under ``swap_dir`` (:class:`SwappedAdamOptimizer`) or in
host memory (:class:`HostAdamOptimizer`).  ``step()`` over the files is a
software pipeline::

  read(i+1) submitted  ->  Adam on i (native SIMD kernel)
                       ->  writeback(i) submitted, waited one leaf later

so the reads of the next leaf and the writebacks of the previous one
overlap the current leaf's CPU work.  The Adam kernel writes the bf16
device view in the same pass (``ops/csrc/cpu_adam.cpp``); that view is
what goes back to the card, and the fp32 state never reaches it.

Buffers are numpy arrays aligned to 4096 bytes (:func:`aligned_empty`), so
the files can be opened with ``O_DIRECT`` (best effort: the engine falls
back to buffered I/O where the filesystem or an unaligned size refuses).
The arithmetic, the file names and the checkpoint hooks are the JAX
package's.
"""
from __future__ import annotations

import collections
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...ops.adam.cpu_adam import DeepSpeedCPUAdam
from ...ops.op_builder.host import AsyncIOBuilder, host_op
from ...utils.logging import logger

ALIGN = 4096


def aligned_empty(shape, dtype) -> np.ndarray:
    """An uninitialised C-contiguous array whose data start on a 4096-byte
    boundary (O_DIRECT's requirement for the buffer)."""
    dtype = np.dtype(dtype)
    n = int(math.prod(shape)) * dtype.itemsize
    raw = np.empty(n + ALIGN, np.uint8)
    off = (-raw.ctypes.data) % ALIGN
    return raw[off:off + n].view(dtype).reshape(shape)


class TensorSwapper:
    """Flat buffers in files, async through the native aio engine.  Files
    are opened once and kept as persistent fds (reference
    ``deepspeed_py_aio_handle.cpp`` holds one handle per swap file), at
    most ``MAX_OPEN_FDS`` at a time (LRU)."""

    MAX_OPEN_FDS = 256

    def __init__(self, swap_dir: str, aio_threads: int = 4):
        if not swap_dir:
            raise ValueError("NVMe swapping needs a swap directory (nvme_path)")
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        self.aio_threads = aio_threads
        self._lib = host_op(AsyncIOBuilder)
        self._shapes: Dict[str, Tuple[int, ...]] = {}
        self._dtypes: Dict[str, np.dtype] = {}
        self._fds: "collections.OrderedDict[str, int]" = collections.OrderedDict()
        self.bytes_read = self.bytes_written = 0

    def _path(self, name: str) -> str:
        return os.path.join(self.swap_dir, name.replace("/", "__") + ".swp")

    def _fd(self, name: str) -> int:
        fd = self._fds.get(name)
        if fd is not None:
            self._fds.move_to_end(name)
            return fd
        while len(self._fds) >= self.MAX_OPEN_FDS:
            _, old = self._fds.popitem(last=False)
            self._lib.ds_aio_close(old)
        # O_DIRECT where the filesystem takes it (the engine falls back to
        # buffered I/O otherwise, and per op where a size is unaligned)
        fd = int(self._lib.ds_aio_open(self._path(name).encode(), 1, 1))
        if fd < 0:
            raise OSError(-fd, f"aio open failed for {name}")
        self._fds[name] = fd
        return fd

    def close(self) -> None:
        for fd in self._fds.values():
            self._lib.ds_aio_close(fd)
        self._fds.clear()

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:   # noqa: BLE001 (interpreter teardown)
            pass

    def write(self, name: str, arr: np.ndarray) -> None:
        self._shapes[name] = arr.shape
        self._dtypes[name] = arr.dtype
        # a local keeps the (possible) contiguous copy alive over the call
        carr = np.ascontiguousarray(arr)
        rc = self._lib.ds_aio_pwrite(self._fd(name), carr.ctypes.data,
                                     carr.nbytes, 0, self.aio_threads)
        if rc != 0:
            raise OSError(-rc, f"aio write failed for {name}")
        self.bytes_written += carr.nbytes

    def submit_write(self, name: str, arr: np.ndarray) -> int:
        """``arr`` (contiguous) must stay alive until :meth:`wait`."""
        self._shapes[name] = arr.shape
        self._dtypes[name] = arr.dtype
        self.bytes_written += arr.nbytes
        return self._lib.ds_aio_submit_pwrite(
            self._fd(name), arr.ctypes.data, arr.nbytes, 0, self.aio_threads)

    def read(self, name: str, out: Optional[np.ndarray] = None) -> np.ndarray:
        out = self._alloc(name, out)
        rc = self._lib.ds_aio_pread(self._fd(name), out.ctypes.data,
                                    out.nbytes, 0, self.aio_threads)
        if rc != 0:
            raise OSError(-rc, f"aio read failed for {name}")
        self.bytes_read += out.nbytes
        return out

    def submit_read(self, name: str, out: Optional[np.ndarray] = None
                    ) -> Tuple[int, np.ndarray]:
        out = self._alloc(name, out)
        self.bytes_read += out.nbytes
        h = self._lib.ds_aio_submit_pread(self._fd(name), out.ctypes.data,
                                          out.nbytes, 0, self.aio_threads)
        return h, out

    def wait(self, handle: int) -> None:
        rc = self._lib.ds_aio_wait(handle)
        if rc != 0:
            raise OSError(-rc, "aio job failed")

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._shapes[name])

    def _alloc(self, name: str, out: Optional[np.ndarray]) -> np.ndarray:
        shape = self._shapes[name]
        dtype = self._dtypes.get(name, np.dtype(np.float32))
        if out is None:
            out = aligned_empty(shape, dtype)
        assert out.flags["C_CONTIGUOUS"] and out.dtype == dtype
        return out


class SwappedAdamOptimizer:
    """Adam whose fp32 masters and moments live on NVMe; pipelined step."""

    STATES = ("master", "exp_avg", "exp_avg_sq")

    def __init__(self, masters: Dict[str, np.ndarray], swap_dir: str,
                 aio_threads: int = 4, pipeline: bool = True, **adam_kwargs):
        self.swapper = TensorSwapper(swap_dir, aio_threads)
        self.adam = DeepSpeedCPUAdam(**adam_kwargs)
        self.names: List[str] = list(masters)
        self.pipeline = pipeline
        self.step_count = 0
        # per-leaf persistent host buffers (master, m, v, bf16): overlap is
        # only ever between different leaves, and step() drains every
        # writeback before it returns
        self._buffers: Dict[str, tuple] = {}
        total = 0
        for name, m in masters.items():
            m32 = np.ascontiguousarray(np.asarray(m, np.float32))
            self.swapper.write(f"{name}.master", m32)
            zeros = np.zeros_like(m32)
            self.swapper.write(f"{name}.exp_avg", zeros)
            self.swapper.write(f"{name}.exp_avg_sq", zeros)
            total += m32.nbytes * 3
        logger.info("SwappedAdamOptimizer: %d leaves, %.1f MB on %s",
                    len(self.names), total / 1e6, swap_dir)

    def _leaf_files(self, name: str) -> List[str]:
        return [f"{name}.{s}" for s in self.STATES]

    def _leaf_buffers(self, name):
        if name not in self._buffers:
            shape = self.swapper.shape(f"{name}.master")
            self._buffers[name] = (
                aligned_empty(shape, np.float32), aligned_empty(shape, np.float32),
                aligned_empty(shape, np.float32),
                aligned_empty((int(math.prod(shape)),), np.uint16))
        return self._buffers[name]

    def step(self, grads: Dict[str, np.ndarray], lr: Optional[float] = None
             ) -> Dict[str, np.ndarray]:
        """One Adam step over all leaves; returns the bf16 (uint16) views."""
        self.step_count += 1
        out: Dict[str, np.ndarray] = {}
        pending_w: List[Tuple[list, Any]] = []   # (handles, keepalive buffers)

        def read_leaf(name):
            bufs = self._leaf_buffers(name)
            return [self.swapper.submit_read(f, out=b)
                    for f, b in zip(self._leaf_files(name), bufs[:3])]

        next_hs = read_leaf(self.names[0]) if self.names else None
        for i, name in enumerate(self.names):
            hs, next_hs = next_hs, None
            if hs is None:   # not pipelined: read now
                hs = read_leaf(name)
            if self.pipeline and i + 1 < len(self.names):
                next_hs = read_leaf(self.names[i + 1])   # prefetch
            for h, _ in hs:
                self.swapper.wait(h)
            master, m, v = (b for _, b in hs)
            g = np.ascontiguousarray(np.asarray(grads[name], np.float32).reshape(-1))
            bf16 = self._leaf_buffers(name)[3]
            self.adam.step_flat(master.reshape(-1), g, m.reshape(-1), v.reshape(-1),
                                step=self.step_count, bf16_out=bf16, lr=lr)
            out[name] = bf16.reshape(master.shape)
            bufs = (master, m, v)
            handles = [self.swapper.submit_write(f, b)
                       for f, b in zip(self._leaf_files(name), bufs)]
            pending_w.append((handles, bufs))
            if not self.pipeline:
                for h in handles:
                    self.swapper.wait(h)
                pending_w.pop()
            while len(pending_w) > 1:   # at most one leaf's writebacks in flight
                for h in pending_w.pop(0)[0]:
                    self.swapper.wait(h)
        for handles, _ in pending_w:
            for h in handles:
                self.swapper.wait(h)
        return out

    def read_masters(self) -> Dict[str, np.ndarray]:
        return {n: self.swapper.read(f"{n}.master") for n in self.names}

    def read_state(self, name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(master, exp_avg, exp_avg_sq) of one leaf: the checkpoint hook."""
        return tuple(self.swapper.read(f) for f in self._leaf_files(name))

    def state_shape(self, name: str) -> Tuple[int, ...]:
        return self.swapper.shape(f"{name}.master")

    def write_state(self, name: str, master: np.ndarray, m: np.ndarray,
                    v: np.ndarray) -> None:
        """Overwrite one leaf's swap files: the restore hook."""
        for f, arr in zip(self._leaf_files(name), (master, m, v)):
            self.swapper.write(f, np.ascontiguousarray(arr, dtype=np.float32))

    def state_bytes(self) -> int:
        return sum(int(math.prod(self.state_shape(n))) * 4 * 3 for n in self.names)


class HostAdamOptimizer:
    """Adam whose fp32 masters and moments live in host RAM (ZeRO-Offload,
    reference ``runtime/zero/stage_1_and_2.py:1041-1124`` cpu_offload and
    the SIMD step of ``csrc/adam/cpu_adam.cpp``).  The surface of
    :class:`SwappedAdamOptimizer` without the disk: the state is resident
    (pageable memory) and the kernel updates it in place."""

    def __init__(self, masters: Dict[str, np.ndarray], copy: bool = True,
                 **adam_kwargs):
        self.adam = DeepSpeedCPUAdam(**adam_kwargs)
        self.names: List[str] = list(masters)
        self.step_count = 0
        self._state: Dict[str, list] = {}
        total = 0
        for name, m in masters.items():
            # a copy unless the caller hands its arrays over (``copy=False``:
            # a 7B model's masters are 27 GB, twice that at the handover)
            m32 = (np.array(m, np.float32, order="C") if copy
                   else np.ascontiguousarray(m, np.float32))
            # the moments are zero pages until the first step touches them;
            # the bf16 out buffer is made by the first whole-leaf step
            self._state[name] = [m32, np.zeros_like(m32), np.zeros_like(m32), None]
            total += m32.nbytes * 3
        logger.info("HostAdamOptimizer: %d leaves, %.1f MB resident in host RAM",
                    len(self.names), total / 1e6)

    def step(self, grads: Dict[str, np.ndarray], lr: Optional[float] = None
             ) -> Dict[str, np.ndarray]:
        """One in-place Adam step over all leaves; returns the bf16 views."""
        self.step_count += 1
        out: Dict[str, np.ndarray] = {}
        for name in self.names:
            out[name] = self.step_leaf(name, grads[name], lr)
        return out

    def step_leaf(self, name: str, grad, lr: Optional[float] = None) -> np.ndarray:
        """Leaf ``name``'s Adam step at the current ``step_count`` (the
        caller counts the step once for all leaves)."""
        master, m, v, bf16 = self._state[name]
        if bf16 is None:
            bf16 = self._state[name][3] = np.empty(master.size, np.uint16)
        g = grad if not isinstance(grad, np.ndarray) else np.ascontiguousarray(
            np.asarray(grad, np.float32).reshape(-1))
        self.adam.step_flat(master.reshape(-1), g, m.reshape(-1), v.reshape(-1),
                            step=self.step_count, bf16_out=bf16, lr=lr)
        return bf16.reshape(master.shape)

    def read_masters(self) -> Dict[str, np.ndarray]:
        return {n: self._state[n][0] for n in self.names}

    def read_state(self, name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        master, m, v, _ = self._state[name]
        return master, m, v

    def state_shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._state[name][0].shape)

    def write_state(self, name: str, master: np.ndarray, m: np.ndarray,
                    v: np.ndarray) -> None:
        s_master, s_m, s_v, _ = self._state[name]
        np.copyto(s_master, master.reshape(s_master.shape))
        np.copyto(s_m, m.reshape(s_m.shape))
        np.copyto(s_v, v.reshape(s_v.shape))

    def state_bytes(self) -> int:
        return sum(s[0].nbytes * 3 for s in self._state.values())
