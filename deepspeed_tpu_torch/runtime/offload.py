"""Engine-side offload: where the fp32 optimizer state rests (counterpart
of ``deepspeed_tpu/runtime/offload.py``; reference
``runtime/zero/stage_1_and_2.py`` cpu_offload, ``runtime/zero/stage3.py:502``
offload_optimizer/offload_param, ``runtime/swap_tensor/``).

Three placements of the masters and the Adam moments:

  streamed   the state rests in pinned host memory; the engine's own
             optimizer chain updates it a leaf at a time on the card, each
             leaf copied in on a side stream (the next leaf's copy under
             this leaf's update) and copied back (:class:`StreamedState`);
  host_step  the state rests in host RAM; the card computes the gradients
             and the host's SIMD Adam (``ops/csrc/cpu_adam.cpp``) steps the
             masters, writing the bf16 compute view in the same pass
             (:class:`HostSteppedOffload`);
  nvme       as host_step, with the state in per-leaf files through the
             aio engine and its read/compute/writeback pipeline.

:func:`resolve_offload_mode` owns the choice, the JAX package's rule
included; the engine holds no offload policy of its own.  The exchange of
``host_step`` runs in chunks of ``CHUNK`` elements through two pinned
staging buffers each way: the download of chunk k+1 and the upload of
chunk k-1 run on a copy stream while the host steps chunk k, so host RAM
holds the state and four chunks, not a second copy of the gradients.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.logging import log_dist

# elements a staging buffer holds (64 MiB of fp32)
CHUNK = 1 << 24


def resolve_offload_mode(config, dp_world: int, use_master_weights: bool,
                         fp16_enabled: bool, has_compression: bool) -> str:
    """``"none" | "streamed" | "host_step" | "nvme"`` for this config.

    ``device=cpu`` with one data shard: streaming would still bring the
    whole fp32 state to the card inside the step, so the host step runs
    unless ``host_step=False`` asks for streaming (JAX's auto rule)."""
    oo = config.zero_config.offload_optimizer
    dev = oo.device if oo is not None else "none"
    if dev == "nvme":
        return "nvme"
    if dev != "cpu":
        return "none"
    if oo.host_step is not None:
        return "host_step" if bool(oo.host_step) else "streamed"
    opt_cfg = config.optimizer
    opt_type = (opt_cfg.type if opt_cfg else "adamw").lower()
    host_step = (dp_world == 1 and use_master_weights and not fp16_enabled
                 and not has_compression and opt_type in ("adam", "adamw"))
    return "host_step" if host_step else "streamed"


def adam_kwargs(config) -> dict:
    """The host Adam's hyperparameters from the optimizer block."""
    opt_cfg = config.optimizer
    opt_type = (opt_cfg.type if opt_cfg else "adamw").lower()
    p = dict(opt_cfg.params) if opt_cfg else {}
    return dict(lr=p.get("lr", 1e-3), betas=tuple(p.get("betas", (0.9, 0.999))),
                eps=p.get("eps", 1e-8), weight_decay=p.get("weight_decay", 0.0),
                adamw_mode=bool(p.get("adam_w_mode", opt_type == "adamw")))


def _pinned(n: int, dtype, device) -> torch.Tensor:
    t = torch.empty(n, dtype=dtype)
    return t.pin_memory() if device.type == "cuda" else t


def _u16(t: torch.Tensor) -> np.ndarray:
    """A bf16 CPU tensor's bits as a uint16 numpy view (no copy)."""
    return t.view(torch.int16).numpy().view(np.uint16)


class HostSteppedOffload:
    """The host (or NVMe) optimizer state and the card <-> host exchange of
    the gradient-only path (ZeRO-Offload host step / ZeRO-Infinity's
    optimizer offload).  ``names`` are the parameter paths of the leaves
    this rank steps (its master shards under ZeRO)."""

    def __init__(self, config, masters: Dict[str, np.ndarray], storage: str,
                 device: torch.device, fp16_enabled: bool = False):
        if fp16_enabled:
            raise NotImplementedError(
                "host-stepped offload currently pairs with bf16 (fp16 dynamic "
                "loss scaling would need host-side overflow handling)")
        # the host Adam sweep and the aio threads inherit this affinity
        from ..utils.numa import bind_for_offload

        bind_for_offload()
        opt_cfg = config.optimizer
        opt_type = (opt_cfg.type if opt_cfg else "adamw").lower()
        if opt_type not in ("adam", "adamw"):
            raise NotImplementedError(
                f"host-stepped offload runs the native CPU Adam kernel; "
                f"optimizer {opt_type!r} is not supported on the host path")
        from .swap_tensor import HostAdamOptimizer, SwappedAdamOptimizer

        self.storage = storage
        self.device = device
        self.names: List[str] = list(masters)
        oo = config.zero_config.offload_optimizer
        kw = adam_kwargs(config)
        if storage == "cpu":   # the engine's fresh arrays are handed over
            self.optimizer = HostAdamOptimizer(masters, copy=False, **kw)
            log_dist("ZeRO-Offload: optimizer state in host RAM "
                     f"({self.optimizer.state_bytes() / 1e9:.2f} GB), host SIMD "
                     f"Adam on {self.optimizer.adam.num_threads} threads", ranks=[0])
        else:
            self.optimizer = SwappedAdamOptimizer(
                masters, oo.nvme_path,
                aio_threads=max(config.aio.thread_count, config.aio.queue_depth // 2, 1),
                pipeline=bool(oo.pipeline_read or oo.pipeline_write), **kw)
            log_dist(f"ZeRO-Infinity: optimizer state on NVMe at {oo.nvme_path} "
                     f"({self.optimizer.state_bytes() / 1e9:.2f} GB)", ranks=[0])
        self._stage = None
        self.stats: Dict[str, float] = {}

    # -- the per-step exchange -------------------------------------------
    def _staging(self):
        if self._stage is None:
            dev = self.device
            self._stage = ([_pinned(CHUNK, torch.float32, dev) for _ in range(2)],
                           [_pinned(CHUNK, torch.bfloat16, dev) for _ in range(2)])
        return self._stage

    def host_step(self, grads: List[torch.Tensor], outs: List[torch.Tensor],
                  lr: float) -> None:
        """One Adam step of every leaf: ``grads[i]`` (fp32 on the card,
        unscaled and clipped) comes down, the host steps leaf
        ``names[i]``, and its new bf16 values go up into ``outs[i]`` (a
        contiguous bf16 tensor on the card, written in place)."""
        t0 = time.perf_counter()
        self.optimizer.step_count += 1
        if self.storage != "cpu":
            self._nvme_step(grads, outs, lr)
        else:
            self._ram_step(grads, outs, lr)
        self.stats["step_s"] = time.perf_counter() - t0

    def _ram_step(self, grads, outs, lr) -> None:
        opt = self.optimizer
        down_b = up_b = 0
        adam_s = 0.0
        cuda = self.device.type == "cuda"
        g_stage, b_stage = self._staging()
        stream = torch.cuda.Stream(self.device) if cuda else None
        timing = []   # (start, end) events of the copies, by direction
        for name, g, out in zip(self.names, grads, outs):
            master = opt._state[name][0].reshape(-1)
            m = opt._state[name][1].reshape(-1)
            v = opt._state[name][2].reshape(-1)
            gf, of = g.reshape(-1), out.view(-1)
            n = gf.numel()
            chunks = [(a, min(a + CHUNK, n)) for a in range(0, n, CHUNK)]
            if cuda:
                stream.wait_stream(torch.cuda.current_stream(self.device))
            ev_down = [None, None]
            ev_up = [None, None]

            def down(k):
                a, b = chunks[k]
                slot = k % 2
                if not cuda:
                    g_stage[slot][:b - a].copy_(gf[a:b])
                    return
                with torch.cuda.stream(stream):
                    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    s.record(stream)
                    g_stage[slot][:b - a].copy_(gf[a:b], non_blocking=True)
                    e.record(stream)
                ev_down[slot] = e
                timing.append(("down", s, e))

            down(0)
            for k, (a, b) in enumerate(chunks):
                slot = k % 2
                if k + 1 < len(chunks):
                    down(k + 1)
                if cuda:
                    ev_down[slot].synchronize()
                    if ev_up[slot] is not None:
                        ev_up[slot].synchronize()
                t1 = time.perf_counter()
                opt.adam.step_flat(master[a:b], g_stage[slot][:b - a], m[a:b], v[a:b],
                                   step=opt.step_count, bf16_out=b_stage[slot][:b - a],
                                   lr=lr)
                adam_s += time.perf_counter() - t1
                if not cuda:
                    of[a:b].copy_(b_stage[slot][:b - a])
                    continue
                with torch.cuda.stream(stream):
                    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    s.record(stream)
                    of[a:b].copy_(b_stage[slot][:b - a], non_blocking=True)
                    e.record(stream)
                ev_up[slot] = e
                timing.append(("up", s, e))
            down_b += n * 4
            up_b += n * 2
            if cuda:   # g may be freed once its chunks are down
                stream.synchronize()
        if cuda:
            torch.cuda.current_stream(self.device).wait_stream(stream)
        self._record(down_b, up_b, adam_s, timing)

    def _nvme_step(self, grads, outs, lr) -> None:
        """The NVMe store's pipelined step (read/compute/writeback) over
        the whole leaves: their gradients come down first."""
        t1 = time.perf_counter()
        host, n = {}, 0
        for name, g in zip(self.names, grads):
            host[name] = g.detach().float().cpu().numpy().reshape(-1)
            n += g.numel()
        down_s = time.perf_counter() - t1
        opt = self.optimizer
        opt.step_count -= 1   # SwappedAdamOptimizer.step counts the step itself
        sw = opt.swapper
        r0, w0 = sw.bytes_read, sw.bytes_written
        t1 = time.perf_counter()
        bf16 = opt.step(host, lr=lr)
        adam_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        for name, out in zip(self.names, outs):
            out.view(-1).copy_(torch.from_numpy(bf16[name].reshape(-1)).view(torch.bfloat16))
        up_s = time.perf_counter() - t1
        self.stats.update(download_gbps=n * 4 / max(down_s, 1e-9) / 1e9,
                          upload_gbps=n * 2 / max(up_s, 1e-9) / 1e9,
                          adam_s=adam_s, nvme_read_gb=(sw.bytes_read - r0) / 1e9,
                          nvme_write_gb=(sw.bytes_written - w0) / 1e9,
                          nvme_gbps=(sw.bytes_read - r0 + sw.bytes_written - w0)
                          / max(adam_s, 1e-9) / 1e9)

    def _record(self, down_b, up_b, adam_s, timing) -> None:
        ms = {"down": 0.0, "up": 0.0}
        for kind, s, e in timing:
            ms[kind] += s.elapsed_time(e)
        self.stats.update(
            adam_s=adam_s,
            download_gbps=down_b / (ms["down"] / 1e3) / 1e9 if ms["down"] else None,
            upload_gbps=up_b / (ms["up"] / 1e3) / 1e9 if ms["up"] else None)

    def read_masters(self) -> Dict[str, np.ndarray]:
        return self.optimizer.read_masters()

    # -- checkpointing -----------------------------------------------------
    # streamed leaf by leaf (one master/m/v triple resident at a time), so a
    # save never holds the whole 12 B/param state twice
    def save_state_files(self, out_dir: str) -> None:
        save_offload_state_files(out_dir, self.names, self.optimizer.read_state,
                                 int(self.optimizer.step_count))

    def load_state_files(self, in_dir: str) -> None:
        shapes = {n: self.optimizer.state_shape(n) for n in self.names}
        self.optimizer.step_count = load_offload_state_files(
            in_dir, self.names, self.optimizer.write_state, expected_shapes=shapes)


class StreamedState:
    """Where the masters and the optimizer state rest between steps, as the
    engine's update loops see them, a (master, state) pair at a time.
    Parked (ZeRO-Offload's streamed placement on a card): in pinned host
    memory; :meth:`fetch` brings a pair to the card on a side stream, ahead
    of its use, and :meth:`put` copies the updated pair back in place.  Not
    parked (the state on the device; on a CPU device host memory is the
    device's, and the JAX package likewise skips the placement on its CPU
    backend): both pass the tensors through.  ``masters`` says whether the
    masters are parked with the state (fp32 compute keeps them on the card:
    they are the params)."""

    def __init__(self, device: torch.device, parked: bool = True, masters: bool = True):
        self.device = device
        self.parked = parked and device.type == "cuda"
        self.masters = masters
        self.stream = torch.cuda.Stream(device) if self.parked else None

    def park(self, tree):
        """``tree``'s tensors in pinned host memory."""
        if not self.parked:
            return tree
        return _map_tensors(tree, lambda x: x.detach().to("cpu").pin_memory())

    def fetch(self, master, state) -> tuple:
        """``(master, state)`` on the card, copied asynchronously (ready
        once :meth:`ready` returns)."""
        if not self.parked:
            return master, state
        with torch.cuda.stream(self.stream):
            def dev(obj):
                return _map_tensors(obj, lambda t: t.to(self.device, non_blocking=True))

            return (dev(master) if self.masters else master), dev(state)

    def ready(self) -> None:
        if self.parked:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def put(self, host: tuple, new: tuple) -> tuple:
        """What the trees hold after an update of the pair ``host`` made
        ``new``: where parked, ``new`` copied into ``host``'s tensors (async
        on the side stream, after the update) and ``host`` with ``new``'s
        step counts; else ``new``."""
        if not self.parked:
            return new
        (host_m, host_s), (new_m, new_s) = host, new
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            _copy_into(host_s, new_s, self.stream)
            if self.masters:
                _copy_into(host_m, new_m, self.stream)
        return (host_m if self.masters else new_m), _with_counts(host_s, new_s)

    def finish(self) -> None:
        if self.parked:
            self.stream.synchronize()


def _with_counts(host, dev):
    """``host`` (a state of pinned tensors) with ``dev``'s Python members
    (the step counts) taken over."""
    import dataclasses

    if isinstance(host, torch.Tensor):
        return host
    if dataclasses.is_dataclass(host) and not isinstance(host, type):
        return dataclasses.replace(host, **{f.name: _with_counts(getattr(host, f.name),
                                                                 getattr(dev, f.name))
                                            for f in dataclasses.fields(host)})
    if isinstance(host, dict):
        return {k: _with_counts(host[k], dev[k]) for k in host}
    if isinstance(host, (list, tuple)):
        return type(host)(_with_counts(a, b) for a, b in zip(host, dev))
    return dev


def _map_tensors(obj, fn):
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _map_tensors(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _copy_into(host, dev, stream) -> None:
    import dataclasses

    if isinstance(host, torch.Tensor):
        dev.record_stream(stream)   # freed only once the copy has read it
        host.copy_(dev, non_blocking=True)
    elif dataclasses.is_dataclass(host) and not isinstance(host, type):
        for f in dataclasses.fields(host):
            _copy_into(getattr(host, f.name), getattr(dev, f.name), stream)
    elif isinstance(host, dict):
        for k in host:
            _copy_into(host[k], dev[k], stream)
    elif isinstance(host, (list, tuple)):
        for a, b in zip(host, dev):
            _copy_into(a, b, stream)


def save_offload_state_files(out_dir: str, names, read_state, step_count: int) -> None:
    """One .npy per (leaf, state) and ``meta.json``, written in turn: the
    extra host memory is one leaf's fp32 triple.  The JAX package's files."""
    os.makedirs(out_dir, exist_ok=True)
    for i, name in enumerate(names):
        master, m, v = read_state(name)
        np.save(os.path.join(out_dir, f"{i:05d}.master.npy"), np.asarray(master, np.float32))
        np.save(os.path.join(out_dir, f"{i:05d}.exp_avg.npy"), np.asarray(m, np.float32))
        np.save(os.path.join(out_dir, f"{i:05d}.exp_avg_sq.npy"), np.asarray(v, np.float32))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"step_count": int(step_count), "names": list(names)}, f)


def load_offload_state_files(in_dir: str, names, write_state,
                             expected_shapes: Optional[dict] = None) -> int:
    """The inverse of :func:`save_offload_state_files`; returns the saved
    step count.  The leaf list and each leaf's shape must be the engine's
    (a model of another width would otherwise pass the name check)."""
    with open(os.path.join(in_dir, "meta.json")) as f:
        meta = json.load(f)
    if list(meta["names"]) != list(names):
        raise ValueError(
            "offload checkpoint param-tree mismatch: checkpoint has "
            f"{len(meta['names'])} leaves, engine has {len(names)}")
    for i, name in enumerate(names):
        master = np.load(os.path.join(in_dir, f"{i:05d}.master.npy"))
        if expected_shapes is not None and \
                tuple(master.shape) != tuple(expected_shapes[name]):
            raise ValueError(
                f"offload checkpoint shape mismatch at {name!r}: checkpoint "
                f"{master.shape}, engine {tuple(expected_shapes[name])}")
        write_state(name, master,
                    np.load(os.path.join(in_dir, f"{i:05d}.exp_avg.npy")),
                    np.load(os.path.join(in_dir, f"{i:05d}.exp_avg_sq.npy")))
    return int(meta["step_count"])
