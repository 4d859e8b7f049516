"""Checkpointing on ``torch.distributed.checkpoint`` (the counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/orbax_engine.py``, the default
engine).

The directory layout keeps the JAX package's names::

    save_dir/
      latest                  # text file with the newest committed tag
      <tag>/                  # default tag: global_step{N}
        state/                # DCP files of the flat state dict below
        client_state.json     # engine counters + user client_state
        ds_config.json        # config snapshot
        manifest.json         # resilience/integrity.py: the commit marker

The saved state is the whole ``TrainState`` and the engine's dropout
generator, flattened to one dict keyed by path ('/'-joined): ``step``,
``params/...`` (compute precision), ``master_params/...`` (fp32 masters),
``opt_state/...`` (the optimizer chain's states, counts included),
``scaler/...`` (the loss scaler's fields) and ``rng/dropout`` (the
generator's ``get_state()``).  Python numbers are stored as 0-d tensors
(float64, int64 or bool), so every value comes back exactly and a resumed
run continues bit for bit.

A data-parallel engine (``runtime/zero``) saves its shards: every leaf
of the params, the masters and the optimizer state goes in as a DTensor
with the plan's placements over the engine's ranks, every rank writes its
own shards (DCP writes a replicated value once), and rank 0 writes the
sidecars, then, after a barrier, the manifest and ``latest``.  Where ZeRO
and tensor parallelism shard one dim, a rank holds a ZeRO piece within
its model-axis shard (model-major, JAX's ``('model', 'data')``), while
DTensor cuts a dim sharded over several mesh dims in mesh-dim order; so
the DTensors live on a mesh of the same ranks whose dims put 'model'
ahead of the ZeRO axes (``CKPT_AXES``, :func:`_ckpt_mesh`), and the
chunks' global offsets describe the bytes each rank holds.  A leaf whose
model-axis shards are padded (uneven) is saved whole at its true shape,
gathered on every rank when the state is flattened and written once,
and cut back to each rank's padded piece on load, so the padding never
reaches the files.  DCP's
planning runs over a gloo group of its own (``_ckpt_group``), so an async
commit thread never shares a group with the training step's collectives.
A load restores in place into a state dict built from the live engine
(JAX's "restore against target"); DCP reshards by global offsets, so a
checkpoint saved at world N loads at world M, and a one-device engine
(no process group) reads a sharded checkpoint whole.

Host-stepped offload and ZeRO-Infinity keep the fp32 masters and the
moments outside the state: they go beside it, one .npy a leaf and state,
streamed a leaf at a time (``offload_optimizer/``, per rank above one
data rank: ``offload_optimizer/rank<r>``), the JAX package's files.  The
1-bit optimizers' per-rank state (error buffers; 0/1 Adam's moments,
accumulators, drifted masters and counters) goes to ``comm_state/
rank<r>.pt``; the DCP masters of a 0/1 Adam engine are the synced ones
(the masters less the accumulated local update), the JAX engine's
meaning.  A partial load (``load_module_only``,
``load_optimizer_states=False``) of an offload engine is refused, as
there.  ``client_state.json`` also carries the curriculum's state under
the JAX package's keys (``data_sampler``: the loader's sampler;
``curriculum``: the legacy scheduler), restored on load, and the state
dict progressive layer drop's host generator (``rng/pld``).

The fault-injection sites sit where the JAX engine has them: ``ckpt.save``
before any file of the tag is written, ``ckpt.publish_latest`` just before
``latest`` moves (the synchronous and the background commit share
:func:`commit_tag`), and ``ckpt.load`` before the tag is verified.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .checkpoint_engine import CheckpointEngine
from ...resilience.fault_injection import (SITE_CKPT_LOAD, SITE_CKPT_SAVE,
                                           SITE_LATEST_PUBLISH, maybe_fire)
from ...resilience.integrity import (LATEST_FILE, build_manifest,
                                     mark_incomplete, read_latest,
                                     verify_checkpoint_dir, write_manifest)
from ...utils.logging import log_dist, logger

CHECKPOINT_VERSION = "1.0"
STATE_DIR = "state"
_WRITE_THREADS = 8


def _dcp():
    # without a process group DCP saves and loads in this process alone
    # (and says so once, in a warning)
    import torch.distributed.checkpoint as dcp

    return dcp


class DCPCheckpointEngine(CheckpointEngine):
    """``save`` writes a flat dict of tensors (DTensors for shards);
    ``load`` fills ``target`` (the same keys, tensors of the saved global
    shapes and dtypes) in place.  ``process_group``: the ranks that save
    and load together (None: this process alone, or the default group)."""

    def __init__(self, config_params=None, process_group=None):
        super().__init__(config_params)
        self.process_group = process_group

    def save(self, state_dict: Dict[str, torch.Tensor], path: str) -> None:
        dcp = _dcp()
        dcp.save(state_dict, storage_writer=dcp.FileSystemWriter(
            path, thread_count=_WRITE_THREADS), process_group=self.process_group)

    def load(self, path: str, target: Dict[str, torch.Tensor] = None):
        dcp = _dcp()
        dcp.load(target, storage_reader=dcp.FileSystemReader(path),
                 process_group=self.process_group)
        return target


# ---------------------------------------------------------------------------
# The engine's state as one flat dict, and back
# ---------------------------------------------------------------------------

def flatten_state(obj: Any, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """Tensors of ``obj`` (nested dicts, tuples, dataclasses) into ``out``
    under '/'-joined paths; Python numbers as 0-d tensors; None skipped."""
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            flatten_state(getattr(obj, f.name), f"{prefix}/{f.name}", out)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            flatten_state(obj[k], f"{prefix}/{k}", out)
    elif isinstance(obj, (list, tuple)):
        for i, x in enumerate(obj):
            flatten_state(x, f"{prefix}/{i}", out)
    elif isinstance(obj, bool):
        out[prefix] = torch.tensor(obj)
    elif isinstance(obj, int):
        out[prefix] = torch.tensor(obj, dtype=torch.int64)
    elif isinstance(obj, float):
        out[prefix] = torch.tensor(obj, dtype=torch.float64)
    elif obj is not None:
        raise TypeError(f"cannot checkpoint {prefix} of type {type(obj).__name__}")


def restore_state(template: Any, prefix: str, flat: Dict[str, torch.Tensor]) -> Any:
    """``template``'s structure with its values from ``flat`` (the inverse
    of :func:`flatten_state`)."""
    if isinstance(template, torch.Tensor):
        value = flat[prefix]
        return value.to_local() if hasattr(value, "to_local") else value
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: restore_state(getattr(template, f.name), f"{prefix}/{f.name}", flat)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: restore_state(v, f"{prefix}/{k}", flat) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(restore_state(x, f"{prefix}/{i}", flat)
                              for i, x in enumerate(template))
    if isinstance(template, (bool, int, float)):
        return type(template)(flat[prefix].item())
    return template


def engine_state_dict(engine, module: bool = True, rest: bool = True,
                      optimizer: bool = True) -> Dict[str, torch.Tensor]:
    """The engine's state as a flat dict: the weights (``module``), the step,
    scaler and dropout generator (``rest``) and the optimizer state
    (``optimizer``).  Tensors are the live ones (this rank's shards for a
    data-parallel engine: :func:`as_dtensors` wraps them)."""
    state, out = engine.state, {}
    pld = getattr(engine, "pld_generator", None)
    if state is None:   # ZeRO-Infinity: the whole state is in the offload files
        if rest:
            out["rng/dropout"] = engine.generator.get_state()
        return out
    if rest and pld is not None:   # progressive layer drop's host generator
        out["rng/pld"] = pld.get_state()
    if module:
        flatten_state(state.params, "params", out)
        flatten_state(state.master_params, "master_params", out)
    if rest:
        flatten_state(state.step, "step", out)
        flatten_state(state.scaler, "scaler", out)
        out["rng/dropout"] = engine.generator.get_state()
    if optimizer:
        flatten_state(state.opt_state, "opt_state", out)
    if module and _zero_one(engine) is not None:
        # the synced masters: each rank's drift is its own state (comm_state/)
        zo = _zero_one(engine)
        from ...utils.tree import tree_flatten_with_path

        key = "master_params" if state.master_params is not None else "params"
        for (path, _), acc in zip(tree_flatten_with_path(getattr(state, key)), zo.acc):
            out[f"{key}/{path}"] = (out[f"{key}/{path}"].float() - acc).to(
                out[f"{key}/{path}"].dtype)
    part = engine.partition
    if part is not None and any(part.uneven(i) for i in range(len(part.paths))):
        for key in sorted(out):   # collective: the same order on every rank
            hit = part.leaf_for(key)
            if hit is not None and out[key].dim() and part.uneven(hit[0]):
                out[key] = part.whole_true(hit[0], hit[1], out[key])
    return out


# the checkpoint mesh's dims: MESH_AXES with 'model' ahead of the ZeRO axes
CKPT_AXES = ("pipe", "data_outer", "model", "data", "expert", "seq")


def _ckpt_mesh(engine, device_type: Optional[str] = None):
    """The engine's ranks as a ``DeviceMesh`` over ``CKPT_AXES`` on
    ``device_type`` (default: the engine's); it only places chunks, so it
    makes no process groups."""
    from torch.distributed.device_mesh import DeviceMesh

    from ...parallel.mesh import MESH_AXES

    device_type = device_type or engine.mesh.device_type
    cache = engine.__dict__.setdefault("_ckpt_meshes", {})
    if device_type not in cache:
        ranks = engine.mesh.mesh.permute([MESH_AXES.index(a) for a in CKPT_AXES])
        try:
            cache[device_type] = DeviceMesh(device_type, ranks.contiguous(),
                                            mesh_dim_names=CKPT_AXES,
                                            _init_backend=False)
        except TypeError:   # a torch without _init_backend: make its groups
            cache[device_type] = DeviceMesh(device_type, ranks.contiguous(),
                                            mesh_dim_names=CKPT_AXES)
    return cache[device_type]


def as_dtensors(engine, flat: Dict[str, torch.Tensor],
                device_type: Optional[str] = None) -> Dict:
    """``flat`` with every parameter-shaped value (params, masters, the
    optimizer's per-parameter state) a DTensor of its plan placement over
    the checkpoint mesh on ``device_type`` (default: the engine's);
    unchanged for a one-device engine."""
    part = engine.partition
    if part is None:
        return flat
    from torch.distributed.tensor import DTensor

    from ...parallel.mesh import MESH_AXES

    mesh = _ckpt_mesh(engine, device_type)
    out = {}
    for key, t in flat.items():
        hit = part.leaf_for(key)
        if hit is None or t.dim() == 0:
            out[key] = t
            continue
        i, placements = hit
        shape = part.global_shapes[i]
        placements = tuple(placements[MESH_AXES.index(a)] for a in CKPT_AXES)
        if part.uneven(i):   # whole at its true shape (engine_state_dict)
            from torch.distributed.tensor import Replicate

            placements, shape = (Replicate(),) * len(CKPT_AXES), part.true_shapes[i]
        stride = torch.empty(shape, device="meta").stride()
        out[key] = DTensor.from_local(t, mesh, placements, run_check=False,
                                      shape=torch.Size(shape), stride=stride)
    return out


def _zero_one(engine):
    err = getattr(engine, "_comm_error", None)
    return err if err is not None and hasattr(err, "acc") else None


def _offload_of(engine):
    return getattr(engine, "_offload", None) or getattr(engine, "_param_offload", None)


def _rank_dir(engine, base: str) -> str:
    """Per-rank state above one data rank (each holds its own)."""
    if engine.dp_world > 1 or getattr(engine, "tp", 0) > 1:
        from ... import comm

        return os.path.join(base, f"rank{comm.get_rank()}")
    return base


def _save_side_state(engine, ckpt_dir: str) -> None:
    """The offload files and the 1-bit per-rank state, beside the DCP state."""
    off = _offload_of(engine)
    if off is not None:
        off.save_state_files(_rank_dir(engine, os.path.join(ckpt_dir, "offload_optimizer")))
    err = getattr(engine, "_comm_error", None)
    if err is not None:
        from ... import comm

        d = os.path.join(ckpt_dir, "comm_state")
        os.makedirs(d, exist_ok=True)
        state = engine.state
        side = {"comm_error": err}
        if _zero_one(engine) is not None:   # this rank's drifted masters
            side["masters"] = (state.master_params if state.master_params is not None
                               else state.params)
        torch.save(side, os.path.join(d, f"rank{comm.get_rank() if engine.distributed else 0}.pt"))


def _load_side_state(engine, ckpt_dir: str) -> None:
    off = _offload_of(engine)
    if off is not None:
        d = _rank_dir(engine, os.path.join(ckpt_dir, "offload_optimizer"))
        if not os.path.isdir(d):
            raise FileNotFoundError(
                f"checkpoint {ckpt_dir} has no offload_optimizer/ but this "
                "engine runs a host-stepped offload optimizer — it was saved "
                "without offload or from an incompatible config")
        off.load_state_files(d)
    if getattr(engine, "_comm_error", None) is not None:
        from ... import comm

        path = os.path.join(ckpt_dir, "comm_state",
                            f"rank{comm.get_rank() if engine.distributed else 0}.pt")
        side = torch.load(path, map_location=engine.device, weights_only=False)
        engine._comm_error = side["comm_error"]
        if "masters" in side:
            key = ("master_params" if engine.state.master_params is not None
                   else "params")
            engine.state = dataclasses.replace(engine.state, **{key: side["masters"]})
            if key == "master_params":
                from ..engine import _cast_tree

                engine.state = dataclasses.replace(engine.state, params=_cast_tree(
                    side["masters"], engine.compute_dtype))


def _ckpt_group(engine):
    """The gloo group DCP plans over (None for a one-device engine)."""
    if engine.partition is None and not engine.distributed:
        return None
    if getattr(engine, "_ckpt_pg", None) is None:
        import torch.distributed as dist

        engine._ckpt_pg = dist.new_group(backend="gloo")
    return engine._ckpt_pg


def _rank0(engine) -> bool:
    import torch.distributed as dist

    return not engine.distributed or dist.get_rank() == 0


def _barrier(group) -> None:
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)


def tree_summary(flat: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    return {k: {"shape": list(v.shape), "dtype": str(v.dtype).replace("torch.", "")}
            for k, v in flat.items()}


def _meta(engine, client_state) -> Dict[str, Any]:
    """``client_state.json``: the JAX package's keys, the curriculum's
    sampler (``data_sampler``) or scheduler (``curriculum``) state among
    them."""
    meta = {"checkpoint_version": CHECKPOINT_VERSION,
            "global_steps": engine.global_steps,
            "skipped_steps": engine.skipped_steps,
            "micro_steps": engine.micro_steps,
            "param_count": engine.param_count,
            "zero_stage": engine.zero_stage,
            "mesh_shape": ({"data": engine.dp_world} if engine.mesh is None else
                           dict(zip(engine.mesh.mesh_dim_names, engine.mesh.shape))),
            "client_state": client_state or {}}
    sampler = getattr(getattr(engine, "training_dataloader", None), "data_sampler", None)
    if sampler is not None and hasattr(sampler, "state_dict"):
        meta["data_sampler"] = _json_ready(sampler.state_dict())
    elif getattr(engine, "curriculum_scheduler", None) is not None:
        meta["curriculum"] = _json_ready(engine.curriculum_scheduler.get_state())
    return meta


def _json_ready(obj):
    """numpy scalars and arrays as JSON numbers and lists."""
    if isinstance(obj, dict):
        return {k: _json_ready(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_ready(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _publish_latest(save_dir: str, tag: str) -> None:
    tmp = os.path.join(save_dir, LATEST_FILE + ".tmp")
    with open(tmp, "w") as f:
        f.write(str(tag))
    os.replace(tmp, os.path.join(save_dir, LATEST_FILE))


def _check_no_open_window(engine, what: str) -> None:
    if engine._accum_count or engine._pending_loss is not None:
        raise RuntimeError(f"{what} inside an open forward/backward window "
                           "(banked gradients are not saved): call step() first")


def save_engine_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                           client_state: Optional[Dict] = None,
                           save_latest: bool = True) -> str:
    """Write ``save_dir/<tag>``: the torn-save marker, the state, the
    sidecars, then the manifest (the commit) and ``latest``.  With
    ``checkpoint.async_save`` the state is snapshotted to host memory and the
    rest runs on a background thread (``async_engine``)."""
    from .async_engine import (AsyncCheckpointEngine, commit_in_background,
                               wait_for_pending_checkpoint)

    _check_no_open_window(engine, "save_checkpoint()")
    tag = str(tag or f"global_step{engine.global_steps}")
    ckpt_dir = os.path.join(save_dir, tag)
    maybe_fire(SITE_CKPT_SAVE, path=ckpt_dir, tag=tag)
    async_save = engine.config.checkpoint_config.async_save
    # one save in flight: the previous must be durable before this one
    # reuses its host buffers or moves `latest` after it
    wait_for_pending_checkpoint(engine)
    group = _ckpt_group(engine)
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = engine_state_dict(engine)
    manifest = build_manifest(tag, engine.global_steps,
                              tree_summary(as_dtensors(engine, flat)),
                              world_size=engine.dp_world * max(engine.tp, 1))
    if _rank0(engine):
        mark_incomplete(ckpt_dir)
        with open(os.path.join(ckpt_dir, "client_state.json"), "w") as f:
            json.dump(_meta(engine, client_state), f, indent=2)
        with open(os.path.join(ckpt_dir, "ds_config.json"), "w") as f:
            json.dump(engine.config.to_dict(), f, indent=2, default=str)
    state_path = os.path.join(ckpt_dir, STATE_DIR)
    _save_side_state(engine, ckpt_dir)
    if async_save:
        if engine._async_ckpt_engine is None:
            engine._async_ckpt_engine = AsyncCheckpointEngine(process_group=group)
        engine._async_ckpt_engine.save(flat, state_path)
        if engine.partition is not None:
            engine._async_ckpt_engine.wrap(
                lambda snap: as_dtensors(engine, snap, "cpu"))
        del flat
        commit_in_background(engine, save_dir, ckpt_dir, tag, save_latest, manifest)
        log_dist(f"async checkpoint {tag} snapshotted; committing in "
                 f"background -> {ckpt_dir}", ranks=[0])
        return ckpt_dir
    DCPCheckpointEngine(process_group=group).save(as_dtensors(engine, flat), state_path)
    del flat
    commit_tag(engine, group, save_dir, ckpt_dir, tag, save_latest, manifest)
    log_dist(f"saved checkpoint {tag} -> {ckpt_dir}", ranks=[0])
    return ckpt_dir


def commit_tag(engine, group, save_dir: str, ckpt_dir: str, tag: str,
               save_latest: bool, manifest: Dict) -> None:
    """After every rank's shards are written: rank 0 writes the manifest
    (the commit), then ``latest``; a crash between any two writes leaves an
    uncommitted tag or a committed one `latest` does not name, never a
    published torn tag.  Every rank returns once ``latest`` moved."""
    _barrier(group)
    if _rank0(engine):
        write_manifest(ckpt_dir, manifest)
        if save_latest:
            maybe_fire(SITE_LATEST_PUBLISH, path=save_dir, tag=tag)
            _publish_latest(save_dir, tag)
    _barrier(group)


def load_engine_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                           load_optimizer_states: bool = True,
                           load_module_only: bool = False):
    """Restore ``load_dir/<tag>`` (default: ``latest``) into ``engine`` in
    place, after verifying the tag (``resilience.verify_on_load``) and
    before touching any state.  ``load_module_only`` keeps this engine's
    optimizer state, step, scaler and generator; ``load_optimizer_states=
    False`` keeps its optimizer state.  Returns ``(tag_dir, client_state)``,
    ``(None, {})`` without a ``latest``."""
    from .async_engine import wait_for_pending_checkpoint

    wait_for_pending_checkpoint(engine)   # never read through an in-flight save
    _check_no_open_window(engine, "load_checkpoint()")
    tag = tag or read_latest(load_dir)
    if tag is None:
        logger.warning(f"no `latest` file in {load_dir}; nothing loaded")
        return None, {}
    ckpt_dir = os.path.join(load_dir, str(tag))
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"checkpoint tag dir not found: {ckpt_dir}")
    maybe_fire(SITE_CKPT_LOAD, path=ckpt_dir, tag=str(tag))
    group = _ckpt_group(engine)
    if _offload_of(engine) is not None and (load_module_only or not load_optimizer_states):
        # the card's params derive from the host masters every step: a
        # weights-only load would be overwritten by the next step
        raise NotImplementedError(
            "partial checkpoint loads (load_module_only / "
            "load_optimizer_states=False) are not supported with a "
            "host-stepped or param-offload optimizer: params are derived "
            "from the host fp32 masters, so a weights-only load would be "
            "discarded at the next step.  Load the full checkpoint, or "
            "export weights via checkpoint/zero_to_fp32.py.")
    if engine.config.resilience.verify_on_load:
        _verify_on_rank0(engine, ckpt_dir)
    opt = load_optimizer_states and not load_module_only
    target = as_dtensors(engine, engine_state_dict(
        engine, rest=not load_module_only, optimizer=opt))
    DCPCheckpointEngine(process_group=group).load(os.path.join(ckpt_dir, STATE_DIR),
                                                  target)
    part = engine.partition
    for key in list(target):   # uneven leaves: whole -> this rank's piece
        hit = part.leaf_for(key) if part is not None else None
        if hit is not None and target[key].dim() and part.uneven(hit[0]):
            target[key] = part.piece_of_true(hit[0], hit[1], target[key].to_local())
    state = engine.state
    if state is None:   # ZeRO-Infinity: the generator, then the files
        engine.generator.set_state(target["rng/dropout"])
        _load_side_state(engine, ckpt_dir)
        return _load_meta(engine, ckpt_dir, tag)
    kw = {"params": restore_state(state.params, "params", target),
          "master_params": restore_state(state.master_params, "master_params",
                                         target)}
    if not load_module_only:
        kw["step"] = restore_state(state.step, "step", target)
        kw["scaler"] = restore_state(state.scaler, "scaler", target)
        engine.generator.set_state(target["rng/dropout"])
        if "rng/pld" in target:
            engine.pld_generator.set_state(target["rng/pld"])
    if opt:
        kw["opt_state"] = restore_state(state.opt_state, "opt_state", target)
    engine.state = dataclasses.replace(state, **kw)
    if opt:
        _load_side_state(engine, ckpt_dir)
    return _load_meta(engine, ckpt_dir, tag)


def _load_meta(engine, ckpt_dir: str, tag):
    meta = {}
    meta_path = os.path.join(ckpt_dir, "client_state.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        engine.global_steps = meta.get("global_steps", engine.global_steps)
        engine.skipped_steps = meta.get("skipped_steps", engine.skipped_steps)
        engine.micro_steps = meta.get("micro_steps", engine.micro_steps)
        sampler = getattr(getattr(engine, "training_dataloader", None),
                          "data_sampler", None)
        if sampler is not None and meta.get("data_sampler") is not None \
                and hasattr(sampler, "load_state_dict"):
            sampler.load_state_dict(meta["data_sampler"])
        elif getattr(engine, "curriculum_scheduler", None) is not None \
                and meta.get("curriculum") is not None:
            engine.curriculum_scheduler.set_state(meta["curriculum"])
    log_dist(f"loaded checkpoint {tag} from {ckpt_dir}", ranks=[0])
    return ckpt_dir, meta.get("client_state", {})


def _verify_on_rank0(engine, ckpt_dir: str) -> None:
    """Rank 0 checks the tag against its manifest; every rank raises its
    verdict (a one-device engine checks it itself)."""
    if engine.partition is None:
        verify_checkpoint_dir(ckpt_dir)
        return
    from ... import comm

    err = None
    if _rank0(engine):
        try:
            verify_checkpoint_dir(ckpt_dir)
        except Exception as e:   # raised on every rank below
            err = e
    err = comm.broadcast_object(err)
    if err is not None:
        raise err


def save_16bit_model(engine, save_dir: str, filename: str = "pytree_model") -> str:
    """The compute-precision weights alone (reference save_16bit_model,
    engine.py:3354), as DCP files under ``save_dir/filename``."""
    os.makedirs(save_dir, exist_ok=True)
    flat: Dict[str, torch.Tensor] = {}
    flatten_state(engine.state.params, "params", flat)
    path = os.path.join(save_dir, filename)
    DCPCheckpointEngine(process_group=_ckpt_group(engine)).save(
        as_dtensors(engine, flat), path)
    return path
