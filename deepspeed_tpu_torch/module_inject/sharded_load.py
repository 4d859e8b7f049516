"""Streaming sharded-checkpoint loading (counterpart of
``deepspeed_tpu/module_inject/sharded_load.py``; reference
``deepspeed/inference/engine.py:449-516`` ``_load_checkpoint``,
``module_inject/load_checkpoint.py``, ``runtime/state_dict_factory.py``).

The reference streams a checkpoint's shard files into a live torch module
so that a 70B checkpoint never sits whole in host memory.  The port
streams at leaf granularity: each native parameter is allocated on the
target device (this rank's model-axis shard of it on a mesh, laid out as
``models.transformer.shard_params`` lays a ``CausalLM`` out: Megatron
``param_specs``, zero-padded where uneven), and filled a layer at a time
from views of the shard files.  safetensors files are read by
:class:`SafetensorsFile` (the header, then ``torch.frombuffer`` views over
a private ``mmap``), so only the bytes a leaf needs are touched, bf16 is
read as bf16, and the ``safetensors`` package is not needed.  A view is
copied to the device as it lies (a transposed ``[out, in]`` weight in one
raw copy) and transposed there.

Three source layouts are understood, as ``SDLoaderFactory.get_sd_loader_json``
(state_dict_factory.py:27) lists them:

  * an HF directory with ``model.safetensors.index.json`` (or the legacy
    ``pytorch_model.bin.index.json``) weight map;
  * an HF directory with a single ``model.safetensors`` /
    ``pytorch_model.bin`` (``.bin`` files through ``torch.load(mmap=True,
    weights_only=True)``);
  * a DeepSpeed checkpoint json ``{"type": ..., "checkpoints": [...],
    "mp_size": K}`` whose K per-rank files each hold a 1/K tensor-parallel
    slice, concatenated per tensor on the fly along the axis the arch
    policy declares (:class:`MPMergedSource`).

The config comes from the directory's ``config.json`` read as a dict
(``load.config_from_hf`` fills the HF class defaults a bare file omits).
"""
from __future__ import annotations

import dataclasses
import json
import math
import mmap
import os
import re
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..accelerator import resolve_device
from ..models.transformer import (TransformerConfig, init_params, param_specs,
                                  tp_units)
from ..parallel import tensor_parallel as _tp
from ..utils.logging import logger
from ..utils.tree import tree_map_with_path
from .load import _split_fused_qkv, as_tensor, config_from_hf
from .policies import POLICIES, ArchPolicy, _t, detect_arch

SAFE_INDEX = "model.safetensors.index.json"
BIN_INDEX = "pytorch_model.bin.index.json"
SAFE_SINGLE = "model.safetensors"
BIN_SINGLE = "pytorch_model.bin"
CONFIG_FILE = "config.json"

# safetensors dtype names -> torch dtypes
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16, "I64": torch.int64,
                      "I32": torch.int32}


# ---------------------------------------------------------------------------
# Tensor sources
# ---------------------------------------------------------------------------

class SafetensorsFile:
    """One ``.safetensors`` file: an 8-byte little-endian header length, a
    JSON header ``{name: {dtype, shape, data_offsets}}``, then the data.
    :meth:`get` returns a CPU tensor viewing the file through a private
    (copy-on-write, never written) mmap: no byte is read until used."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            size = os.fstat(f.fileno()).st_size
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self._entries: Dict[str, dict] = header
        self._data = 8 + n
        for name, e in header.items():
            begin, end = e["data_offsets"]
            if e["dtype"] not in SAFETENSORS_DTYPES:
                raise NotImplementedError(
                    f"{path}: tensor {name!r} has dtype {e['dtype']}; read: "
                    f"{sorted(SAFETENSORS_DTYPES)}")
            nbytes = math.prod(e["shape"]) * SAFETENSORS_DTYPES[e["dtype"]].itemsize
            if end - begin != nbytes or self._data + end > size:
                raise ValueError(f"{path}: tensor {name!r} spans bytes "
                                 f"[{begin}, {end}) of the data, not {nbytes}")

    def keys(self):
        return self._entries.keys()

    def get(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        dtype, shape = SAFETENSORS_DTYPES[e["dtype"]], e["shape"]
        count = math.prod(shape)
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._mm, dtype=dtype, count=count,
                                offset=self._data + e["data_offsets"][0]).view(shape)


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (CPU) as one ``.safetensors`` file, the layout
    :class:`SafetensorsFile` reads (header padded to 8 bytes with spaces,
    as the ``safetensors`` package pads it)."""
    names = {dt: name for name, dt in SAFETENSORS_DTYPES.items()}
    header: Dict[str, Any] = {}
    offset = 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                        .numpy().data)


class ShardedTensorSource:
    """Lazy per-tensor reads over one set of shard files (one mp rank).
    ``prefixes``: export prefixes the policy's names omit (BERT's
    ``bert.``), tried when a name is not found as is."""

    def __init__(self, files: List[str], prefixes: Tuple[str, ...] = (),
                 weight_map: Optional[Dict[str, str]] = None):
        self._prefixes = prefixes
        self._files: Dict[str, Any] = {}
        self._index: Dict[str, str] = {}        # tensor name -> file
        if weight_map is not None:
            self._index = dict(weight_map)
        else:
            for f in files:
                for name in self._open(f).keys():
                    self._index.setdefault(name, f)

    @classmethod
    def from_weight_map(cls, base_dir: str, weight_map: Dict[str, str],
                        prefixes: Tuple[str, ...] = ()) -> "ShardedTensorSource":
        return cls([], prefixes, {name: os.path.join(base_dir, f)
                                  for name, f in weight_map.items()})

    def _open(self, path: str):
        h = self._files.get(path)
        if h is None:
            if path.endswith(".safetensors"):
                h = SafetensorsFile(path)
            else:   # torch .bin/.pt: mmap-backed, read per tensor on use
                sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
                h = sd.get("module", sd.get("model", sd)) if isinstance(sd, dict) else sd
            self._files[path] = h
        return h

    def keys(self):
        return self._index.keys()

    def resolve(self, name: str) -> Optional[str]:
        if name in self._index:
            return name
        for p in self._prefixes:
            if p + name in self._index:
                return p + name
        return None

    def has(self, name: str) -> bool:
        return self.resolve(name) is not None

    def get(self, name: str) -> torch.Tensor:
        rname = self.resolve(name)
        if rname is None:
            raise KeyError(f"checkpoint is missing tensor '{name}' "
                           f"(shards hold {len(self._index)} tensors)")
        h = self._open(self._index[rname])
        return h.get(rname) if isinstance(h, SafetensorsFile) else h[rname].detach()

    def close(self) -> None:
        # drop the maps; a view still held elsewhere keeps its mmap alive
        self._files.clear()


class StateDictSource(ShardedTensorSource):
    """An in-memory state dict (torch tensors or numpy arrays) read through
    the same interface (the dense path: a live module or ``(config,
    state_dict)``)."""

    def __init__(self, state_dict: Dict[str, Any], arch: str):
        super().__init__([], _arch_prefixes(arch), {k: "" for k in state_dict})
        self._sd = state_dict

    def get(self, name: str) -> torch.Tensor:
        rname = self.resolve(name)
        if rname is None:
            raise KeyError(f"HF checkpoint is missing '{name}' "
                           f"(have {len(self._sd)} tensors)")
        return as_tensor(self._sd[rname])


class MPMergedSource:
    """K tensor-parallel rank sources presented as one logical checkpoint:
    ``get(name)`` concatenates the K slices along the axis the arch policy
    declares (reference state_dict_factory merge, MegatronSDLoader
    :339-405).  Host peak: one whole tensor."""

    def __init__(self, rank_sources: List[ShardedTensorSource],
                 classify: Callable[[str], Tuple[str, Optional[int]]]):
        self._ranks = rank_sources
        self._classify = classify

    def keys(self):
        return self._ranks[0].keys()

    def has(self, name: str) -> bool:
        return self._ranks[0].has(name)

    def resolve(self, name: str):
        return self._ranks[0].resolve(name)

    def get(self, name: str) -> torch.Tensor:
        kind, axis = self._classify(name)
        if kind == "replicated" or len(self._ranks) == 1:
            return self._ranks[0].get(name)
        pieces = [r.get(name) for r in self._ranks]
        if kind == "split":
            return torch.cat(pieces, dim=axis)
        if kind == "qkv_cols":
            # GPT-2 fused [.., 3f]: each rank holds [q_m|k_m|v_m]; regroup
            # so that the merged tensor is [q|k|v] on the last axis
            parts = [p.chunk(3, dim=-1) for p in pieces]
            return torch.cat([torch.cat([p[j] for p in parts], -1) for j in range(3)], -1)
        raise ValueError(f"unknown placement kind {kind!r} for {name!r}")

    def close(self) -> None:
        for r in self._ranks:
            r.close()


# ---------------------------------------------------------------------------
# HF-name placement classification (shared with checkpoint/reshard.py)
# ---------------------------------------------------------------------------

def _arch_prefixes(arch: str) -> Tuple[str, ...]:
    return {"bert": ("bert.",), "distilbert": ("distilbert.",)}.get(arch, ())


def make_classifier(policy: ArchPolicy, cfg: TransformerConfig,
                    prefixes: Optional[Tuple[str, ...]] = None
                    ) -> Callable[[str], Tuple[str, Optional[int]]]:
    """name -> (kind, axis) in the HF on-disk layout: 'replicated',
    'split' (concatenated or split along ``axis``), or 'qkv_cols' (GPT-2's
    fused ``[.., 3f]``).  On-disk names may carry an export prefix the
    policy templates omit (BERT's 'bert.'), stripped before matching."""
    if prefixes is None:
        prefixes = _arch_prefixes(policy.name)
    specs = param_specs(dataclasses.replace(cfg, pipeline_stages=1))
    rules: List[Tuple[Any, str, Optional[int]]] = []

    def to_regex(tmpl: str):
        return re.compile("^" + re.escape(tmpl).replace(r"\{i\}", r"\d+")
                          .replace(r"\{e\}", r"\d+") + "$")

    def rule(tmpl, spec, tf, is_layer):
        # the 'model' axis in the per-tensor layout (a layer leaf's [L] cut)
        axis = _tp.spec_dim(tuple(spec)[is_layer:]) if spec is not None else None
        if axis is not None and tf is _t and len(tuple(spec)) - is_layer == 2:
            axis = 1 - axis
        rules.append((to_regex(tmpl), "split" if axis is not None else "replicated",
                      axis))

    for native, (hf_name, tf) in policy.top.items():
        rule(hf_name, specs.get(native), tf, False)
    for native, (tmpl, tf) in policy.layer.items():
        if tmpl is not None:     # a zero-filled slot has no on-disk tensor
            rule(tmpl, specs["layers"].get(native), tf, True)
    if policy.moe_router is not None:   # JAX :258-260
        rules.append((to_regex(policy.moe_router[0]), "replicated", None))
        for native, (etmpl, etf) in (policy.moe_experts or {}).items():
            spec = specs["layers"].get(native)
            # a per-expert tensor on disk: the [L] and [E] dims dropped
            rule(etmpl, None if spec is None else tuple(spec)[1:], etf, True)
    if policy.fused_qkv is not None:
        if policy.name in ("gpt_neox", "bloom", "megatron_gpt", "megatron_gpt_moe"):
            # per-head fused [H*3*hd, d]: heads are outermost, a contiguous
            # axis-0 split keeps each head's q/k/v together (Megatron layout)
            kinds = [(to_regex(t), "split", 0)
                     for t in (policy.fused_qkv, policy.fused_qkv_bias) if t]
        else:
            # GPT-2 Conv1D fused [d, 3d] = [q|k|v] columns
            kinds = [(to_regex(t), "qkv_cols", None)
                     for t in (policy.fused_qkv, policy.fused_qkv_bias) if t]
        rules = kinds + rules

    def classify(name: str) -> Tuple[str, Optional[int]]:
        for p in prefixes:
            if name.startswith(p):
                name = name[len(p):]
                break
        for rx, kind, axis in rules:
            if rx.match(name):
                return kind, axis
        return "replicated", None   # unknown buffers ride along replicated

    return classify


# ---------------------------------------------------------------------------
# Source construction
# ---------------------------------------------------------------------------

def read_hf_config(path: str) -> Dict[str, Any]:
    """The ``config.json`` beside a checkpoint (in the directory, or beside
    a checkpoint json or weights file) as a dict."""
    cfg_dir = path if os.path.isdir(path) else os.path.dirname(os.path.abspath(path))
    cpath = os.path.join(cfg_dir, CONFIG_FILE)
    if not os.path.exists(cpath):
        raise FileNotFoundError(f"no {CONFIG_FILE} in {cfg_dir!r}: pass the model "
                                "directory, or hf_config=")
    with open(cpath) as f:
        return json.load(f)


def open_checkpoint_source(path: str, policy: ArchPolicy, cfg: TransformerConfig):
    """A tensor source over an HF directory, a DeepSpeed checkpoint json or
    a single weights file."""
    prefixes = _arch_prefixes(policy.name)
    if os.path.isdir(path):
        for index in (SAFE_INDEX, BIN_INDEX):
            ipath = os.path.join(path, index)
            if os.path.exists(ipath):
                with open(ipath) as f:
                    weight_map = json.load(f)["weight_map"]
                return ShardedTensorSource.from_weight_map(path, weight_map, prefixes)
        for single in (SAFE_SINGLE, BIN_SINGLE):
            spath = os.path.join(path, single)
            if os.path.exists(spath):
                return ShardedTensorSource([spath], prefixes)
        raise FileNotFoundError(
            f"no recognized weight files in {path!r} (looked for "
            f"{SAFE_INDEX}, {BIN_INDEX}, {SAFE_SINGLE}, {BIN_SINGLE})")
    if path.endswith(".json"):       # DeepSpeed checkpoint json
        with open(path) as f:
            meta = json.load(f)
        base = meta.get("base_dir") or os.path.dirname(os.path.abspath(path))
        files = [f if os.path.isabs(f) else os.path.join(base, f)
                 for f in meta["checkpoints"]]
        mp = int(meta.get("mp_size") or meta.get("tp_size") or len(files))
        if mp <= 1 or len(files) == 1:
            return ShardedTensorSource(files, prefixes)
        if len(files) != mp:
            raise ValueError(f"checkpoint json lists {len(files)} files for mp_size={mp}")
        ranks = [ShardedTensorSource([f], prefixes) for f in files]
        return MPMergedSource(ranks, make_classifier(policy, cfg))
    if os.path.exists(path):         # a single weights file
        return ShardedTensorSource([path], prefixes)
    raise FileNotFoundError(path)


# ---------------------------------------------------------------------------
# Leaf fetches: native tree path -> a fetch of one layer's tensor
# ---------------------------------------------------------------------------

_ATTN_BIAS = ("bq", "bk", "bv", "bo")
_MLP_BIAS = ("b_in", "b_gate", "b_up", "b_down")


def _leaf_builders(policy: ArchPolicy, cfg: TransformerConfig, arch: str,
                   source) -> Dict[str, Optional[Callable]]:
    """``{path: fetch}``: ``fetch(i)`` is layer ``i``'s tensor of a stacked
    leaf, ``fetch(None)`` a top-level leaf, in the native layout (a view of
    the source where the policy's transform allows); ``None`` marks a
    zero-filled leaf."""
    fetches: Dict[str, Optional[Callable]] = {}

    def top(hf_name, tf, offset):
        def fetch(_):
            t = source.get(hf_name)
            t = tf(t) if tf is not None else t
            return t[offset:] if offset else t
        return fetch

    for native, (hf_name, tf) in policy.top.items():
        if native == "lm_head" and cfg.tie_embeddings:
            continue   # HF omits the tied weight: never fetch it
        if native == "lm_head_bias" and not source.has(hf_name):
            fetches[native] = None   # optional in some exports
            continue
        off = policy.pos_embed_offset if native == "pos_embed" else 0
        fetches[native] = top(hf_name, tf, off)

    def layer(tmpl, tf):
        def fetch(i):
            t = source.get(tmpl.format(i=i))
            return tf(t) if tf is not None else t
        return fetch

    for native, (tmpl, tf) in policy.layer.items():
        if native in _ATTN_BIAS and not cfg.attn_bias:
            continue   # e.g. NeoX attention_bias=False exports omit them
        if native in _MLP_BIAS and not cfg.mlp_bias:
            continue
        fetches["layers/" + native] = None if tmpl is None else layer(tmpl, tf)

    if policy.fused_qkv is not None:
        for tmpl, names in ((policy.fused_qkv, ("wq", "wk", "wv")),
                            (policy.fused_qkv_bias, ("bq", "bk", "bv"))):
            if tmpl is None or (names[0] == "bq" and not cfg.attn_bias):
                continue
            for j, native in enumerate(names):
                def fetch(i, _tmpl=tmpl, _j=j):
                    return _split_fused_qkv(source.get(_tmpl.format(i=i)), cfg, arch)[_j]
                fetches["layers/" + native] = fetch

    if policy.moe_router is not None:   # Megatron-DeepSpeed MoE (JAX :425-435)
        E = int(cfg.num_experts)
        fetches["layers/router"] = layer(*policy.moe_router)
        for native, (etmpl, etf) in (policy.moe_experts or {}).items():
            if native in _MLP_BIAS and not cfg.mlp_bias:
                continue

            def fetch_experts(i, _t=etmpl, _f=etf):   # [E, ...] of layer i
                return torch.stack([_f(source.get(_t.format(i=i, e=e))) if _f is not None
                                    else source.get(_t.format(i=i, e=e))
                                    for e in range(E)])
            fetches["layers/" + native] = fetch_experts
    return fetches


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, a CPU view moved to ``dst``'s device as it lies
    first: a dense view (a transposed weight) travels in one raw copy and
    is transposed and cast on the device."""
    if src.device != dst.device:
        src = src.to(dst.device)
    dst.copy_(src)


def build_params(source, policy: ArchPolicy, cfg: TransformerConfig, arch: str,
                 dtype: Optional[torch.dtype] = None, device=None,
                 shard: Tuple[int, int] = (0, 1)) -> Dict[str, Any]:
    """The parameter tree of ``cfg`` (``init_params``' keys and shapes) in
    ``dtype`` (float32 when None) on ``device``, or model-axis shard
    ``shard = (index, n)`` of it: each leaf allocated once (zeros: a
    zero-filled slot and the padding of an uneven shard stay 0) and filled
    a layer at a time with the slice of the source it needs."""
    dtype = dtype or torch.float32
    device = resolve_device(device)
    index, n = shard
    # shapes only
    shapes = init_params(cfg, torch.Generator(), device="meta")
    specs, units = _tp.spec_paths(param_specs(cfg)), _tp.spec_paths(tp_units(cfg))
    fetches = _leaf_builders(policy, cfg, arch, source)

    def build(path, meta):
        if path not in fetches:
            raise KeyError(f"no checkpoint mapping for native param {path} "
                           f"(policy={policy.name})")
        out = torch.zeros(_tp.local_shape(meta.shape, specs[path], n, units[path]),
                          dtype=dtype, device=device)
        d = _tp.spec_dim(specs[path]) if n > 1 else None
        lo = live = 0
        if d is not None:   # this rank's rows of the whole leaf, pads cut
            lo = index * out.shape[d]
            live = max(0, min(out.shape[d], meta.shape[d] - lo))
        fetch = fetches[path]
        if fetch is not None and (d is None or live):
            stacked = path.startswith("layers/")
            for i in (range(cfg.num_layers) if stacked else (None,)):
                src, dst = fetch(i), out[i] if stacked else out
                if d is not None:
                    src = src.narrow(d - stacked, lo, live)
                    dst = dst.narrow(d - stacked, 0, live)
                _copy(dst, src)
        return out

    return tree_map_with_path(build, shapes)


def _model_axis(mesh) -> Tuple[int, int]:
    """(this rank's index, size) of ``mesh``'s model axis."""
    from .. import comm
    from ..parallel.mesh import MeshLayout, layout_of

    n = (mesh if isinstance(mesh, MeshLayout) else layout_of(mesh)).tp
    return (comm.axis_index("model") if n > 1 else 0), n


# ---------------------------------------------------------------------------
# The streaming loader
# ---------------------------------------------------------------------------

def load_hf_checkpoint_sharded(path: str, dtype: Optional[torch.dtype] = None,
                               max_seq_len: Optional[int] = None, mesh=None,
                               hf_config: Any = None, device=None,
                               ) -> Tuple[TransformerConfig, Dict[str, Any]]:
    """``(cfg, params)`` streamed leaf by leaf from an HF directory, a
    DeepSpeed checkpoint json or a weights file, onto ``device`` (the
    accelerator's when None).  ``hf_config`` (an HF config object or dict)
    overrides the ``config.json`` beside ``path``.

    ``mesh`` (installed, with a model axis of n > 1): each rank builds only
    its own shard of each leaf, the one ``CausalLM.shard_params`` cuts, and
    reads only the slices of the checkpoint that shard needs, so the tree
    equals the one ``init_inference(CausalLM(cfg), params=<whole tree>,
    mesh=mesh)`` places.  Host memory holds no leaf: views of the files go
    to the device a layer at a time."""
    if hf_config is None:
        hf_config = read_hf_config(path)
    arch = detect_arch(hf_config)
    policy = POLICIES[arch]
    cfg = config_from_hf(hf_config)
    if max_seq_len is not None:
        cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
    shard = _model_axis(mesh) if mesh is not None else (0, 1)
    source = open_checkpoint_source(path, policy, cfg)
    try:
        params = build_params(source, policy, cfg, arch, dtype, device, shard)
    finally:
        source.close()
    logger.info(f"streamed HF {arch} checkpoint: {cfg.param_count:,} params "
                f"(model-axis shard {shard[0]} of {shard[1]}), "
                f"L={cfg.num_layers} d={cfg.hidden_size}")
    return cfg, params
