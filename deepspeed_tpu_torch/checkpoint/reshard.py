"""Offline model-parallel resharding of the port's checkpoints (counterpart
of ``deepspeed_tpu/checkpoint/reshard.py``; reference
``deepspeed/runtime/state_dict_factory.py``).

The live path needs no tool: a checkpoint saved at one (tp, dp, ZeRO)
layout loads at any other, because DCP reads chunks by their global
offsets (``runtime/checkpoint_engine/dcp_engine.py``), and
``init_inference(mesh=...)`` cuts a whole tree to each rank's shards.  This
tool is the offline half: rewrite a training checkpoint of the port as
``target_mp`` per-rank shard files of its fp32 weights, each the model-axis
shard ``param_specs`` gives that rank, so a serving fleet loads rank-local
files (:func:`load_mp_shard`) without reading the whole model on every
rank.  A file holds the rank's true rows only (an uneven shard's padding
is added back when it is loaded).  One output rank's tensors are built at a time (peak host memory:
the consolidated weights plus one rank's shard).

A Hugging Face directory or a DeepSpeed inference-checkpoint json (any
source mp degree) takes :func:`reshard_inference_checkpoint`, the JAX
tool's: ``target_mp`` per-rank safetensors files under the checkpoint's own
tensor names, each tensor split along the axis the arch policy's
``param_specs`` give it in the HF layout
(``module_inject.sharded_load.make_classifier``), fused QKV regrouped per
rank as the reference's ``qkv_copy``/``qkv_split`` do
(state_dict_factory.py:339), and a ``ds_inference_config.json`` that
``init_inference(<model dir>, config={"checkpoint": ...})`` loads.  One
output rank's tensors are in memory at a time.

CLI::

    python -m deepspeed_tpu_torch.checkpoint.reshard <ckpt_dir> <out_dir> \\
        --target_mp N --model llama2-7b [--tag TAG] [--dtype bfloat16]
    python -m deepspeed_tpu_torch.checkpoint.reshard <hf_dir or ckpt json> \\
        <out_dir> --target_mp N [--model_dir DIR] [--dtype bfloat16]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

import torch

from ..parallel.tensor_parallel import pad_to, shard_leaf, spec_dim, spec_paths, true_piece
from ..utils.logging import logger
from ..utils.tree import tree_map_with_path
from .zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

META_FILE = "ds_inference_config.json"


def _shard_file(m: int) -> str:
    return f"mp_rank_{m:02d}_model_states.pt"


def _model(model):
    from ..models import CausalLM

    return model if hasattr(model, "param_specs") else CausalLM(model)


def _split_tensor(t: torch.Tensor, kind: str, axis: Optional[int], target_mp: int,
                  name: str) -> List[torch.Tensor]:
    """The ``target_mp`` per-rank pieces of one HF tensor."""
    if kind == "replicated" or target_mp == 1:
        return [t] * target_mp
    if kind == "split":
        if t.shape[axis] % target_mp:
            raise ValueError(f"{name}: dim {axis} size {t.shape[axis]} does not "
                             f"divide by target mp_size {target_mp}")
        return list(t.chunk(target_mp, dim=axis))
    if kind == "qkv_cols":
        parts = t.chunk(3, dim=-1)
        for part in parts:
            if part.shape[-1] % target_mp:
                raise ValueError(f"{name}: fused qkv part dim {part.shape[-1]} does "
                                 f"not divide by target mp_size {target_mp}")
        cut = [p.chunk(target_mp, dim=-1) for p in parts]
        return [torch.cat([c[m] for c in cut], -1) for m in range(target_mp)]
    raise ValueError(f"unknown placement kind {kind!r} for {name!r}")


def reshard_inference_checkpoint(src: str, target_mp: int, out_dir: str,
                                 model_dir: Optional[str] = None,
                                 dtype: Optional[str] = None) -> str:
    """Rewrite ``src`` (an HF directory or a DeepSpeed checkpoint json, any
    source mp degree) as ``target_mp`` per-rank safetensors files under
    ``out_dir`` (the JAX package's tool); ``model_dir`` holds the
    ``config.json`` when ``src`` lies elsewhere.  Returns the path of the
    written checkpoint json."""
    from ..module_inject.load import config_from_hf
    from ..module_inject.policies import POLICIES, detect_arch
    from ..module_inject.sharded_load import (make_classifier, open_checkpoint_source,
                                              read_hf_config, save_safetensors)

    hf_config = read_hf_config(model_dir or src)
    arch = detect_arch(hf_config)
    policy = POLICIES[arch]
    cfg = config_from_hf(hf_config)
    classify = make_classifier(policy, cfg)
    source = open_checkpoint_source(src, policy, cfg)
    cast = getattr(torch, dtype) if dtype else None
    os.makedirs(out_dir, exist_ok=True)
    files = []
    try:
        for m in range(target_mp):
            shard: Dict[str, torch.Tensor] = {}
            for name in sorted(source.keys()):
                t = source.get(name)
                if cast is not None and t.is_floating_point():
                    t = t.to(cast)
                shard[name] = _split_tensor(t, *classify(name), target_mp, name)[m]
            files.append(f"mp_rank_{m:02d}_model_states.safetensors")
            save_safetensors(shard, os.path.join(out_dir, files[-1]))
            mb = sum(v.numel() * v.element_size() for v in shard.values()) / 1e6
            logger.info(f"reshard: wrote {files[-1]} ({mb:.1f} MB)")
    finally:
        source.close()
    meta = {"type": arch, "version": 1.0, "mp_size": target_mp,
            "parallelization": "tp", "checkpoints": files}
    path = os.path.join(out_dir, META_FILE)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return path


def _is_inference_source(path: str) -> bool:
    return os.path.isfile(path) or os.path.exists(os.path.join(path, "config.json"))


def reshard_checkpoint(checkpoint_dir: str, target_mp: int, out_dir: str, model=None,
                       tag: Optional[str] = None, dtype: Optional[str] = None) -> str:
    """Write ``target_mp`` shard files of the weights of the checkpoint
    ``checkpoint_dir`` (a tag, default ``latest``) under ``out_dir``;
    ``model`` is a ``models.CausalLM`` or its config name (its
    ``param_specs`` give each leaf's split).  Returns the path of the
    written ``ds_inference_config.json``.  An HF directory or a DeepSpeed
    checkpoint json goes to :func:`reshard_inference_checkpoint`."""
    if _is_inference_source(checkpoint_dir):
        return reshard_inference_checkpoint(checkpoint_dir, target_mp, out_dir,
                                            dtype=dtype)
    if model is None:
        raise ValueError(f"{checkpoint_dir}: resharding a training checkpoint "
                         "needs model= (the CausalLM or its config name)")
    model = _model(model)
    from ..models.transformer import tp_units

    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    specs = spec_paths(model.param_specs)
    units = spec_paths(tp_units(model.config))
    missing = sorted(set(specs) - set(sd))
    if missing:
        raise ValueError(f"the checkpoint has no weights for {missing[:5]}: is it "
                         f"a checkpoint of {model.config}?")
    cast = getattr(torch, dtype) if dtype else None
    os.makedirs(out_dir, exist_ok=True)
    files = []
    for m in range(target_mp):
        shard: Dict[str, torch.Tensor] = {}
        for name in sorted(specs):
            t, d = sd[name], spec_dim(specs[name])
            if d is not None:   # the rank's shard, without the padding of
                # an uneven one (load_mp_shard pads it back)
                extent = t.shape[d]
                t = true_piece(shard_leaf(t, specs[name], m, target_mp, units[name]),
                               specs[name], m, target_mp, extent)
            shard[name] = (t.to(cast) if cast is not None else t).contiguous()
        torch.save(shard, os.path.join(out_dir, _shard_file(m)))
        files.append(_shard_file(m))
        logger.info(f"reshard: wrote {files[-1]} "
                    f"({sum(v.numel() * v.element_size() for v in shard.values()) / 1e6:.1f} MB)")
    meta = {"type": "causal_lm", "version": 1.0, "mp_size": target_mp,
            "parallelization": "tp", "checkpoints": files}
    path = os.path.join(out_dir, META_FILE)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_mp_shard(out_dir: str, rank: int, model, device=None) -> Dict[str, Any]:
    """Rank ``rank``'s parameter tree from a :func:`reshard_checkpoint`
    directory, on ``device`` (the host by default), for
    ``init_inference(params=..., mesh=...)``."""
    with open(os.path.join(out_dir, META_FILE)) as f:
        meta = json.load(f)
    n = int(meta["mp_size"])
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} out of range for mp_size {n}")
    flat = torch.load(os.path.join(out_dir, meta["checkpoints"][rank]),
                      map_location="cpu", weights_only=True)
    m = _model(model)
    template = m.shard_params(m.init_fn(torch.Generator(), device="meta"), rank, n)
    specs = spec_paths(m.param_specs)

    def fill(path, leaf):
        if path not in flat:
            raise KeyError(f"shard file has no tensor for param '{path}'")
        t, d = flat[path], spec_dim(specs[path])
        if d is not None and t.shape[d] < leaf.shape[d]:   # an uneven shard
            t = pad_to(t, d, leaf.shape[d])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for '{path}': file "
                             f"{tuple(flat[path].shape)} vs rank {rank}'s shard "
                             f"{tuple(leaf.shape)}")
        return t if device is None else t.to(device)

    return tree_map_with_path(fill, template)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Reshard a deepspeed_tpu_torch checkpoint across "
                    "model-parallel degrees (reference runtime/state_dict_factory.py)")
    ap.add_argument("checkpoint_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--target_mp", type=int, required=True)
    ap.add_argument("--model", default=None,
                    help="the CausalLM config name (a training checkpoint)")
    ap.add_argument("--model_dir", default=None,
                    help="directory holding config.json when the source is a "
                         "checkpoint json outside the model directory")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16", "float16"])
    args = ap.parse_args(argv)
    if _is_inference_source(args.checkpoint_dir):
        print(reshard_inference_checkpoint(args.checkpoint_dir, args.target_mp,
                                           args.out_dir, model_dir=args.model_dir,
                                           dtype=args.dtype))
    else:
        print(reshard_checkpoint(args.checkpoint_dir, args.target_mp, args.out_dir,
                                 args.model, tag=args.tag, dtype=args.dtype))


if __name__ == "__main__":
    main()
