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

Hugging Face directories and DeepSpeed inference-checkpoint json files,
which the JAX tool also reads, load through ``module_inject``, which is not
ported yet (ROADMAP queue 1, item 6): such a source raises
``NotImplementedError``.

CLI::

    python -m deepspeed_tpu_torch.checkpoint.reshard <ckpt_dir> <out_dir> \\
        --target_mp N --model llama2-7b [--tag TAG] [--dtype bfloat16]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

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


def reshard_checkpoint(checkpoint_dir: str, target_mp: int, out_dir: str, model,
                       tag: Optional[str] = None, dtype: Optional[str] = None) -> str:
    """Write ``target_mp`` shard files of the weights of the checkpoint
    ``checkpoint_dir`` (a tag, default ``latest``) under ``out_dir``;
    ``model`` is a ``models.CausalLM`` or its config name (its
    ``param_specs`` give each leaf's split).  Returns the path of the
    written ``ds_inference_config.json``."""
    if os.path.isfile(checkpoint_dir) or os.path.exists(
            os.path.join(checkpoint_dir, "config.json")):
        raise NotImplementedError(
            f"{checkpoint_dir}: Hugging Face directories and DeepSpeed "
            "inference-checkpoint json files load through module_inject, which "
            "is not ported yet (ROADMAP queue 1, item 6)")
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
    ap.add_argument("--model", required=True, help="the CausalLM config name")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16", "float16"])
    args = ap.parse_args(argv)
    print(reshard_checkpoint(args.checkpoint_dir, args.target_mp, args.out_dir,
                             args.model, tag=args.tag, dtype=args.dtype))


if __name__ == "__main__":
    main()
